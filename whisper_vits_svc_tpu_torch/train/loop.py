"""The training loop (JAX whisper_vits_svc_tpu/train/loop.py; reference
vits_extend/train.py:62-311), on one device or data-parallel.

Per epoch: the exponential LR decay, validation at `eval_interval`, the
epoch's bucketed batches through a prefetch thread into the GAN step, the
writer's records at `info_interval`, a checkpoint at `save_interval`. A
warm start takes the `train.pretrain` weights (a reference `.pth` or any
checkpoint the port reads); `chkpt_path` resumes models, optimizers and
counters. The NaN guard checks the health metrics wherever they reach the
host (every `info_interval` and before each save): it halts with
`TrainDivergence`, writing no checkpoint past the divergence, or, with
`nan_autoresume`, restarts from the newest checkpoint with the learning
rate scaled by `nan_lr_factor`, at most `nan_max_restarts` times.

Random draws come from one torch.Generator on the device seeded from
`train.seed` (re-seeded on each auto-resume), validation's from one seeded
generator per utterance; the batcher draws from numpy as the JAX package
does. The JAX package's compile cache has no counterpart here.

Data parallelism (`hp.dist`: coordinator_address, num_processes,
process_id; parallel/ddp.py) in place of the JAX package's mesh: the process
group is set up first, rank r trains on cuda:r (the CPU under gloo) on
rank::num_replicas of every bucket, and every rank takes the global batch's
step. Only rank 0 validates, writes the logs and saves checkpoints; the
ranks meet after each save, so that a NaN auto-resume on any rank reloads
the checkpoint rank 0 wrote. Without a coordinator address the loop runs
one process and no collective, as before.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data.dataset import BucketBatcher, SvcDataset, boundaries_for
from ..data.prefetch import prefetch
from ..ops.stft import linear_spectrogram
from ..parallel import ddp
from ..utils.config import Config
from ..utils.profiling import start_trace, stop_trace
from . import checkpoint as ckpt
from .losses import mel_l1_loss
from .step import init_train_states, make_train_step, set_learning_rate
from .writer import TrainWriter

HEALTH_KEYS = ("loss_g", "loss_d", "grad_norm_g", "grad_norm_d")
PROFILE_FILE = "train_steps.json"  # the Chrome trace under profile_dir


class TrainDivergence(RuntimeError):
    """Raised by the NaN guard when the metrics go non-finite and auto-resume
    is off or spent. Carries the last step whose metrics were verified
    finite: the checkpoints up to it can be trusted."""

    def __init__(self, step: int, last_healthy_step: int, detail: str):
        super().__init__(
            f"non-finite training metrics at step {step} ({detail}); "
            f"last step verified healthy: {last_healthy_step}. No checkpoint "
            f"was written past the divergence.")
        self.step = step
        self.last_healthy_step = last_healthy_step


class _Diverged(Exception):
    """Non-finite metrics were seen (detail in args[0])."""


def _check_finite(metrics: dict, guard: bool) -> None:
    """Raises _Diverged if a health metric is non-finite. Called where the
    metrics reach the host anyway, so it adds no device synchronisation."""
    if not guard:
        return
    bad = [k for k in HEALTH_KEYS if k in metrics and not np.isfinite(float(metrics[k]))]
    if bad:
        raise _Diverged(", ".join(f"{k}={float(metrics[k])}" for k in bad))


def reseed(seed: int, salt: int) -> int:
    """A generator seed from (seed, salt), the counterpart of JAX's
    fold_in(PRNGKey(seed), salt)."""
    return int(np.random.SeedSequence([seed, salt]).generate_state(1, np.uint64)[0])


def train(hp: Config, name: str, chkpt_path: str | None = None,
          max_epochs: int | None = None, max_steps: int | None = None,
          profile_dir: str | None = None, profile_steps: int = 10,
          device: str | torch.device | None = "cuda"):
    """Train `name` on hp.data.training_files; returns (g_state, d_state,
    step). Runs on the card unless device="cpu". profile_dir: a
    torch.profiler Chrome trace of steps 3 .. 2 + profile_steps (rank 0)."""
    dist_cfg = hp.get("dist") or {}
    dev = ddp.initialize_distributed(dist_cfg.get("coordinator_address"),
                                     dist_cfg.get("num_processes", 1),
                                     dist_cfg.get("process_id", 0), device)
    primary = ddp.is_primary()
    seed = hp.train.seed
    g_state, d_state = init_train_states(hp, seed=seed, device=dev)
    train_step = make_train_step(hp, g_state, d_state)
    generator = torch.Generator(device=dev).manual_seed(seed)

    init_epoch, step = 1, 0
    pretrain = hp.train.get("pretrain", "")
    if pretrain and os.path.isfile(pretrain):
        payload = (ckpt.load_torch_pretrain(pretrain) if pretrain.endswith((".pth", ".pt"))
                   else ckpt.load(pretrain))
        ckpt.warm_start(g_state, d_state, payload)
        print(f"Start from pretrain model: {pretrain}")
    if chkpt_path is not None:
        payload = ckpt.load(chkpt_path)
        _, _, step, init_epoch = ckpt.restore_states(g_state, d_state, payload)
        if payload.get("hp_str") and payload["hp_str"] != hp.get("raw", ""):
            print("WARNING: new hparams differ from checkpoint; using new.")
        print(f"Resumed from {chkpt_path} at epoch {init_epoch}, step {step}")

    dataset = SvcDataset(hp.data.training_files, hp.data)
    batcher = BucketBatcher(dataset, hp.train.batch_size, boundaries=boundaries_for(hp.data),
                            num_replicas=ddp.world_size(), rank=ddp.rank(), seed=seed)
    val_ds = SvcDataset(hp.data.validation_files, hp.data)

    pth_dir = os.path.join(hp.log.pth_dir, name)
    writer = None
    if primary:
        os.makedirs(pth_dir, exist_ok=True)
        writer = TrainWriter(os.path.join(hp.log.log_dir, name), hp.data.sampling_rate)

    end_epoch = max_epochs or hp.train.epochs
    lr0, gamma = hp.train.learning_rate, hp.train.lr_decay
    sr, hop = hp.data.sampling_rate, hp.data.hop_length

    guard = bool(hp.train.get("nan_guard", True))
    autoresume = bool(hp.train.get("nan_autoresume", False))
    nan_lr_factor = float(hp.train.get("nan_lr_factor", 0.5))
    restarts_left = int(hp.train.get("nan_max_restarts", 2))
    lr_scale = 1.0
    last_healthy_step = step
    profiler = None
    # the writer's rates: steps and samples since its last record over the
    # time spent in the epochs' batch loops (validation and saves left out)
    rate_steps, rate_samples, rate_s = 0, 0, 0.0

    epoch = init_epoch
    try:
        while epoch <= end_epoch:
            try:
                lr = lr0 * lr_scale * gamma ** (epoch - 1)
                set_learning_rate(g_state, lr)
                set_learning_rate(d_state, lr / hp.train.accum_step)

                if primary and epoch % hp.log.eval_interval == 0 and len(val_ds):
                    mel = validate(hp, g_state.model, val_ds, writer, step)
                    print(f"epoch {epoch} | validation mel {mel:.4f} | step {step}")

                t_last = time.perf_counter()
                metrics = None
                for batch in prefetch(batcher.epoch_batches(epoch), depth=2):
                    if primary and profile_dir is not None and step == 2:
                        profiler = start_trace(cuda=dev.type == "cuda")
                    real_samples = int(batch["spec_l"].sum()) * hop
                    metrics = train_step(batch, generator)
                    step += 1
                    if profiler is not None and step == 2 + profile_steps:
                        stop_trace(profiler, os.path.join(profile_dir, PROFILE_FILE), dev)
                        profiler, profile_dir = None, None
                    rate_steps += 1
                    rate_samples += real_samples
                    if step % hp.log.info_interval == 0:
                        metrics = {k: float(v) for k, v in metrics.items()}
                        _check_finite(metrics, guard)  # the global metrics: one verdict
                        last_healthy_step = step
                    if primary and step % hp.log.info_interval == 0:
                        now = time.perf_counter()
                        dt = rate_s + now - t_last
                        metrics["audio_seconds_per_s"] = rate_samples / sr / dt
                        metrics["steps_per_s"] = rate_steps / dt
                        t_last, rate_steps, rate_samples, rate_s = now, 0, 0, 0.0
                        writer.log_training(metrics, step)
                        print("epoch %d | g %.04f m %.04f s %.04f d %.04f k %.04f r %.04f "
                              "i %.04f | gn %.02f dn %.02f | step %d" % (
                                  epoch, metrics["loss_g"], metrics["loss_m"], metrics["loss_s"],
                                  metrics["loss_d"], metrics["loss_k"], metrics["loss_r"],
                                  metrics["loss_i"], metrics["grad_norm_g"],
                                  metrics["grad_norm_d"], step))
                    if max_steps is not None and step >= max_steps:
                        break
                rate_s += time.perf_counter() - t_last

                if epoch % hp.log.save_interval == 0:
                    if metrics is not None:
                        # the last step's metrics describe the update that made
                        # the current parameters: no non-finite checkpoint is written
                        _check_finite(metrics, guard)
                        last_healthy_step = step
                    if primary:
                        path = os.path.join(pth_dir, f"{name}_{epoch:04d}.pth")
                        ckpt.save(path, g_state, d_state, step, epoch, hp.get("raw", ""))
                        print(f"Saved checkpoint to: {path}")
                        ckpt.clean_checkpoints(pth_dir, name, hp.log.keep_ckpts)
                    ddp.barrier()  # the checkpoint is on disk before any rank reads it

                if max_steps is not None and step >= max_steps:
                    break
                epoch += 1

            except _Diverged as exc:
                detail = exc.args[0]
                print(f"NaN guard: non-finite metrics at step {step} ({detail}); "
                      f"last healthy step {last_healthy_step}")
                latest = ckpt.latest_checkpoint(pth_dir, name)
                if not (autoresume and restarts_left > 0 and latest):
                    raise TrainDivergence(step, last_healthy_step, detail) from None
                restarts_left -= 1
                lr_scale *= nan_lr_factor
                _, _, step, epoch = ckpt.restore_states(g_state, d_state, ckpt.load(latest))
                last_healthy_step = step
                rate_steps, rate_samples, rate_s = 0, 0, 0.0
                # a fresh stream per restart: the same noise into the same state
                # would diverge again
                generator.manual_seed(reseed(seed, step * 1000 + restarts_left))
                print(f"NaN guard: auto-resumed from {latest} at epoch {epoch}, step {step}; "
                      f"lr scaled to x{lr_scale} ({restarts_left} restarts left)")
    finally:  # a divergence too: the trace window ends, the writer flushes
        if profiler is not None:
            stop_trace(profiler, os.path.join(profile_dir, PROFILE_FILE), dev)
        if writer is not None:
            writer.close()
    return g_state, d_state, step


@torch.no_grad()
def validate(hp: Config, g_model, val_ds: SvcDataset, writer: TrainWriter | None,
             step: int) -> float:
    """Whole-utterance mel L1 through `SynthesizerTrn.infer`
    (vits_extend/validation.py:6-46): each utterance zero-padded to the
    dataset's longest, its draws from a generator seeded with its index."""
    data_cfg = {k: hp.data[k] for k in ("filter_length", "mel_channels", "sampling_rate",
                                        "hop_length", "win_length", "mel_fmin", "mel_fmax")}
    dev = next(g_model.parameters()).device
    hop = hp.data.hop_length
    pad_to = val_ds.max_frames
    total = 0.0
    for idx in range(len(val_ds)):
        ex = val_ds.get(idx)
        t = ex["ppg"].shape[0]
        ppg = np.zeros((1, pad_to, ex["ppg"].shape[1]), np.float32)
        vec = np.zeros((1, pad_to, ex["vec"].shape[1]), np.float32)
        pit = np.zeros((1, pad_to), np.float32)
        ppg[0, :t], vec[0, :t], pit[0, :t] = ex["ppg"], ex["vec"], ex["pit"]
        fake = g_model.infer(
            torch.from_numpy(ppg).to(dev), torch.from_numpy(vec).to(dev),
            torch.from_numpy(pit).to(dev), torch.from_numpy(ex["spk"][None]).to(dev),
            torch.tensor([t], device=dev),
            generator=torch.Generator(device=dev).manual_seed(idx))
        n = min(t * hop, len(ex["audio"]))
        fake_t = fake[:, :n, 0]
        real_t = torch.from_numpy(ex["audio"][None, :n]).to(dev)
        total += float(mel_l1_loss(fake_t, real_t, data_cfg))
        if writer is not None and idx < hp.log.num_audio:
            fake_np, real_np = fake_t[0].cpu().numpy(), ex["audio"][:n]
            writer.log_audio(f"fake/{idx}", fake_np, step)
            if step == 0:
                writer.log_audio(f"real/{idx}", real_np, step)
            if idx == 0:
                spec_fake, spec_real = (
                    linear_spectrogram(y, hp.data.filter_length, hop,
                                       hp.data.win_length)[0].T.cpu().numpy()
                    for y in (fake_t, real_t))  # [bins, frames]
                writer.log_fig_audio(real_np, fake_np, spec_fake, spec_real, idx, step)
    mel = total / max(len(val_ds), 1)
    if writer is not None:
        writer.log_validation(mel, step)
    return mel
