"""The GAN training step (JAX train/step.py; reference vits_extend/train.py:
170-247): generator forward with data perturbation; mel L1, MR-STFT x c_stft,
LSGAN, feature matching, both flow KLs and the GRL cosine speaker loss; AdamW
on G every `accum_step` steps on the mean of the accumulated gradients
(optax.MultiSteps semantics, reference train.py:225-232), AdamW on D every
step at lr / accum_step.

One discriminator forward on the fake || real batch serves both losses, as
the JAX step's two applies do after XLA merges them: G's gradient is taken of
loss_g with respect to G's parameters only (D frozen), D's of loss_d with
respect to D's parameters only, which is its gradient on the detached fake.

Under data parallelism (a torch.distributed group, parallel/ddp.py) every
rank computes its share of the global batch's loss, as the JAX step computes
the loss of a batch sharded on `data`: the mean terms over equal local
batches divided by the number of ranks, the flow KL and the spectral
convergence as the shares train/losses.py makes of them; the gradients are
summed in one all-reduce, and the reported metrics are the global ones, the
same on every rank. The random draws are the global batch's, each rank
keeping its rows (utils/rng.py), so that N ranks take the step one process
takes on the concatenated batch.

Entry points: `build_models`, `init_train_states` (models and optimizers on
the card unless device="cpu"), `set_learning_rate`, `make_train_step`.
Batch keys as JAX: ppg, vec, pit, spec, spk, ppg_l, spec_l, audio (numpy or
tensors; layouts [B, T, C], audio [B, S, 1]).
"""

from __future__ import annotations

import torch

from ..models.discriminator import Discriminator
from ..models.synthesizer import SynthesizerTrn, slice_segments
from ..parallel import ddp
from ..utils.config import Config
from ..utils.device import resolve_device
from ..utils.profiling import span
from ..utils.rng import RowShard
from . import losses

BATCH_KEYS = ("ppg", "vec", "pit", "spec", "spk", "ppg_l", "spec_l", "audio")


class TrainState:
    """A model and its AdamW. With every_k > 1 the gradients handed to
    `apply_gradients` are averaged over every_k calls (optax.MultiSteps: a
    running mean acc + (g - acc) / (n + 1)) and the optimizer steps on the
    every_k-th call only; in between neither the parameters nor the AdamW
    moments move."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 every_k: int = 1):
        self.model, self.optimizer, self.every_k = model, optimizer, every_k
        self.params = list(model.parameters())
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params] if every_k > 1 else None

    def apply_gradients(self, grads) -> bool:
        """Returns True when the optimizer stepped."""
        if self.acc is not None:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step = (n + 1) % self.every_k
            if self.mini_step:
                return False
            grads = self.acc
        for p, g in zip(self.params, grads):
            p.grad = g
        self.optimizer.step()
        for p in self.params:
            p.grad = None
        if self.acc is not None:
            for a in self.acc:
                a.zero_()
        return True


def build_models(hp: Config) -> tuple[SynthesizerTrn, Discriminator]:
    g = SynthesizerTrn(
        spec_channels=hp.data.filter_length // 2 + 1,
        segment_size=hp.data.segment_size // hp.data.hop_length,
        ppg_dim=hp.vits.ppg_dim,
        vec_dim=hp.vits.vec_dim,
        spk_dim=hp.vits.spk_dim,
        gin_channels=hp.vits.gin_channels,
        inter_channels=hp.vits.inter_channels,
        hidden_channels=hp.vits.hidden_channels,
        filter_channels=hp.vits.filter_channels,
        upsample_rates=tuple(hp.gen.upsample_rates),
        upsample_kernel_sizes=tuple(hp.gen.upsample_kernel_sizes),
        upsample_initial_channel=hp.gen.upsample_initial_channel,
        resblock_kernel_sizes=tuple(hp.gen.resblock_kernel_sizes),
        resblock_dilation_sizes=tuple(tuple(d) for d in hp.gen.resblock_dilation_sizes),
        sampling_rate=hp.data.sampling_rate,
        enc_p_layers=hp.vits.get("enc_p_layers", 6),
        enc_q_layers=hp.vits.get("enc_q_layers", 16),
        flow_wn_layers=hp.vits.get("flow_wn_layers", 4),
        n_flows=hp.vits.get("n_flows", 4),
    )
    d = Discriminator(
        mrd_resolutions=tuple(tuple(r) for r in hp.mrd.resolutions),
        mpd_periods=tuple(hp.mpd.periods),
        mpd_kernel_size=hp.mpd.kernel_size,
        mpd_stride=hp.mpd.stride,
        lrelu_slope=hp.mpd.lReLU_slope,
        # the conv stacks in bfloat16 (JAX train/step.py:81); parameters,
        # gradients, AdamW states and the losses stay float32
        compute_dtype=(torch.bfloat16 if hp.get("train", {}).get("bf16_discriminator")
                       else None),
    )
    return g, d


def _adamw(params, lr: float, hp: Config) -> torch.optim.AdamW:
    # the reference's torch AdamW with its default weight_decay=1e-2
    return torch.optim.AdamW(params, lr=lr, betas=tuple(hp.train.betas), eps=hp.train.eps,
                             weight_decay=1e-2)


def init_train_states(hp: Config, seed: int = 0,
                      device: str | torch.device | None = "cuda") -> tuple[TrainState, TrainState]:
    """(g_state, d_state): random weights from `seed` (JAX initializers) on
    `device` (the card by default), G's AdamW at the learning rate with
    accum_step accumulation, D's at learning_rate / accum_step."""
    dev = resolve_device(device)
    g, d = build_models(hp)
    gen = torch.Generator().manual_seed(seed)
    g.init_weights(gen)
    d.init_weights(gen)
    g, d = g.to(dev), d.to(dev)
    lr, accum = hp.train.learning_rate, hp.train.accum_step
    return (TrainState(g, _adamw(g.parameters(), lr, hp), accum),
            TrainState(d, _adamw(d.parameters(), lr / accum, hp)))


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """The per-epoch ExponentialLR hook (reference train.py:146-147)."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state


def _to_device(batch, device: torch.device) -> dict:
    return {k: torch.as_tensor(batch[k]).to(device) for k in BATCH_KEYS}


def audio_losses(hp: Config, d_model: Discriminator, fake: torch.Tensor,
                 audio_real: torch.Tensor, glob: ddp.GlobalBatch | None = None) -> dict:
    """The loss terms that see the generated audio ([B, S, 1] each): mel L1
    x c_mel, MR-STFT x c_stft, LSGAN score and feature matching, from one
    discriminator forward on fake || real; also loss_d of that forward.
    Under `glob`, this rank's shares of the global batch's terms."""
    tc = hp.train
    data_cfg = {k: hp.data[k] for k in ("filter_length", "mel_channels", "sampling_rate",
                                        "hop_length", "win_length", "mel_fmin", "mel_fmax")}
    resolutions = [tuple(r) for r in hp.mrd.resolutions]
    mel_loss = losses.mel_l1_loss(fake[..., 0], audio_real[..., 0], data_cfg) * tc.c_mel
    sc_loss, mag_loss = losses.multi_resolution_stft_loss(fake[..., 0], audio_real[..., 0],
                                                          resolutions, glob)
    n = fake.shape[0]
    with span("svc.step.d_forward"):
        disc = d_model(torch.cat([fake, audio_real], dim=0))
    disc_fake = [([m[:n] for m in fmap], s[:n]) for fmap, s in disc]
    disc_real = [([m[n:] for m in fmap], s[n:]) for fmap, s in disc]
    terms = dict(loss_m=mel_loss, loss_s=(sc_loss + mag_loss) * tc.c_stft,
                 score_loss=losses.generator_adversarial_loss(disc_fake),
                 feat_loss=losses.feature_matching_loss(disc_fake, disc_real),
                 loss_d=losses.discriminator_adversarial_loss(disc_fake, disc_real))
    if glob is not None:  # means over equal local batches: a rank's share is mean / world
        for k in ("loss_m", "score_loss", "feat_loss", "loss_d"):
            terms[k] = terms[k] / glob.world
    return terms


def loss_and_grads(hp: Config, g_model: SynthesizerTrn, d_model: Discriminator, batch,
                   generator: torch.Generator | RowShard | None = None,
                   glob: ddp.GlobalBatch | None = None, **switches):
    """One step's losses and gradients, without the optimizer updates:
    (g_grads, d_grads, metrics), grads in parameters() order. `switches`
    go to SynthesizerTrn.forward (train, perturb, noise_scale, slice_ids).
    Under `glob` the losses are this rank's shares and the gradients this
    rank's part of the global batch's (summed over the ranks by the step)."""
    dev = next(g_model.parameters()).device
    with span("svc.step.upload"):
        b = _to_device(batch, dev)
    with span("svc.step.g_forward"):
        out = g_model(b["ppg"], b["vec"], b["pit"], b["spec"], b["spk"], b["ppg_l"],
                      b["spec_l"], generator=generator, **switches)
    with span("svc.step.audio_losses"):
        audio_real = slice_segments(b["audio"], out.ids_slice * hp.data.hop_length,
                                    hp.data.segment_size)
        metrics = audio_losses(hp, d_model, out.fake_audio, audio_real, glob)
    with span("svc.step.kl"):
        c_kl = hp.train.c_kl
        metrics["loss_k"] = losses.kl_loss(out.z_f, out.logs_q, out.m_p, out.logs_p,
                                           out.logdet_f, out.spec_mask, glob) * c_kl
        metrics["loss_r"] = losses.kl_loss(out.z_r, out.logs_p, out.m_q, out.logs_q,
                                           out.logdet_r, out.spec_mask, glob) * c_kl
        metrics["loss_i"] = losses.cosine_speaker_loss(b["spk"], out.spk_preds)
        if glob is not None:
            metrics["loss_i"] = metrics["loss_i"] / glob.world
        loss_g = (metrics["score_loss"] + metrics["feat_loss"] + metrics["loss_m"]
                  + metrics["loss_s"] + metrics["loss_k"] + metrics["loss_r"] * 0.5
                  + metrics["loss_i"] * 2.0)
    # the autograd engine runs the card's backward on its own thread while
    # this one waits inside grad(): each span covers its pass's wall interval
    with span("svc.step.d_backward"):
        d_grads = torch.autograd.grad(metrics["loss_d"], list(d_model.parameters()),
                                      retain_graph=True)
    with span("svc.step.g_backward"):
        g_grads = torch.autograd.grad(loss_g, list(g_model.parameters()))
    metrics["loss_g"] = loss_g
    return g_grads, d_grads, {k: v.detach() for k, v in metrics.items()}


def global_grads(hp: Config, g_model: SynthesizerTrn, d_model: Discriminator, batch,
                 generator: torch.Generator | None = None,
                 glob: ddp.GlobalBatch | None = None):
    """The step's (g_grads, d_grads, metrics) of the global batch. Without
    `glob`, loss_and_grads of `batch`. Under `glob`, `batch` is this rank's
    rows, `generator` the same on every rank: this rank's shares, then the
    gradients and the metrics summed over the ranks (two all-reduces), equal
    on every rank."""
    if glob is None:
        return loss_and_grads(hp, g_model, d_model, batch, generator)
    shard = RowShard(generator, ddp.rank(), glob.world)
    g_grads, d_grads, metrics = loss_and_grads(hp, g_model, d_model, batch, shard, glob)
    grads = ddp.all_sum_list([*g_grads, *d_grads])
    keys = sorted(metrics)
    metrics = dict(zip(keys, ddp.all_sum_list([metrics[k] for k in keys])))
    return grads[: len(g_grads)], grads[len(g_grads) :], metrics


def make_train_step(hp: Config, g_state: TrainState, d_state: TrainState):
    """Returns step(batch, generator=None) -> metrics (0-d tensors on the
    device, grad norms before the optional clip_grad_value clamp). Updates
    the states in place. In a torch.distributed group `batch` is this rank's
    rows of the global batch, `generator` the same on every rank; the step
    is the global batch's on every rank."""
    clip = hp.train.get("clip_grad_value")
    glob = ddp.GlobalBatch() if ddp.is_initialized() else None
    calls = 0  # the unit id of the step's spans

    def train_step(batch, generator: torch.Generator | None = None) -> dict:
        nonlocal calls
        calls += 1
        with span("svc.step", unit=calls):
            g_grads, d_grads, metrics = global_grads(hp, g_state.model, d_state.model, batch,
                                                     generator, glob)
            with span("svc.step.update"):
                metrics["grad_norm_g"] = torch.nn.utils.get_total_norm(g_grads)
                metrics["grad_norm_d"] = torch.nn.utils.get_total_norm(d_grads)
                if clip is not None:
                    for grad in (*g_grads, *d_grads):
                        grad.clamp_(-clip, clip)
                g_state.apply_gradients(g_grads)
                d_state.apply_gradients(d_grads)
        return metrics

    return train_step
