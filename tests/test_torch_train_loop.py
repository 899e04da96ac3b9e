"""The port's training runtime around the step: checkpoints (round trip to the
bit, the JAX package reading the port's `.pth`, a JAX `.ckpt` with its optax
state carried into the port), `SynthesizerTrn.infer` against the JAX graph,
and the loop on the CPU (resume, the NaN guard's halt and auto-resume, the
per-epoch learning rate, validation, the profiler window), at micro_hp on
synthetic data."""

import argparse
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_train_loop import _make_data
from whisper_vits_svc_tpu.data import dataset as jdataset
from whisper_vits_svc_tpu.infer import pipeline as jpipeline
from whisper_vits_svc_tpu.train import loop as jloop
from whisper_vits_svc_tpu.train import checkpoint as jckpt
from whisper_vits_svc_tpu.train.step import init_train_states as j_init_train_states
from whisper_vits_svc_tpu.train.step import make_train_step as j_make_train_step
from whisper_vits_svc_tpu.utils.pitch import f0_to_coarse as j_f0_to_coarse
from whisper_vits_svc_tpu.utils.testing import micro_hp, synthetic_batch, tiny_hp
from whisper_vits_svc_tpu_torch.data.dataset import BucketBatcher, SvcDataset, boundaries_for
from whisper_vits_svc_tpu_torch.infer import pipeline
from whisper_vits_svc_tpu_torch.models.convert import (
    from_jax_disc_params, from_jax_params, from_jax_trn_params,
)
from whisper_vits_svc_tpu_torch.train import checkpoint as ckpt
from whisper_vits_svc_tpu_torch.train import loop as loop_mod
from whisper_vits_svc_tpu_torch.train import step as tstep
from whisper_vits_svc_tpu_torch.utils.config import config_from_dict

OPTAX_ATOL = 1e-6  # tests/test_torch_train_step.py::test_optimizer_updates_match_optax
# The JAX run's real gradients leave first moments up to ~20, where 1e-6 is
# under one float32 ulp and optax's b1 * mu + (1 - b1) * g and torch's lerp
# round one ulp apart: the moments are held at 1e-6 absolute or relative.
MOMENT_RTOL = 1e-6
PIPELINE_ATOL = 1e-4  # tests/test_torch_pipeline.py: waveforms
MOMENTS = ("exp_avg", "exp_avg_sq")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _states(hp, seed=0):
    return tstep.init_train_states(config_from_dict(hp), seed=seed, device="cpu")


def _random_grads(state, rng):
    return [torch.from_numpy((rng.standard_normal(p.shape) * 0.3).astype(np.float32))
            for p in state.params]


def _assert_states_equal(a, b):
    """Parameters, AdamW moments and step, lr, acc and mini_step, to the bit."""
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
        sa, sb = a.optimizer.state.get(p, {}), b.optimizer.state.get(q, {})
        assert sorted(sa) == sorted(sb), name
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (name, k)
    assert a.optimizer.param_groups[0]["lr"] == b.optimizer.param_groups[0]["lr"]
    assert a.mini_step == b.mini_step
    if a.acc is not None:
        for x, y in zip(a.acc, b.acc):
            assert torch.equal(x, y)


# -- checkpoints ---------------------------------------------------------------


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    """Three accumulation calls (G steps once and holds a half-full
    accumulator, D steps three times) saved and restored into states made
    from another seed: parameters, moments, step, acc, mini_step, lr and the
    counters come back to the bit, and the next update is the same."""
    hp = micro_hp()
    g, d = _states(hp, seed=0)
    rng = np.random.default_rng(3)
    tstep.set_learning_rate(g, 3e-4)
    for _ in range(3):
        g.apply_gradients(_random_grads(g, rng))
        d.apply_gradients(_random_grads(d, rng))
    assert g.mini_step == 1 and any(bool(a.any()) for a in g.acc)
    path = str(tmp_path / "t_0002.pth")
    ckpt.save(path, g, d, step=3, epoch=2, hp_str="train: {}\n")
    assert not os.path.exists(path + ".tmp")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert sorted(payload) == ["epoch", "hp_str", "model_d", "model_g", "optim_d", "optim_g",
                               "step"]
    assert list(payload["model_g"]) == list(g.model.state_dict())
    g2, d2 = _states(hp, seed=1)
    _, _, step, epoch = ckpt.restore_states(g2, d2, ckpt.load(path))
    assert (step, epoch) == (3, 2)
    _assert_states_equal(g, g2)
    _assert_states_equal(d, d2)
    grads_g, grads_d = _random_grads(g, rng), _random_grads(d, rng)
    for a, b, grads in ((g, g2, grads_g), (g, g2, grads_g), (d, d2, grads_d)):
        a.apply_gradients([x.clone() for x in grads])
        b.apply_gradients([x.clone() for x in grads])
    _assert_states_equal(g, g2)
    _assert_states_equal(d, d2)


def test_merge_tolerant_keeps_init_for_missing_keys(capsys):
    g, _ = _states(micro_hp())
    init = g.model.state_dict()
    other, _ = _states(micro_hp(), seed=4)
    saved = dict(other.model.state_dict())
    dropped = [k for k in saved if k.startswith("enc_q.")]
    for k in dropped:
        del saved[k]
    merged = ckpt.merge_tolerant(init, saved)
    assert list(merged) == list(init)
    for k in init:
        assert torch.equal(merged[k], init[k] if k in dropped else saved[k]), k
    assert f"{dropped[0]} is not in the checkpoint" in capsys.readouterr().out
    saved[dropped[0]] = torch.zeros(3)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.merge_tolerant(init, saved)


def test_latest_and_clean_checkpoints_go_by_mtime(tmp_path):
    names = ["t_0001.pth", "t_0002.pth", "t_0010.pth", "t_0003.pth"]
    now = time.time()
    for age, name in zip([10, 40, 30, 20], names):  # newest: t_0001, oldest: t_0002
        (tmp_path / name).write_bytes(b"x")
        os.utime(tmp_path / name, (now - age, now - age))
    for other in ("u_0005.pth", "t_0004.ckpt", "t_final.pth"):
        (tmp_path / other).write_bytes(b"x")
    assert ckpt.latest_checkpoint(str(tmp_path), "t") == str(tmp_path / "t_0001.pth")
    assert ckpt.latest_checkpoint(str(tmp_path / "none"), "t") is None
    ckpt.clean_checkpoints(str(tmp_path), "t", 0)
    assert len(os.listdir(tmp_path)) == 7
    ckpt.clean_checkpoints(str(tmp_path), "t", 2)
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["t_0001.pth", "t_0003.pth", "u_0005.pth", "t_0004.ckpt", "t_final.pth"])


@pytest.fixture(scope="module")
def tiny_states():
    """tiny_hp with the reference's depths, which the JAX package's
    converters of a torch state_dict assume (three dilations a block)."""
    hp = tiny_hp()
    hp.gen["resblock_dilation_sizes"] = [[1, 3, 5]]
    g, d = _states(hp, seed=2)
    with torch.no_grad():  # non-trivial values for the zero-initialised leaves
        gen = torch.Generator().manual_seed(0)
        for p in (*g.model.parameters(), *d.model.parameters()):
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    return hp, g, d


def test_export_inference_reads_in_both_packages(tmp_path, tiny_states):
    """export_inference keeps {model_g} without enc_q, speaker_classifier and
    emb_g; the port's load_svc_model and the JAX package's .pth route both
    read it, to the port's parameters."""
    hp, g, _ = tiny_states
    path = str(tmp_path / "export.pth")
    ckpt.export_inference(path, g.model)
    sd = torch.load(path, map_location="cpu", weights_only=True)["model_g"]
    assert not any(k.startswith(("enc_q.", "speaker_classifier.", "emb_g.")) for k in sd)
    assert any(k.startswith("enc_p.") for k in sd) and any(k.startswith("dec.") for k in sd)
    model = pipeline.load_svc_model(path, pipeline.build_infer_model(config_from_dict(hp),
                                                                      device="cpu", seed=9))
    full = g.model.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, full[k]), k
    jparams = jpipeline.load_svc_model(path, jpipeline.build_infer_model(hp), hp)
    for k, v in from_jax_params(jparams).items():
        assert torch.equal(v, full[k]), k


def test_jax_load_torch_pretrain_reads_the_port_checkpoint(tmp_path, tiny_states):
    hp, g, d = tiny_states
    path = str(tmp_path / "t_0001.pth")
    ckpt.save(path, g, d, step=7, epoch=1)
    payload = jckpt.load_torch_pretrain(path)
    assert (payload["step"], payload["epoch"]) == (7, 1)
    for port_sd, model in ((from_jax_trn_params(payload["model_g"]), g.model),
                           (from_jax_disc_params(payload["model_d"]), d.model)):
        own = dict(model.named_parameters())
        assert sorted(port_sd) == sorted(own)
        for k, v in port_sd.items():
            assert torch.equal(v, own[k].detach()), k


def test_weights_only_loads_the_reference_layout(tmp_path):
    """A .pth in the reference layout (state_dicts, optimizer state_dicts,
    int step and epoch, hp_str text) loads with weights_only=True."""
    g, d = _states(micro_hp())
    g.apply_gradients(_random_grads(g, np.random.default_rng(0)))
    g.apply_gradients(_random_grads(g, np.random.default_rng(1)))
    path = str(tmp_path / "ref.pth")
    torch.save({"model_g": g.model.state_dict(), "model_d": d.model.state_dict(),
                "optim_g": g.optimizer.state_dict(), "optim_d": d.optimizer.state_dict(),
                "step": 12, "epoch": 3, "hp_str": "train:\n  seed: 1234\n"}, path)
    payload = ckpt.load_torch_pretrain(path)
    assert (payload["step"], payload["epoch"]) == (12, 3)
    assert list(payload["model_g"]) == list(g.model.state_dict())
    g2, d2 = _states(micro_hp(), seed=5)
    ckpt.warm_start(g2, d2, payload)
    for p, q in zip(g.model.parameters(), g2.model.parameters()):
        assert torch.equal(p, q)
    assert ckpt.load(path)["optim_g"]["state"][0]["exp_avg"].shape == g.params[0].shape


def test_weights_only_refuses_pickled_objects(tmp_path):
    g, _ = _states(micro_hp())
    path = str(tmp_path / "pickled.pth")
    torch.save({"model_g": g.model.state_dict(), "hp": argparse.Namespace(seed=1)}, path)
    with pytest.raises(ValueError, match="weights_only"):
        ckpt.load_torch_pretrain(path)
    with pytest.raises(ValueError, match="weights_only"):
        ckpt.load(path)


# -- a JAX .ckpt, optimizer state included ----------------------------------------


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's train step at micro_hp for three steps, with a .ckpt
    saved after steps 2 and 3."""
    hp = micro_hp()
    out = tmp_path_factory.mktemp("jax_run")
    g, d, g_model, d_model = j_init_train_states(hp, jax.random.PRNGKey(0), init_frames=20)
    step = jax.jit(j_make_train_step(hp, g_model, d_model))
    saved = {}
    for i in range(1, 4):
        batch = synthetic_batch(hp, np.random.default_rng(i), b=2, t=20)
        g, d, metrics = step(g, d, batch, jax.random.PRNGKey(i))
        assert np.isfinite(float(metrics["loss_g"]))
        if i >= 2:
            path = str(out / f"t_{i:04d}.ckpt")
            jckpt.save(path, g, d, i, 1, "train: {}\n")
            saved[i] = (path, jax.tree.map(np.asarray, g), jax.tree.map(np.asarray, d))
    return hp, g_model, d_model, saved


@pytest.mark.parametrize("jax_steps", [2, 3])
def test_jax_ckpt_carries_the_optimizer_state(jax_run, jax_steps):
    """The port restores a JAX .ckpt (parameters, AdamW moments and count,
    the MultiSteps accumulator and mini_step), then both sides apply the
    same gradients until G's accumulation crosses a boundary: optax's update
    and TrainState.apply_gradients agree in parameters and moments."""
    hp, _, _, saved = jax_run
    path, jg, jd = saved[jax_steps]
    g, d = _states(hp, seed=7)
    _, _, step, epoch = ckpt.restore_states(g, d, ckpt.load(path))
    assert (step, epoch) == (jax_steps, 1)
    assert g.mini_step == jax_steps % 2
    assert g.optimizer.param_groups[0]["lr"] == pytest.approx(hp.train.learning_rate)
    rng = np.random.default_rng(11)
    for state, jstate, to_sd, calls in ((g, jg, from_jax_trn_params, 2 - jax_steps % 2),
                                        (d, jd, from_jax_disc_params, 2)):
        params, opt_state = jstate.params, jstate.opt_state
        update = jax.jit(jstate.tx.update)
        names = [n for n, _ in state.model.named_parameters()]
        for _ in range(calls):
            grads = jax.tree.map(
                lambda a: (rng.standard_normal(a.shape) * 0.3).astype(np.float32), params)
            grads_sd = to_sd(grads)
            state.apply_gradients([grads_sd[n].clone() for n in names])
            updates, opt_state = update(grads, opt_state, params)
            params = jax.tree.map(np.asarray, optax.apply_updates(params, updates))
            inner = opt_state.inner_opt_state if hasattr(opt_state, "acc_grads") else opt_state
            adam = inner.inner_state[0]
            ref = {"param": to_sd(params), "exp_avg": to_sd(jax.tree.map(np.asarray, adam.mu)),
                   "exp_avg_sq": to_sd(jax.tree.map(np.asarray, adam.nu))}
            for n, p in state.model.named_parameters():
                np.testing.assert_allclose(_np(p), ref["param"][n].numpy(), atol=OPTAX_ATOL,
                                           rtol=0, err_msg=n)
                for k in MOMENTS:
                    np.testing.assert_allclose(_np(state.optimizer.state[p][k]),
                                               ref[k][n].numpy(), atol=OPTAX_ATOL,
                                               rtol=MOMENT_RTOL, err_msg=f"{n} {k}")
                assert int(state.optimizer.state[p]["step"]) == int(adam.count)
        if state is g:
            assert g.mini_step == 0 and int(opt_state.mini_step) == 0


def test_synthesizer_infer_matches_jax(jax_run):
    """SynthesizerTrn.infer at zero noise and no jitter against JAX's enc_p
    (noise_scale 0), reverse flow and dec composed through apply(method=)."""
    hp, g_model, _, saved = jax_run
    rng = np.random.default_rng(2)
    params = jax.tree.map(
        lambda a: a + (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        saved[2][1].params)
    g, _ = _states(hp)
    g.model.load_state_dict(from_jax_trn_params(params), strict=True)
    b = synthetic_batch(hp, np.random.default_rng(4), b=2, t=20)
    lens = np.array([20, 13], np.int32)

    def compose(m, ppg, vec, pit, spk, ppg_l):
        z_p, _, _, mask, _ = m.enc_p(ppg, ppg_l, vec, j_f0_to_coarse(pit), noise_scale=0.0)
        z, _ = m.flow(z_p, mask, g=spk, reverse=True)
        return m.dec(spk, z * mask, f0_frames=pit)

    args = (b["ppg"], b["vec"], b["pit"], b["spk"], lens)
    ref = np.asarray(g_model.apply({"params": params}, *args, method=compose,
                                   rngs={"noise": jax.random.PRNGKey(0)}))
    with torch.no_grad():
        got = g.model.infer(*(torch.from_numpy(a) for a in args), noise_scale=0.0,
                            perturb=False)
    assert got.shape == ref.shape == (2, 20 * hp.data.hop_length, 1)
    np.testing.assert_allclose(_np(got), ref, atol=PIPELINE_ATOL)
    with torch.no_grad():  # the draws come from the generator
        a, b2, c = (g.model.infer(*(torch.from_numpy(x) for x in args),
                                  generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1))
    assert torch.equal(a, b2) and not torch.equal(a, c)


# -- the loop ----------------------------------------------------------------------


def _loop_hp(tmp_path, **log):
    _, fl, jhp = _make_data(tmp_path, np.random.default_rng(1234), micro_hp())
    hp = config_from_dict(jhp)
    hp["data"]["training_files"] = str(fl)
    hp["data"]["validation_files"] = str(fl)
    hp["train"]["pretrain"] = ""
    hp["train"]["epochs"] = 10000
    hp["log"] = config_from_dict(dict(
        dict(info_interval=1, eval_interval=10000, save_interval=1, num_audio=0,
             pth_dir=str(tmp_path / "chkpt"), log_dir=str(tmp_path / "logs"), keep_ckpts=0),
        **log))
    return hp


def _ckpt_dir(hp, name="t"):
    return os.path.join(hp.log.pth_dir, name)


def _poison(monkeypatch, at: int) -> dict:
    """NaN in the ppg of the `at`-th batch the loop takes, counted over runs."""
    state = {"n": 0, "at": at}
    orig = loop_mod.prefetch

    def poisoned(iterable, depth=2):
        for batch in orig(iterable, depth):
            state["n"] += 1
            if state["n"] == state["at"]:
                batch = dict(batch, ppg=np.full_like(batch["ppg"], np.nan))
            yield batch

    monkeypatch.setattr(loop_mod, "prefetch", poisoned)
    return state


def _batches_per_epoch(hp) -> int:
    ds = SvcDataset(hp.data.training_files, hp.data)
    return BucketBatcher(ds, hp.train.batch_size, boundaries_for(hp.data),
                         seed=hp.train.seed).batches_per_epoch()


def _prefetch_threads() -> list:
    return [t for t in threading.enumerate() if t.name == "prefetch" and t.is_alive()]


def test_loop_runs_and_resumes(tmp_path):
    """Three steps and a checkpoint; the checkpoint holds the returned
    states to the bit; a resume continues the step counter."""
    hp = _loop_hp(tmp_path)
    g, d, step = loop_mod.train(hp, "t", max_epochs=1, max_steps=3, device="cpu")
    assert step == 3
    path = os.path.join(_ckpt_dir(hp), "t_0001.pth")
    payload = ckpt.load(path)
    assert (payload["step"], payload["epoch"]) == (3, 1)
    g2, d2 = _states(hp, seed=8)
    ckpt.restore_states(g2, d2, payload)
    _assert_states_equal(g, g2)
    _assert_states_equal(d, d2)
    g3, _, step = loop_mod.train(hp, "t", chkpt_path=path, max_epochs=1, max_steps=5,
                                 device="cpu")
    assert step == 5 and ckpt.load(path)["step"] == 5
    assert all(torch.isfinite(p).all() for p in g3.model.parameters())


def test_nan_guard_halts_without_autoresume(tmp_path, monkeypatch):
    """A NaN batch at step 2, before any checkpoint: TrainDivergence with the
    last healthy step 1, and no checkpoint written."""
    hp = _loop_hp(tmp_path)
    _poison(monkeypatch, at=2)
    with pytest.raises(loop_mod.TrainDivergence) as info:
        loop_mod.train(hp, "t", max_epochs=2, max_steps=6, device="cpu")
    assert (info.value.step, info.value.last_healthy_step) == (2, 1)
    assert os.listdir(_ckpt_dir(hp)) == []
    assert not _prefetch_threads()


def test_divergence_stops_the_profiler(tmp_path, monkeypatch):
    """TrainDivergence inside the profiler's window (steps 3-12, a NaN batch
    at step 4): the profiler is stopped, its trace is written, and no
    prefetch thread is left holding batches."""
    hp = _loop_hp(tmp_path)
    _poison(monkeypatch, at=4)
    with pytest.raises(loop_mod.TrainDivergence) as info:
        loop_mod.train(hp, "t", max_epochs=4, device="cpu",
                       profile_dir=str(tmp_path / "prof"), profile_steps=10)
    assert info.value.step == 4
    assert not torch.autograd._profiler_enabled()
    assert (tmp_path / "prof" / "train_steps.json").is_file()
    assert not _prefetch_threads()


def test_nan_guard_autoresumes_from_checkpoint(tmp_path, monkeypatch, capsys):
    """A NaN batch first in epoch 2: auto-resume from epoch 1's checkpoint
    with the learning rate halved; the re-run epochs are clean, so the run
    ends at 3n steps for n batches an epoch."""
    hp = _loop_hp(tmp_path)
    n = _batches_per_epoch(hp)
    _poison(monkeypatch, at=n + 1)
    hp["train"]["nan_autoresume"] = True
    hp["train"]["nan_lr_factor"] = 0.5
    g, d, step = loop_mod.train(hp, "t", max_epochs=2, max_steps=10**9, device="cpu")
    assert step == 3 * n
    assert "auto-resumed" in capsys.readouterr().out
    lr = hp.train.learning_rate * 0.5 * hp.train.lr_decay
    assert g.optimizer.param_groups[0]["lr"] == pytest.approx(lr, rel=1e-12)
    assert d.optimizer.param_groups[0]["lr"] == pytest.approx(lr / hp.train.accum_step,
                                                              rel=1e-12)
    assert all(torch.isfinite(p).all() for p in g.model.parameters())
    assert sorted(os.listdir(_ckpt_dir(hp))) == ["t_0001.pth", "t_0002.pth"]


def test_epoch_lr_validation_and_profile(tmp_path, monkeypatch):
    """Two epochs: epoch e trains G at lr0 * gamma^(e-1) and D at that over
    accum_step (JAX train/loop.py:144-146); validation at each epoch writes
    validation_mel_loss records; the profiler window writes a Chrome trace
    holding the spans of its two steps."""
    import json

    hp = _loop_hp(tmp_path, eval_interval=1, info_interval=2)
    n = _batches_per_epoch(hp)
    seen = []

    def spy(state, lr):
        seen.append(lr)
        return tstep.set_learning_rate(state, lr)

    monkeypatch.setattr(loop_mod, "set_learning_rate", spy)
    g, d, step = loop_mod.train(hp, "t", max_epochs=2, device="cpu",
                                profile_dir=str(tmp_path / "prof"), profile_steps=2)
    assert step == 2 * n
    lr0, gamma, accum = hp.train.learning_rate, hp.train.lr_decay, hp.train.accum_step
    expected = [lr for e in (1, 2) for lr in (lr0 * gamma ** (e - 1), lr0 * gamma ** (e - 1) / accum)]
    assert seen == expected
    assert g.optimizer.param_groups[0]["lr"] == expected[2]
    assert d.optimizer.param_groups[0]["lr"] == expected[3]
    records = [json.loads(line) for line in
               open(os.path.join(hp.log.log_dir, "t", "metrics.jsonl"))]
    val = [r for r in records if "validation_mel_loss" in r]
    assert [r["step"] for r in val] == [0, n]
    assert all(np.isfinite(r["validation_mel_loss"]) for r in val)
    train_recs = [r for r in records if "loss_g" in r]
    assert [r["step"] for r in train_recs] == list(range(2, 2 * n + 1, 2))
    assert all(r["steps_per_s"] > 0 and r["audio_seconds_per_s"] > 0 for r in train_recs)
    trace = tmp_path / "prof" / "train_steps.json"
    assert trace.is_file() and trace.stat().st_size > 0
    ranges = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    assert ranges.count("svc.step") == 2 and ranges.count("svc.step.update") == 2


def test_writer_rates_span_epochs(tmp_path, monkeypatch):
    """On a fake clock where a step takes 0.25 s and each validation and
    checkpoint 1000 s: with 4 batches an epoch and a record every 3 steps,
    the records at steps 6 and 9 span an epoch boundary, and every record
    reads the steps and samples since the last one over their 0.25 s each,
    exactly."""
    import json
    from types import SimpleNamespace

    hp = _loop_hp(tmp_path, eval_interval=1, info_interval=3)
    assert _batches_per_epoch(hp) == 4
    clock = [0.0]
    samples = []
    monkeypatch.setattr(loop_mod, "time", SimpleNamespace(perf_counter=lambda: clock[0]))
    real_make, real_validate, real_save = loop_mod.make_train_step, loop_mod.validate, ckpt.save

    def make(*args):
        step = real_make(*args)

        def timed(batch, generator=None):
            metrics = step(batch, generator)
            samples.append(int(batch["spec_l"].sum()) * hp.data.hop_length)
            clock[0] += 0.25
            return metrics
        return timed

    def slow(fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            clock[0] += 1000.0
            return out
        return wrapped

    monkeypatch.setattr(loop_mod, "make_train_step", make)
    monkeypatch.setattr(loop_mod, "validate", slow(real_validate))
    monkeypatch.setattr(ckpt, "save", slow(real_save))
    loop_mod.train(hp, "t", max_epochs=3, device="cpu")
    records = [json.loads(line) for line in
               open(os.path.join(hp.log.log_dir, "t", "metrics.jsonl"))]
    train_recs = [r for r in records if "loss_g" in r]
    assert [r["step"] for r in train_recs] == [3, 6, 9, 12]
    for r in train_recs:
        s = r["step"]
        assert r["steps_per_s"] == 3 / 0.75
        assert r["audio_seconds_per_s"] == pytest.approx(
            sum(samples[s - 3 : s]) / hp.data.sampling_rate / 0.75, rel=1e-12)


def test_validate_matches_infer_and_mel_loss(tmp_path):
    """validate: each utterance through SynthesizerTrn.infer with its index's
    generator, the mel L1 mean, and one JSONL record."""
    from whisper_vits_svc_tpu_torch.train.losses import mel_l1_loss
    from whisper_vits_svc_tpu_torch.train.writer import TrainWriter

    hp = _loop_hp(tmp_path)
    g, _ = _states(hp)
    ds = SvcDataset(hp.data.validation_files, hp.data)
    writer = TrainWriter(str(tmp_path / "logs"), hp.data.sampling_rate)
    mel = loop_mod.validate(hp, g.model, ds, writer, step=5)
    writer.close()
    data_cfg = {k: hp.data[k] for k in ("filter_length", "mel_channels", "sampling_rate",
                                        "hop_length", "win_length", "mel_fmin", "mel_fmax")}
    total = 0.0
    for idx in range(len(ds)):
        ex = ds.get(idx)
        t = ex["ppg"].shape[0]
        pad = ds.max_frames - t
        args = [torch.from_numpy(np.pad(ex[k], ((0, pad), (0, 0))))[None] for k in ("ppg", "vec")]
        with torch.no_grad():
            fake = g.model.infer(args[0], args[1], torch.from_numpy(np.pad(ex["pit"], (0, pad)))[None],
                                 torch.from_numpy(ex["spk"])[None], torch.tensor([t]),
                                 generator=torch.Generator().manual_seed(idx))
        n = t * hp.data.hop_length
        total += float(mel_l1_loss(fake[:, :n, 0], torch.from_numpy(ex["audio"][None, :n]),
                                   data_cfg))
    assert mel == pytest.approx(total / len(ds), rel=1e-6)
    lines = open(tmp_path / "logs" / "metrics.jsonl").read().splitlines()
    assert len(lines) == 1 and '"validation_mel_loss"' in lines[0] and '"step": 5' in lines[0]


METRIC_KEYS = ("loss_g", "loss_m", "loss_s", "loss_d", "loss_k", "loss_r", "loss_i",
               "grad_norm_g", "grad_norm_d")


def test_epoch_lr_matches_jax_loop(tmp_path, monkeypatch):
    """The learning rates both loops set, epoch by epoch, through a NaN batch
    and its auto-resume (lr scaled by nan_lr_factor), with each package's
    step replaced by one that leaves the states as they are and reports
    loss_g = 0 * sum(ppg): JAX's loop and the port's set the same G and D
    rates in the same order and end at the same step."""
    hp = _loop_hp(tmp_path)
    n = _batches_per_epoch(hp)
    hp["train"].update(nan_autoresume=True, nan_lr_factor=0.25, lr_decay=0.9)
    jhp = micro_hp()
    jhp["data"].update(training_files=hp.data.training_files,
                       validation_files=hp.data.validation_files)
    jhp["train"].update(pretrain="", epochs=10000, nan_autoresume=True, nan_lr_factor=0.25,
                        lr_decay=0.9)
    jhp["log"] = dict(hp.log, pth_dir=str(tmp_path / "jchkpt"), log_dir=str(tmp_path / "jlogs"))
    jhp["dist"] = dict(coordinator_address=None, num_processes=1, process_id=0)

    seen = {"jax": [], "port": []}

    def spy(pkg, orig):
        def set_lr(state, lr):
            seen[pkg].append(lr)
            return orig(state, lr)
        return set_lr

    def j_step(hp, g_model, d_model):
        def step(g, d, batch, rng):
            z = jnp.sum(batch["ppg"]) * 0.0
            return g, d, {k: z for k in METRIC_KEYS}
        return step

    def port_step(hp, g_state, d_state):
        def step(batch, generator):
            z = float(np.sum(batch["ppg"]) * 0.0)
            return {k: z for k in METRIC_KEYS}
        return step

    poisoned = {"jax": 0, "port": 0}

    def poison(pkg, orig):
        def wrapped(iterable, depth=2):
            for batch in orig(iterable, depth):
                poisoned[pkg] += 1
                if poisoned[pkg] == n + 2:  # epoch 2's second batch
                    batch = dict(batch, ppg=np.full_like(batch["ppg"], np.nan))
                yield batch
        return wrapped

    import whisper_vits_svc_tpu.data.prefetch as jprefetch

    monkeypatch.setattr(jloop, "set_learning_rate", spy("jax", jloop.set_learning_rate))
    monkeypatch.setattr(jloop, "make_train_step", j_step)
    monkeypatch.setattr(jprefetch, "prefetch", poison("jax", jprefetch.prefetch))
    monkeypatch.setattr(loop_mod, "set_learning_rate", spy("port", loop_mod.set_learning_rate))
    monkeypatch.setattr(loop_mod, "make_train_step", port_step)
    monkeypatch.setattr(loop_mod, "prefetch", poison("port", loop_mod.prefetch))
    _, _, j_steps = jloop.train(jhp, "t", max_epochs=3)
    _, _, steps = loop_mod.train(hp, "t", max_epochs=3, device="cpu")
    # epochs 1, 2, then from epoch 1's checkpoint 1, 2, 3: each sets G's
    # rate, then D's
    assert len(seen["port"]) == 10 and seen["port"] == seen["jax"]
    assert seen["port"][4:6] == [seen["port"][0] * 0.25, seen["port"][1] * 0.25]
    assert steps == j_steps == 4 * n


def test_validate_matches_jax(tmp_path, jax_run):
    """validate on the same weights and utterances as JAX's validate, both at
    zero noise and without the PPG jitter (JAX's infer_fn the composition of
    test_synthesizer_infer_matches_jax): each utterance padded to the
    dataset's longest, cropped to min(t * hop, audio), and the mean mel L1."""
    hp_j, g_model, _, saved = jax_run
    rng = np.random.default_rng(6)
    params = jax.tree.map(
        lambda a: a + (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        saved[2][1].params)
    hp = _loop_hp(tmp_path)
    g, _ = _states(hp)
    g.model.load_state_dict(from_jax_trn_params(params), strict=True)
    infer = g.model.infer
    g.model.infer = lambda *a, generator=None: infer(*a, noise_scale=0.0, perturb=False)

    def compose(m, ppg, vec, pit, spk, ppg_l):
        z_p, _, _, mask, _ = m.enc_p(ppg, ppg_l, vec, j_f0_to_coarse(pit), noise_scale=0.0)
        z, _ = m.flow(z_p, mask, g=spk, reverse=True)
        return m.dec(spk, z * mask, f0_frames=pit)

    def infer_fn(p, ppg, vec, pit, spk, lens, key):
        return g_model.apply({"params": p}, ppg, vec, pit, spk, lens, method=compose,
                             rngs={"noise": key})

    ds = SvcDataset(hp.data.validation_files, hp.data)
    jds = jdataset.SvcDataset(hp.data.validation_files, hp_j.data)
    assert len(ds) == len(jds) > 1 and len(set(ds.lengths)) > 1
    mel = loop_mod.validate(hp, g.model, ds, None, step=0)
    ref = jloop.validate(hp_j, infer_fn, params, jds, None, 0)
    assert np.isfinite(ref) and mel == pytest.approx(ref, rel=0, abs=PIPELINE_ATOL)


def test_train_needs_cuda_unless_asked_for_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hp = _loop_hp(tmp_path)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            loop_mod.train(hp, "t", max_steps=1, device=device)
    assert not os.path.exists(hp.log.pth_dir)
