"""The training slice as a whole: the port's SynthesizerTrn, losses, gradients
and optimizer updates against the JAX package's on the same weights and
inputs (micro_hp, every stochastic node frozen: train=False, perturb=False,
noise_scale=0, slice_ids fixed), plus the step's update schedule and entry
points on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_vits_svc_tpu.models.synthesizer import slice_segments as j_slice_segments
from whisper_vits_svc_tpu.train import losses as jlosses
from whisper_vits_svc_tpu.train.step import _adamw as j_adamw
from whisper_vits_svc_tpu.train.step import build_models as j_build_models
from whisper_vits_svc_tpu.utils.testing import micro_hp, synthetic_batch
from whisper_vits_svc_tpu_torch.models.convert import from_jax_disc_params, from_jax_trn_params
from whisper_vits_svc_tpu_torch.train import step as tstep
from whisper_vits_svc_tpu_torch.utils.config import config_from_dict

B, T = 2, 20
SLICE_IDS = np.array([0, 3], np.int32)
FROZEN = dict(train=False, perturb=False, noise_scale=0.0)
LOSS_KEYS = ("loss_m", "loss_s", "score_loss", "feat_loss", "loss_k", "loss_r", "loss_i",
             "loss_g", "loss_d")


def _perturbed(params, seed):
    """Non-trivial values for zero-initialized leaves (snake alpha/beta, the
    flow's post conv)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        params)


@pytest.fixture(scope="module")
def micro():
    hp = micro_hp(batch_size=B)
    g_model, d_model = j_build_models(hp)
    batch = synthetic_batch(hp, np.random.default_rng(7), b=B, t=T)
    g_params = jax.jit(g_model.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        *(batch[k] for k in ("ppg", "vec", "pit", "spec", "spk", "ppg_l", "spec_l")),
    )["params"]
    d_params = jax.jit(d_model.init)(
        jax.random.PRNGKey(3), jnp.zeros((B, hp.data.segment_size, 1)))["params"]
    g_params, d_params = _perturbed(g_params, 0), _perturbed(d_params, 1)

    port_hp = config_from_dict(hp)
    g, d = tstep.build_models(port_hp)
    g.load_state_dict(from_jax_trn_params(g_params), strict=True)
    d.load_state_dict(from_jax_disc_params(d_params), strict=True)
    return dict(hp=hp, port_hp=port_hp, g_model=g_model, d_model=d_model, g_params=g_params,
                d_params=d_params, g=g, d=d, batch=batch)


def _jax_losses(m, g_params, d_params):
    """The JAX step's loss assembly (train/step.py:186-249) with every
    stochastic node frozen; returns (loss_g, loss_d, terms)."""
    hp, b = m["hp"], m["batch"]
    out = m["g_model"].apply(
        {"params": g_params},
        *(b[k] for k in ("ppg", "vec", "pit", "spec", "spk", "ppg_l", "spec_l")),
        perturb=False, train=False, noise_scale=0.0, slice_ids=jnp.asarray(SLICE_IDS),
        rngs={"noise": jax.random.PRNGKey(9), "dropout": jax.random.PRNGKey(9)})
    real = j_slice_segments(jnp.asarray(b["audio"]), out.ids_slice * hp.data.hop_length,
                            hp.data.segment_size)
    fake = out.fake_audio
    data_cfg = {k: hp.data[k] for k in ("filter_length", "mel_channels", "sampling_rate",
                                        "hop_length", "win_length", "mel_fmin", "mel_fmax")}
    res = [tuple(r) for r in hp.mrd.resolutions]
    mel = jlosses.mel_l1_loss(fake[..., 0], real[..., 0], data_cfg) * hp.train.c_mel
    sc, mag = jlosses.multi_resolution_stft_loss(fake[..., 0], real[..., 0], res)
    stft = (sc + mag) * hp.train.c_stft
    spk = jlosses.cosine_speaker_loss(jnp.asarray(b["spk"]), out.spk_preds)

    def split(outs):
        return ([([f[:B] for f in fm], s[:B]) for fm, s in outs],
                [([f[B:] for f in fm], s[B:]) for fm, s in outs])

    disc_fake, disc_real = split(m["d_model"].apply(
        {"params": jax.lax.stop_gradient(d_params)}, jnp.concatenate([fake, real], 0)))
    score = jlosses.generator_adversarial_loss(disc_fake)
    feat = jlosses.feature_matching_loss(disc_fake, disc_real)
    kl_f = jlosses.kl_loss(out.z_f, out.logs_q, out.m_p, out.logs_p, out.logdet_f,
                           out.spec_mask) * hp.train.c_kl
    kl_r = jlosses.kl_loss(out.z_r, out.logs_p, out.m_q, out.logs_q, out.logdet_r,
                           out.spec_mask) * hp.train.c_kl
    loss_g = score + feat + mel + stft + kl_f + kl_r * 0.5 + spk * 2.0
    df, dr = split(m["d_model"].apply(
        {"params": d_params}, jnp.concatenate([jax.lax.stop_gradient(fake), real], 0)))
    loss_d = jlosses.discriminator_adversarial_loss(df, dr)
    terms = dict(loss_m=mel, loss_s=stft, score_loss=score, feat_loss=feat, loss_k=kl_f,
                 loss_r=kl_r, loss_i=spk, loss_g=loss_g, loss_d=loss_d)
    return loss_g, loss_d, terms, out


@pytest.fixture(scope="module")
def jax_forward(micro):
    """(terms, TrainOutputs) of the JAX side, jitted once."""
    m = micro
    return jax.jit(lambda gp, dp: _jax_losses(m, gp, dp)[2:])(m["g_params"], m["d_params"])


@pytest.fixture(scope="module")
def jax_grads(micro):
    m = micro

    def lg(gp):
        return _jax_losses(m, gp, m["d_params"])[0]

    def ld(dp):
        return _jax_losses(m, m["g_params"], dp)[1]

    g_grads = jax.jit(jax.grad(lg))(m["g_params"])
    d_grads = jax.jit(jax.grad(ld))(m["d_params"])
    return g_grads, d_grads


@pytest.fixture(scope="module")
def port_grads(micro):
    m = micro
    return tstep.loss_and_grads(m["port_hp"], m["g"], m["d"], m["batch"],
                                slice_ids=torch.from_numpy(SLICE_IDS), **FROZEN)


def test_synthesizer_trn_outputs_match_jax(micro, jax_forward):
    """Every output of the frozen training forward: f32 on both sides,
    summed in other orders: atol 2e-5 / rtol 1e-5."""
    m = micro
    ref = jax_forward[1]
    b = {k: torch.from_numpy(v) for k, v in m["batch"].items()}
    with torch.no_grad():
        out = m["g"](b["ppg"], b["vec"], b["pit"], b["spec"], b["spk"], b["ppg_l"],
                     b["spec_l"], slice_ids=torch.from_numpy(SLICE_IDS), **FROZEN)
    assert np.abs(np.asarray(ref.fake_audio)).max() > 1e-3
    for name in ref._fields:
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=2e-5, rtol=1e-5, err_msg=name)


def test_loss_terms_match_jax(jax_forward, port_grads):
    """Each loss term and loss_d: rtol 1e-4 (the JAX step's MRD fmaps are in
    its folded layout, count-corrected, so the feature-matching means are
    summed in another order)."""
    ref = jax_forward[0]
    metrics = port_grads[2]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(metrics[k]), float(ref[k]), rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("which", ["g", "d"])
def test_gradients_match_jax(micro, jax_grads, port_grads, which):
    """d loss_g / d G params (D frozen) and d loss_d / d D params (fake
    detached) against jax.grad, per parameter:
    ||port - jax|| <= 1e-3 ||jax|| + 1e-6."""
    m = micro
    if which == "g":
        model, ref = m["g"], from_jax_trn_params(jax_grads[0])
        grads = port_grads[0]
    else:
        model, ref = m["d"], from_jax_disc_params(jax_grads[1])
        grads = port_grads[1]
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(ref)
    bad = []
    for name, got in zip(names, grads):
        want = ref[name].numpy()
        err = np.linalg.norm(got.numpy() - want)
        if not err <= 1e-3 * np.linalg.norm(want) + 1e-6:
            bad.append((name, err, np.linalg.norm(want)))
    assert not bad, bad[:10]
    if which == "g":  # the snake parameters are among those trained
        assert any("activations" in n and np.abs(g.numpy()).max() > 0
                   for n, g in zip(names, grads))


def _np_params(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def test_optimizer_updates_match_optax(micro):
    """One G update with accum_step=2 (MultiSteps: nothing moves on the first
    call, the mean of both gradients on the second) and one D update at
    lr / accum_step, against the JAX package's optax AdamW on the same
    gradients: atol 1e-6."""
    hp = micro["port_hp"]
    g_state, d_state = tstep.init_train_states(hp, seed=3, device="cpu")
    rng = np.random.default_rng(5)
    lr, accum = hp.train.learning_rate, hp.train.accum_step
    assert accum == 2

    import optax

    for state, tx, calls in (
            (g_state, optax.MultiSteps(j_adamw(lr, hp.train.betas, hp.train.eps),
                                       every_k_schedule=accum), 2),
            (d_state, j_adamw(lr / accum, hp.train.betas, hp.train.eps), 1)):
        params = _np_params(state.model)
        opt_state = tx.init(params)
        update = jax.jit(tx.update)
        for i in range(calls):
            grads = {n: (rng.standard_normal(p.shape) * 0.3).astype(np.float32)
                     for n, p in params.items()}
            stepped = state.apply_gradients(
                [torch.from_numpy(grads[n]) for n, _ in state.model.named_parameters()])
            updates, opt_state = update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            assert stepped == (i == calls - 1)
            for n, p in _np_params(state.model).items():
                np.testing.assert_allclose(p, np.asarray(params[n]), atol=1e-6, rtol=0,
                                           err_msg=n)


def test_train_step_updates_on_schedule(micro):
    """The step on the CPU with train-mode noise from a torch.Generator:
    finite metrics; D moves every step, G on every accum_step-th step only."""
    hp = micro["port_hp"]
    g_state, d_state = tstep.init_train_states(hp, seed=0, device="cpu")
    step = tstep.make_train_step(hp, g_state, d_state)
    gen = torch.Generator().manual_seed(0)
    g_prev, d_prev = _np_params(g_state.model), _np_params(d_state.model)
    for i in range(3):
        metrics = step(micro["batch"], gen)
        for k, v in metrics.items():
            assert np.isfinite(float(v)), k
        g_now, d_now = _np_params(g_state.model), _np_params(d_state.model)
        g_moved = [not np.array_equal(g_now[n], g_prev[n]) for n in g_now]
        assert all(g_moved) if i % 2 == 1 else not any(g_moved), i
        assert all(not np.array_equal(d_now[n], d_prev[n]) for n in d_now), i
        g_prev, d_prev = g_now, d_now


def test_set_learning_rate_and_clip():
    hp = micro_hp()
    hp.train["clip_grad_value"] = 1e-3
    port_hp = config_from_dict(hp)
    g_state, d_state = tstep.init_train_states(port_hp, seed=0, device="cpu")
    tstep.set_learning_rate(d_state, 0.0)
    assert all(gr["lr"] == 0.0 for gr in d_state.optimizer.param_groups)
    assert d_state.optimizer.param_groups[0]["lr"] == 0.0
    assert g_state.optimizer.param_groups[0]["lr"] == hp.train.learning_rate
    d_before = _np_params(d_state.model)
    step = tstep.make_train_step(port_hp, g_state, d_state)
    metrics = step(synthetic_batch(hp, np.random.default_rng(1), b=2, t=20),
                   torch.Generator().manual_seed(1))
    assert float(metrics["grad_norm_d"]) > 0
    for n, p in _np_params(d_state.model).items():  # lr 0: AdamW moves nothing
        np.testing.assert_array_equal(p, d_before[n])


def test_init_train_states_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hp = config_from_dict(micro_hp())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstep.init_train_states(hp)
    g_state, d_state = tstep.init_train_states(hp, device="cpu")
    assert next(g_state.model.parameters()).device.type == "cpu"
    assert d_state.optimizer.param_groups[0]["lr"] == pytest.approx(
        hp.train.learning_rate / hp.train.accum_step)


def test_chip_smoke_branch_replay():
    """chip_smoke.py's card-vs-CPU check makes the CPU take the branches
    the card took: every ReLU form, leaky ReLU and abs is recorded once and
    replayed in call order, and an input whose own branch differs follows
    the recorded one (and is counted)."""
    import importlib.util
    import os

    import torch.nn.functional as F

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    def ops(x):
        return [torch.relu(x), F.relu(x), torch.nn.ReLU()(x), F.leaky_relu(x, 0.2),
                torch.abs(x)]

    x = torch.tensor([-2.0, -1e-9, 1e-9, 3.0])
    with cs.branch_pattern() as recorded:
        ops(x)
    assert len(recorded["taken"]) == 5
    y = torch.tensor([-2.0, 1e-9, -1e-9, 3.0], requires_grad=True)  # two inputs cross zero
    with cs.branch_pattern(replay=recorded["taken"]) as replayed:
        outs = ops(y)
    assert replayed["flips"] == 10
    grads = [torch.autograd.grad(o.sum(), y)[0].tolist() for o in outs]
    assert grads[:3] == [[0.0, 0.0, 1.0, 1.0]] * 3
    assert grads[3] == pytest.approx([0.2, 0.2, 1.0, 1.0])
    assert grads[4] == [-1.0, -1.0, 1.0, 1.0]
    # the originals are back
    assert (torch.relu.__name__, F.leaky_relu.__name__, torch.abs.__name__) == (
        "relu", "leaky_relu", "abs")
