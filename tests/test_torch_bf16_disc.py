"""The port's bfloat16 discriminator (hp.train.bf16_discriminator): against
its own float32 discriminator and against the JAX package's bfloat16 one with
the same parameters, and a training step with the flag on (float32
parameters, gradients and AdamW states)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_vits_svc_tpu.models.discriminator import Discriminator as JDiscriminator
from whisper_vits_svc_tpu.utils.testing import synthetic_batch, tiny_hp
from whisper_vits_svc_tpu_torch.models.convert import from_jax_disc_params
from whisper_vits_svc_tpu_torch.models.discriminator import Discriminator
from whisper_vits_svc_tpu_torch.train import step as tstep
from whisper_vits_svc_tpu_torch.utils.config import config_from_dict


@pytest.fixture(scope="module")
def pair():
    """tiny_hp's discriminator (2 MRD resolutions, 2 MPD periods, MSD) in
    both packages with the same JAX-initialised parameters, and an input."""
    hp = tiny_hp()
    kw = dict(mrd_resolutions=tuple(tuple(r) for r in hp.mrd.resolutions),
              mpd_periods=tuple(hp.mpd.periods))
    x = (np.random.default_rng(0).standard_normal((2, hp.data.segment_size, 1)) * 0.3
         ).astype(np.float32)
    params = jax.jit(JDiscriminator(**kw).init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    port = {}
    for dt in (None, torch.bfloat16):
        d = Discriminator(**kw, compute_dtype=dt).eval()
        d.load_state_dict(from_jax_disc_params(params), strict=True)
        port[dt] = d
    return kw, params, x, port


def _scores(out):
    return [np.asarray(s, np.float32) for _, s in out]


def test_bf16_discriminator_close_to_f32(pair):
    """The JAX package's check on the port: every score within 0.05 mean
    relative error of float32's; scores and feature maps come back float32
    and finite."""
    _, _, x, port = pair
    with torch.no_grad():
        o32 = port[None](torch.from_numpy(x))
        o16 = port[torch.bfloat16](torch.from_numpy(x))
    assert len(o16) == 2 + 2 + 1
    for (f32s, s32), (f16s, s16) in zip(o32, o16):
        assert s16.dtype == torch.float32
        rel = float((s32 - s16).abs().mean() / (s32.abs().mean() + 1e-8))
        assert rel < 0.05, rel
        for a, b in zip(f32s, f16s):
            assert b.dtype == torch.float32 and b.shape == a.shape
            assert torch.isfinite(b).all()


def test_bf16_discriminator_matches_jax_bf16(pair):
    """Against the JAX package's bf16 discriminator (same parameters): the
    port's bf16 scores no farther from JAX's than 1.15x JAX's own bf16 to
    f32 distance (mean abs over every score). The port rounds each
    convolution's output once, as cuDNN does, where XLA may round per tap,
    so the two bf16 results are not the same rounding; both stay near
    float32. The float32 pair agrees to 1e-4."""
    kw, params, x, port = pair
    j32, j16 = (_scores(jax.jit(JDiscriminator(**kw, compute_dtype=dt).apply)(
        {"params": params}, jnp.asarray(x))) for dt in (None, jnp.bfloat16))
    with torch.no_grad():
        p32 = _scores(port[None](torch.from_numpy(x)))
        p16 = _scores(port[torch.bfloat16](torch.from_numpy(x)))

    def dist(a, b):
        return float(np.mean(np.abs(np.concatenate([u.ravel() for u in a])
                                    - np.concatenate([v.ravel() for v in b]))))

    for a, b in zip(p32, j32):
        np.testing.assert_allclose(a, b, atol=1e-4)
    jax_bf16_err = dist(j16, j32)
    assert jax_bf16_err > 0
    assert dist(p16, j16) <= 1.15 * jax_bf16_err, (dist(p16, j16), jax_bf16_err)
    assert dist(p16, p32) <= 1.15 * jax_bf16_err, (dist(p16, p32), jax_bf16_err)


def test_train_step_with_bf16_discriminator():
    """init_train_states reads train.bf16_discriminator: the D convolutions
    run in bfloat16, while every parameter, gradient and AdamW state stays
    float32 and finite, and a step moves D."""
    from whisper_vits_svc_tpu.utils.testing import micro_hp

    hp = micro_hp(batch_size=2)
    hp.train.update(bf16_discriminator=True)
    hp = config_from_dict(hp)
    g_state, d_state = tstep.init_train_states(hp, seed=0, device="cpu")
    assert d_state.model.compute_dtype == torch.bfloat16
    batch = synthetic_batch(hp, np.random.default_rng(1), b=2, t=40)
    gen = torch.Generator().manual_seed(0)
    g_grads, d_grads, metrics = tstep.loss_and_grads(hp, g_state.model, d_state.model, batch,
                                                     gen)
    for grads, params in ((g_grads, g_state.params), (d_grads, d_state.params)):
        for g, p in zip(grads, params):
            assert g.dtype == p.dtype == torch.float32
            assert torch.isfinite(g).all()
    assert all(float(v.abs().sum()) > 0 for v in d_grads[:4])
    for k, v in metrics.items():
        assert v.dtype == torch.float32 and torch.isfinite(v), k
    before = [p.detach().clone() for p in d_state.params]
    step = tstep.make_train_step(hp, g_state, d_state)
    step(batch, torch.Generator().manual_seed(1))
    assert any(not torch.equal(a, b) for a, b in zip(before, d_state.params))
    for p in d_state.params:
        assert p.dtype == torch.float32
        st = d_state.optimizer.state[p]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
