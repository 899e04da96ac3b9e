"""MelspecDiscriminator (the 48 kHz mel discriminator, unwired) against the
JAX class with the same numpy-seeded weights and input, at the shape of
tests/test_aux_components.py::test_med_discriminator_shapes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_vits_svc_tpu.models.discriminator import MelspecDiscriminator as JMed
from whisper_vits_svc_tpu_torch.models import convert
from whisper_vits_svc_tpu_torch.models.discriminator import Discriminator, MelspecDiscriminator


@pytest.fixture(scope="module")
def med():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 48000, 1)) * 0.2).astype(np.float32)
    jm = JMed()
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    init_out = jax.jit(lambda p, a: jm.apply({"params": p}, a))(params, x)
    # every leaf perturbed: the BatchNorm scale and bias leave 1 and 0
    perturbed = jax.tree.map(
        lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    out = jax.jit(lambda p, a: jm.apply({"params": p}, a))(perturbed, x)
    return x, params, init_out, perturbed, out


def _port(params) -> MelspecDiscriminator:
    m = MelspecDiscriminator().eval()
    m.load_state_dict(convert.from_jax_med(params), strict=True)
    return m


def _compare(ref, out):
    """Feature maps NHWC (JAX) against NCHW (port). The STFT, the mel
    product and four convolutions in float32, summed in other orders: each
    map within 2e-5 of its largest entry (measured 5.4e-6 on the deepest,
    whose entries reach 34), the scores within 1e-5."""
    (jf, js), = ref
    (pf, ps), = out
    assert len(pf) == len(jf) == 4 and ps.shape == (2,)
    for a, b in zip(jf, pf):
        a, b = np.asarray(a), b.numpy().transpose(0, 2, 3, 1)
        assert a.shape == b.shape and b.shape[-1] == 32
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-5 * np.abs(a).max())
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=0, atol=1e-5)


def test_med_matches_jax(med):
    x, _, _, perturbed, ref = med
    with torch.no_grad():
        out = _port(perturbed)(torch.from_numpy(x))
    assert all(np.isfinite(f.numpy()).all() for f in out[0][0])
    _compare(ref, out)


def test_med_init_weights_is_jax_init(med):
    """At the JAX initializers' values the eval-mode BatchNorm is the identity
    map the JAX package's scale 1, bias 0 give; init_weights sets the same
    running statistics (mean 0, var 1 - eps)."""
    x, params, init_ref, _, _ = med
    with torch.no_grad():
        out = _port(params)(torch.from_numpy(x))
    _compare(init_ref, out)
    fresh = MelspecDiscriminator()
    fresh.init_weights(torch.Generator().manual_seed(0))
    for i in range(4):
        bn = fresh._convs[i][1]
        assert torch.equal(bn.running_mean, torch.zeros(64))
        assert torch.equal(bn.running_var, torch.full((64,), 1.0 - bn.eps))
        assert torch.equal(bn.weight, torch.ones(64)) and torch.equal(bn.bias, torch.zeros(64))


def test_med_keys_and_unwired():
    """The reference's keys (a Sequential of conv, BatchNorm2d and GLU per
    layer, then `_postnet`), the mel basis kept out of the state_dict, and no
    MelspecDiscriminator inside the composite Discriminator."""
    sd = MelspecDiscriminator().state_dict()
    assert "_convs.0.0.weight" in sd and "_convs.0.0.bias" not in sd
    assert {"_convs.3.1.running_var", "_postnet.weight", "_postnet.bias"} <= set(sd)
    assert not any("mel" in k for k in sd)
    assert sd["_convs.0.0.weight"].shape == (64, 1, 7, 7)
    assert sd["_convs.1.0.weight"].shape == (64, 32, 4, 4)
    assert sd["_postnet.weight"].shape == (1, 32, 15, 3)
    d = Discriminator(mrd_resolutions=((64, 16, 64),), mpd_periods=(2,))
    assert not any(isinstance(m, MelspecDiscriminator) for m in d.modules())
