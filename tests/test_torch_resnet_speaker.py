"""The port's ResNetSpeakerEncoder (the reference's H/ASP SE-ResNet d-vector,
which nothing in either package calls) against the JAX package's at
layers=(1, 1, 1, 1): JAX-initialised and perturbed weights carried to the
port by `models/convert.py::from_jax_resnet_speaker`, the same mel from a
numpy seed, within 1e-5; unit norm under l2_norm."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_vits_svc_tpu.models.speaker_encoder import ResNetSpeakerEncoder as JResNet
from whisper_vits_svc_tpu_torch.models.convert import from_jax_resnet_speaker
from whisper_vits_svc_tpu_torch.models.speaker_encoder import ResNetSpeakerEncoder


def _perturbed(tree, seed: int, scale: float):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + (scale * rng.standard_normal(np.shape(a))).astype(np.float32),
        tree)


@pytest.fixture(scope="module")
def mel():
    return np.random.default_rng(1234).standard_normal((2, 40, 64)).astype(np.float32)


@pytest.mark.parametrize("encoder_type,log_input", [("ASP", False), ("SAP", True)])
def test_resnet_speaker_encoder_matches_jax(mel, encoder_type, log_input):
    x = np.abs(mel) + 0.1 if log_input else mel
    jm = JResNet(layers=(1, 1, 1, 1), encoder_type=encoder_type, log_input=log_input)
    params = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"],
                        1, 0.05)
    pm = ResNetSpeakerEncoder(layers=(1, 1, 1, 1), encoder_type=encoder_type,
                              log_input=log_input).eval()
    pm.load_state_dict(from_jax_resnet_speaker(params), strict=True)
    apply = jax.jit(jm.apply, static_argnames="l2_norm")
    with torch.no_grad():
        for l2 in (False, True):
            want = np.asarray(apply({"params": params}, jnp.asarray(x), l2_norm=l2))
            got = pm(torch.from_numpy(x), l2_norm=l2).numpy()
            assert got.shape == want.shape == (2, 512)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            if l2:
                np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


def test_resnet_published_widths_shapes():
    """layers (3, 4, 6, 3) and 64 mels: the reference's state_dict layout
    (downsample only where the stride or the width changes) and a [B, 512]
    d-vector."""
    pm = ResNetSpeakerEncoder().eval()
    sd = pm.state_dict()
    assert sum(1 for k in sd if k.endswith("downsample.0.weight")) == 3
    assert "layer1.0.downsample.0.weight" not in sd and "layer2.0.downsample.0.weight" in sd
    assert sd["attention.0.weight"].shape == (128, 256 * 8, 1)
    assert sd["fc.weight"].shape == (512, 2 * 256 * 8)
    with torch.no_grad():
        out = pm(torch.randn(1, 50, 64, generator=torch.Generator().manual_seed(0)))
    assert out.shape == (1, 512) and torch.isfinite(out).all()
