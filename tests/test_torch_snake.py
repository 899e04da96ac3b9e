"""The port's snake (nn/snake.py, ops/snake_cuda.py) against the JAX package.

The plain PyTorch version is held to the JAX Pallas kernel
`snake_alias_cm_pallas` (interpret mode off-TPU, as tests/test_snake_fused.py
runs it) and to the JAX plain form `snake_alias_fused_cm`, at atol 5e-6 /
rtol 1e-5: both sides compute the same f32 shifted-add FIRs, so only the
sin/exp implementations and summation rounding differ.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_vits_svc_tpu.nn import snake as jsnake
from whisper_vits_svc_tpu.ops.pallas_snake import snake_alias_cm_pallas
from whisper_vits_svc_tpu_torch.nn import snake as tsnake
from whisper_vits_svc_tpu_torch.ops import snake_cuda


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    b, c, t = shape
    x = (rng.standard_normal(shape) * 1.5).astype(np.float32)
    alpha = (rng.standard_normal(c) * 0.3).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.3).astype(np.float32)
    return x, alpha, beta


def _port(x, alpha, beta, **kw):
    return tsnake.snake_alias_fused_cm(torch.from_numpy(x), torch.from_numpy(alpha),
                                       torch.from_numpy(beta), **kw).numpy()


def test_polyphase_taps_match_jax():
    ours, ref = tsnake._polyphase_taps(12, 12), jsnake._polyphase_taps(12, 12)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for size in (12, 11):
        np.testing.assert_array_equal(tsnake.kaiser_sinc_filter1d(0.25, 0.3, size),
                                      jsnake.kaiser_sinc_filter1d(0.25, 0.3, size))


@pytest.mark.parametrize("shape", [(1, 10, 700), (2, 16, 1024), (1, 3, 130), (2, 20, 4000)])
def test_plain_snake_matches_pallas_kernel(shape):
    x, alpha, beta = _inputs(2, shape)
    ref = np.asarray(snake_alias_cm_pallas(jnp.asarray(x), jnp.asarray(alpha),
                                           jnp.asarray(beta)))
    np.testing.assert_allclose(_port(x, alpha, beta), ref, atol=5e-6, rtol=1e-5)


@pytest.mark.parametrize("shape", [(1, 10, 700), (2, 16, 1024), (1, 3, 130), (2, 20, 4000)])
@pytest.mark.parametrize("exact_edges", [True, False])
def test_plain_snake_matches_jax_plain(shape, exact_edges):
    x, alpha, beta = _inputs(3, shape)
    ref = np.asarray(jsnake.snake_alias_fused_cm(
        jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta), exact_edges=exact_edges))
    np.testing.assert_allclose(_port(x, alpha, beta, exact_edges=exact_edges), ref,
                               atol=5e-6, rtol=1e-5)


def test_wrapper_takes_plain_path_on_cpu():
    x, alpha, beta = _inputs(4, (1, 6, 300))
    before = snake_cuda.launches
    out = snake_cuda.snake_alias(torch.from_numpy(x), torch.from_numpy(alpha),
                                 torch.from_numpy(beta))
    assert snake_cuda.launches == before == 0
    np.testing.assert_array_equal(out.numpy(), _port(x, alpha, beta))


def test_kernel_entry_refuses_cpu_tensor():
    x, alpha, beta = _inputs(5, (1, 4, 64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        snake_cuda.snake_alias_cuda(torch.from_numpy(x), torch.from_numpy(alpha),
                                    torch.from_numpy(beta))
    assert snake_cuda.launches == 0


@pytest.mark.parametrize("ratio,kernel_size", [(2, None), (3, None), (2, 13)])
def test_resamplers_match_jax(ratio, kernel_size):
    """upsample1d / downsample1d on [B, T, C] against the JAX package's: the
    same Kaiser sinc taps as a depthwise convolution in float32, summed in
    another order: 1e-6 on inputs of order 1.5."""
    x, _, _ = _inputs(11, (2, 37, 5))
    for port, ref in ((tsnake.upsample1d, jsnake.upsample1d),
                      (tsnake.downsample1d, jsnake.downsample1d)):
        got = port(torch.from_numpy(x), ratio, kernel_size).numpy()
        want = np.asarray(ref(jnp.asarray(x), ratio, kernel_size))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("exact_edges", [True, False])
def test_snake_alias_fused_matches_jax_and_the_chain(exact_edges):
    """snake_alias_fused on [B, T, C] against the JAX package's (5e-6, as the
    channel-major form above) and, with exact edges, against
    downsample1d(SnakeBeta(upsample1d(x))) (the unfused chain, 5e-6)."""
    x, alpha, beta = _inputs(12, (2, 5, 41))
    x = np.ascontiguousarray(x.transpose(0, 2, 1))  # [B, T, C]
    args = [torch.from_numpy(a) for a in (x, alpha, beta)]
    got = tsnake.snake_alias_fused(*args, exact_edges=exact_edges)
    want = jsnake.snake_alias_fused(*(jnp.asarray(a) for a in (x, alpha, beta)),
                                    exact_edges=exact_edges)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=5e-6)
    if exact_edges:
        u = tsnake.upsample1d(args[0])
        s = u + torch.sin(u * args[1].exp()).square() / (args[2].exp() + 1e-9)
        np.testing.assert_allclose(got.numpy(), tsnake.downsample1d(s).numpy(),
                                   rtol=1e-5, atol=5e-6)
