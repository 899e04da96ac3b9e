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
