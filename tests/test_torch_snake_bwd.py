"""The snake's backward in the port (ops/snake_cuda.py) against the JAX
package: the plain backward and SnakeAliasFunction (its kernels swapped for
the plain versions, since a CUDA kernel cannot run on the CPU) against the
JAX Pallas backward kernel `snake_alias_cm_pallas_bwd` (interpret mode, as
tests/test_snake_fused.py runs it) and against jax.vjp of the JAX plain form,
at atol 3e-4 / rtol 2e-4 as tests/test_snake_fused.py:189 holds them. Also:
the kernel route records a graph only when a gradient is wanted, and the
generator's AMP blocks get gradients through it."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_vits_svc_tpu.nn import snake as jsnake
from whisper_vits_svc_tpu.ops.pallas_snake import snake_alias_cm_pallas_bwd
from whisper_vits_svc_tpu_torch.nn.amp import AMPBlock
from whisper_vits_svc_tpu_torch.ops import snake_cuda

SHAPES = [(1, 10, 700), (2, 16, 1024), (1, 3, 130), (2, 20, 4000)]
TOL = dict(atol=3e-4, rtol=2e-4)


def _inputs(shape):
    rng = np.random.default_rng(shape[1] * shape[2])
    b, c, t = shape
    x = (rng.standard_normal(shape) * 1.5).astype(np.float32)
    alpha = (rng.standard_normal(c) * 0.3).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.3).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, alpha, beta, dy


def _jax_vjp(x, alpha, beta, dy):
    _, vjp = jax.vjp(lambda *a: jsnake.snake_alias_fused_cm(*a, exact_edges=True),
                     jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta))
    return vjp(jnp.asarray(dy))


def _plain_kernels(monkeypatch):
    """Stand the plain versions in for the two CUDA kernels, counting calls."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(x, alpha, beta):
        calls["fwd"] += 1
        with torch.no_grad():
            return snake_cuda.snake_alias_fused_cm(x, alpha, beta)

    def bwd(x, alpha, beta, dy):
        calls["bwd"] += 1
        return snake_cuda.snake_alias_bwd_plain(x, alpha, beta, dy)

    monkeypatch.setattr(snake_cuda, "snake_alias_cuda", fwd)
    monkeypatch.setattr(snake_cuda, "snake_alias_bwd_cuda", bwd)
    return calls


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_pallas_kernel(shape):
    x, alpha, beta, dy = _inputs(shape)
    ref = snake_alias_cm_pallas_bwd(jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta),
                                    jnp.asarray(dy), interpret=True)
    got = snake_cuda.snake_alias_bwd_plain(*(torch.from_numpy(a) for a in (x, alpha, beta, dy)))
    for name, g, r in zip(("dx", "dalpha", "dbeta"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_function_backward_matches_jax_vjp(shape, monkeypatch):
    """SnakeAliasFunction's gradients (x, alpha, beta all requiring grad)
    against jax.vjp of the JAX plain form; one forward and one backward
    kernel call each."""
    calls = _plain_kernels(monkeypatch)
    x, alpha, beta, dy = _inputs(shape)
    xt, at, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, alpha, beta))
    y = snake_cuda.SnakeAliasFunction.apply(xt, at, bt)
    y.backward(torch.from_numpy(dy))
    assert calls == {"fwd": 1, "bwd": 1}
    for name, g, r in zip(("dx", "dalpha", "dbeta"), (xt.grad, at.grad, bt.grad),
                          _jax_vjp(x, alpha, beta, dy)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **TOL)


def test_kernel_route_records_a_graph_only_when_asked(monkeypatch):
    """Under no_grad / inference_mode the route is one forward launch with no
    graph (inference keeps its 91 launches per chunk); with grads wanted it
    goes through SnakeAliasFunction."""
    calls = _plain_kernels(monkeypatch)
    x, alpha, beta, _ = _inputs((1, 4, 64))
    xt, at, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, alpha, beta))
    with torch.inference_mode():
        assert snake_cuda.snake_alias_kernel(xt, at, bt).grad_fn is None
    with torch.no_grad():
        assert snake_cuda.snake_alias_kernel(xt, at, bt).grad_fn is None
    assert snake_cuda.snake_alias_kernel(xt.detach(), at.detach(), bt.detach()).grad_fn is None
    y = snake_cuda.snake_alias_kernel(xt, at, bt)
    assert type(y.grad_fn).__name__ == "SnakeAliasFunctionBackward"
    assert calls == {"fwd": 4, "bwd": 0}


def test_amp_block_gets_gradients_through_the_kernel_route(monkeypatch):
    """The card's path through an AMP block (SnakeAlias -> conv -> SnakeAlias
    -> conv, residual) gives every parameter, the snakes' alpha and beta and
    the convs inside included, the gradient of the plain path."""
    torch.manual_seed(0)
    block = AMPBlock(6, 3, (1, 3))
    block.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for act in block.activations:
            act.act.alpha.normal_(0.0, 0.3)
            act.act.beta.normal_(0.0, 0.3)
    x = torch.randn(2, 6, 150)
    w = torch.randn(2, 6, 150)

    def grads():
        block.zero_grad()
        (block(x) * w).sum().backward()
        return {n: p.grad.clone() for n, p in block.named_parameters()}

    plain = grads()
    calls = _plain_kernels(monkeypatch)
    monkeypatch.setattr(snake_cuda, "snake_alias", snake_cuda.snake_alias_kernel)
    routed = grads()
    assert calls == {"fwd": 4, "bwd": 4}
    for n, g in plain.items():
        assert g.abs().max() > 0, n
        torch.testing.assert_close(routed[n], g, atol=1e-5, rtol=1e-5, msg=n)


def test_backward_entry_refuses_cpu_tensor():
    x, alpha, beta, dy = (torch.from_numpy(a) for a in _inputs((1, 4, 64)))
    before = snake_cuda.launches_bwd
    with pytest.raises(ValueError, match="CUDA tensor"):
        snake_cuda.snake_alias_bwd_cuda(x, alpha, beta, dy)
    assert snake_cuda.launches_bwd == before == 0
