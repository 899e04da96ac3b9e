"""The fused AMP dilation iteration in the port (ops/amp_cuda.py, nn/amp.py)
against the JAX package: `amp_iter_ref` against the JAX `amp_iter_ref` and
against the Pallas kernel `pallas_amp.amp_iter` (interpret mode, as
tests/test_snake_fused.py runs it), and `AMPBlock(fused_iter=True)` against the
JAX `AMPBlock(layout="NCT", pallas_fused_iter=True)`, all at atol 2e-5 /
rtol 1e-5 as tests/test_snake_fused.py:242 holds the kernel (f32 sums taken
in another order). The CUDA kernel cannot run on the CPU: the card's route is
tested with a plain stand-in in its place, for the gate and the launch
counting."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_vits_svc_tpu.nn.amp import AMPBlock as JAMPBlock
from whisper_vits_svc_tpu.ops import pallas_amp
from whisper_vits_svc_tpu_torch.models import convert
from whisper_vits_svc_tpu_torch.models.generator import Generator
from whisper_vits_svc_tpu_torch.nn.amp import AMPBlock
from whisper_vits_svc_tpu_torch.ops import amp_cuda, snake_cuda

CASES = [(1, 10, 1280, 3, 1), (2, 16, 1024, 7, 3), (1, 12, 2560, 11, 5)]
TOL = dict(atol=2e-5, rtol=1e-5)


def _inputs(case):
    """x and the JAX-layout arguments ((K, I, O) kernels), from a numpy seed."""
    b, c, t, k, d = case
    rng = np.random.default_rng(c * t + k)
    f32 = np.float32
    x = rng.standard_normal((b, c, t)).astype(f32)
    k1, k2 = ((rng.standard_normal((k, c, c)) * 0.1).astype(f32) for _ in range(2))
    b1, b2 = ((rng.standard_normal(c) * 0.1).astype(f32) for _ in range(2))
    a1, be1, a2, be2 = ((rng.standard_normal(c) * 0.3).astype(f32) for _ in range(4))
    return x, (k1, b1, a1, be1, k2, b2, a2, be2)


def _port_args(jargs):
    """(K, I, O) kernels -> torch's (O, I, K); everything to tensors."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a.transpose(2, 1, 0)) if a.ndim == 3
                                  else a) for a in jargs)


@pytest.mark.parametrize("against", ["jnp_ref", "pallas_kernel"])
@pytest.mark.parametrize("case", CASES)
def test_amp_iter_ref_matches_jax(case, against):
    x, jargs = _inputs(case)
    k, d = case[3:]
    jx = [jnp.asarray(a) for a in (x, *jargs)]
    if against == "jnp_ref":
        ref = pallas_amp.amp_iter_ref(*jx, k, d)
    else:
        ref = pallas_amp.amp_iter(*jx, k, d, interpret=True)
    got = amp_cuda.amp_iter_ref(torch.from_numpy(x), *_port_args(jargs), k, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_amp_iter_cpu_takes_the_plain_version_and_differentiates():
    x, jargs = _inputs((1, 4, 96, 3, 3))
    args = _port_args(jargs)
    xt = torch.from_numpy(x).requires_grad_(True)
    before = amp_cuda.launches
    y = amp_cuda.amp_iter(xt, *args, 3, 3)
    torch.testing.assert_close(y, amp_cuda.amp_iter_ref(xt, *args, 3, 3))
    y.sum().backward()
    assert xt.grad.abs().max() > 0
    assert amp_cuda.launches == before == 0


@pytest.fixture
def jax_block(monkeypatch):
    """A JAX NCT AMP block's params (snake alpha/beta perturbed off their
    zero init), its unfused output and its fused output (gate lifted as
    tests/test_snake_fused.py:253 lifts it; the kernel in interpret mode)."""
    monkeypatch.setattr(pallas_amp, "use_fused_iter", lambda c, t, b=1: True)
    rng = np.random.default_rng(5)
    c, t = 12, 1280
    x = rng.standard_normal((1, c, t)).astype(np.float32)
    block = JAMPBlock(c, 3, (1, 3), layout="NCT")
    fused = JAMPBlock(c, 3, (1, 3), layout="NCT", pallas_fused_iter=True)
    params = block.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(
        lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    y_ref = np.asarray(block.apply({"params": params}, jnp.asarray(x)))
    y_fused = np.asarray(fused.apply({"params": params}, jnp.asarray(x)))
    return x, params, y_ref, y_fused


def _port_block(params, **kwargs):
    block = AMPBlock(12, 3, (1, 3), **kwargs)
    sd = {}
    convert.amp_block(sd, "b", params)
    block.load_state_dict({k.removeprefix("b."): v for k, v in sd.items()}, strict=True)
    return block.eval()


def test_amp_block_fused_matches_jax_and_unfused(jax_block):
    """The same state_dict in both forms of the port's block; the fused form
    against the JAX fused block and the port's own unfused block."""
    x, params, y_ref, y_fused = jax_block
    fused, plain = _port_block(params, fused_iter=True), _port_block(params)
    assert list(fused.state_dict()) == list(plain.state_dict())
    with torch.no_grad():
        got = fused(torch.from_numpy(x)).numpy()
        own = plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, y_fused, **TOL)
    np.testing.assert_allclose(got, y_ref, **TOL)
    np.testing.assert_allclose(got, own, **TOL)


def test_amp_iter_args_from_jax_equal_the_blocks_own_fold(jax_block):
    """convert.amp_iter_args_from_jax gives, per iteration, the arguments the
    port's block forms from its state_dict (the kernels folded), which are
    the folded kernels `amp_iter` got in JAX."""
    x, params, _, y_fused = jax_block
    block = _port_block(params, fused_iter=True)
    h = torch.from_numpy(x)
    for j, d in enumerate((1, 3)):
        args = convert.amp_iter_args_from_jax(params, j)
        c1, c2 = block.convs1[j], block.convs2[j]
        act1, act2 = block.activations[2 * j].act, block.activations[2 * j + 1].act
        own = (c1.kernel(), c1.bias, act1.alpha, act1.beta,
               c2.kernel(), c2.bias, act2.alpha, act2.beta)
        for a, o in zip(args, own):
            torch.testing.assert_close(a, o.detach(), atol=1e-6, rtol=1e-6)
        h = amp_cuda.amp_iter_ref(h, *args, 3, d)
    np.testing.assert_allclose(h.numpy(), y_fused, **TOL)


def _stand_in(monkeypatch):
    """Route CPU tensors through the card's route, the plain versions
    standing in for the CUDA kernels, counting calls."""
    calls = {"amp": 0, "direct": 0, "strips": 0, "mma": 0}

    def amp(*args, **kwargs):
        calls["amp"] += 1
        return amp_cuda.amp_iter_ref(*args, **kwargs)

    def snake(name):
        def fn(x, alpha, beta):
            calls[name] += 1
            return snake_cuda.snake_alias_fused_cm(x, alpha, beta)
        return fn

    monkeypatch.setattr(amp_cuda, "amp_iter_cuda", amp)
    monkeypatch.setattr(amp_cuda, "amp_iter", amp_cuda.amp_iter_kernel)
    monkeypatch.setattr(snake_cuda, "snake_alias_cuda", snake("direct"))
    monkeypatch.setattr(snake_cuda, "snake_alias_strips_cuda", snake("strips"))
    monkeypatch.setattr(snake_cuda, "snake_alias_mma_cuda", snake("mma"))
    monkeypatch.setattr(snake_cuda, "snake_alias", snake_cuda.snake_alias_kernel)
    return calls


def _base_width_generator(**kwargs):
    """The base config's generator widths (320 -> 160, 80, 40, 20, 10
    channels, 3 x 3 iterations a stage) behind a narrow input."""
    gen = Generator(upsample_input=8, spk_dim=4, **kwargs)
    gen.init_weights(torch.Generator().manual_seed(0))
    return gen.eval()


@pytest.mark.parametrize("config,expected", [
    (dict(), dict(amp=0, direct=91, strips=0, mma=0)),
    (dict(amp_fused_iter=True), dict(amp=18, direct=55, strips=0, mma=0)),
    (dict(snake_variant="strips"), dict(amp=0, direct=54, strips=37, mma=0)),
    (dict(snake_variant="mma"), dict(amp=0, direct=0, strips=0, mma=91)),
])
def test_generator_launches_per_chunk_at_base_widths(config, expected, monkeypatch):
    """Launches of one generator call at the base config's channel widths
    through the card's route: the fused iteration takes the C <= 32 stages
    (2 x 9 iterations in place of 36 snakes), strips takes the narrow, long
    shapes (the same two stages and activation_post; the length gate is
    scaled down to this test's 2 frames), mma takes every snake. Each
    configuration gives the default's audio."""
    monkeypatch.setattr(snake_cuda, "STRIPS_MIN_BT", 300)  # T = 320 and 640 at C = 20, 10
    rng = np.random.default_rng(7)
    spk = torch.from_numpy(rng.standard_normal((1, 4)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((1, 2, 8)).astype(np.float32))
    har = torch.from_numpy((rng.standard_normal((1, 640, 1)) * 0.1).astype(np.float32))
    with torch.inference_mode():
        want = _base_width_generator()(spk, z, har_source=har)
        calls = _stand_in(monkeypatch)
        got = _base_width_generator(**config)(spk, z, har_source=har)
    assert calls == expected
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_kernel_route_is_forward_only(monkeypatch):
    """Where autograd would record a graph the kernel route raises (the JAX
    package has no backward for its kernel either), and launches nothing."""
    calls = _stand_in(monkeypatch)
    x, jargs = _inputs((1, 4, 96, 3, 1))
    args = _port_args(jargs)
    with pytest.raises(RuntimeError, match="forward only"):
        amp_cuda.amp_iter(torch.from_numpy(x).requires_grad_(True), *args, 3, 1)
    with pytest.raises(RuntimeError, match="forward only"):
        amp_cuda.amp_iter(torch.from_numpy(x), args[0].requires_grad_(True), *args[1:], 3, 1)
    assert calls["amp"] == 0
    with torch.no_grad():
        amp_cuda.amp_iter(torch.from_numpy(x), *args, 3, 1)
    assert calls["amp"] == 1


def test_cuda_entry_refuses_what_the_kernel_does_not_take():
    x, jargs = _inputs((1, 4, 96, 3, 1))
    args = _port_args(jargs)
    before = amp_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        amp_cuda.amp_iter_cuda(torch.from_numpy(x), *args, 3, 1)
    assert amp_cuda.launches == before == 0


@pytest.mark.parametrize("c,k,d", [(10, 3, 1), (20, 11, 5), (32, 11, 5), (32, 3, 1), (1, 7, 3)])
def test_amp_tile_fits_shared_memory(c, k, d):
    """The tile the wrapper picks keeps the kernel's shared memory (R1: x,
    then c1, f32; R2: s1, then s2, TF32 hi and lo as float2; C rows each;
    the staged weight fragments) inside a Hopper block's 227 KB, and two
    blocks inside an SM's 228 KB for C <= 20, at a long stage and at a short
    one."""
    for t in (163200, 3000):
        tile = amp_cuda.amp_tile(1, c, t, k, d)
        g = amp_cuda.amp_geometry(k, d, tile)
        frags = 16 * min(-(-k * c // 8), amp_cuda.MAX_STAGED_KSTEPS) * 32 * -(-c // 8)
        smem = c * (4 * g.lr1 + 8 * g.ls2) + frags
        assert tile % 8 == 0 and amp_cuda.MIN_TILE <= tile <= amp_cuda.MAX_TILE
        assert smem == g.smem_bytes(c, k) <= 232448
        if c <= 20:
            assert 2 * (smem + 1024) <= amp_cuda.SMEM_PER_SM
        assert g.r2 + 6 + g.r1 <= 36 and -g.s1_lo - g.e1 == g.r2 + 6 + g.r1
    assert amp_cuda.use_fused_iter(c, 1) and not amp_cuda.use_fused_iter(40, 81600)
