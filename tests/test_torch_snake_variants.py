"""The snake's two alternative forward kernels in the port ("strips" and
"mma", ops/snake_cuda.py) against the JAX package's
`snake_alias_cm_pallas(strips=True)` and `(mxu=True)` in interpret mode, at
atol 2e-5 / rtol 1e-5 as tests/test_snake_fused.py:307 holds the strips form
(f32 FIR sums in another order). On the CPU every variant takes the plain
version; what can be held here of the CUDA kernels themselves is their
arithmetic scheme: the fold's segments, the banded FIR matrices and windows
of the mma kernel, and the 3xTF32 split that keeps its products at f32
accuracy. Also the slice as a whole: tiny `svc_infer` in each configuration
against the port's default and the JAX `svc_infer`."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from whisper_vits_svc_tpu.infer import pipeline as jpipeline
from whisper_vits_svc_tpu.infer.retrieval import DummyRetrieval as JDummyRetrieval
from whisper_vits_svc_tpu.ops.pallas_snake import snake_alias_cm_pallas
from whisper_vits_svc_tpu.utils.testing import micro_hp
from whisper_vits_svc_tpu_torch.infer import pipeline
from whisper_vits_svc_tpu_torch.infer.retrieval import DummyRetrieval
from whisper_vits_svc_tpu_torch.models.convert import from_jax_params
from whisper_vits_svc_tpu_torch.nn.snake import SnakeAlias, _polyphase_taps, snake_alias_fused_cm
from whisper_vits_svc_tpu_torch.ops import snake_cuda
from whisper_vits_svc_tpu_torch.utils.config import config_from_dict

# [1,10,1024], [2,20,1280] and the JAX strips test shapes (tests/test_snake_fused.py:297)
SHAPES = [(1, 10, 1024), (2, 20, 1280), (2, 10, 5120), (2, 20, 6400), (2, 6, 8192),
          (2, 10, 3200)]
TOL = dict(atol=2e-5, rtol=1e-5)


def _inputs(shape):
    rng = np.random.default_rng(shape[1] * shape[2])
    c = shape[1]
    return ((rng.standard_normal(shape) * 0.5).astype(np.float32),
            (rng.standard_normal(c) * 0.1).astype(np.float32),
            (rng.standard_normal(c) * 0.1).astype(np.float32))


@pytest.mark.parametrize("variant,jax_kw", [("strips", dict(strips=True)),
                                            ("mma", dict(mxu=True))])
@pytest.mark.parametrize("shape", SHAPES)
def test_variant_matches_pallas_kernel(shape, variant, jax_kw):
    x, alpha, beta = _inputs(shape)
    ref = snake_alias_cm_pallas(jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta),
                                interpret=True, **jax_kw)
    got = snake_cuda.snake_alias(torch.from_numpy(x), torch.from_numpy(alpha),
                                 torch.from_numpy(beta), variant=variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@given(c=st.integers(1, 200), t=st.integers(1, 2_000_000), b=st.integers(1, 16),
       slots=st.sampled_from([1, 8, 132 * 8, 4096]))
@settings(max_examples=300, deadline=None)
def test_strip_fold_segments_cover_the_row_once(c, t, b, slots):
    """Any C, T, B: the segments [s * seg, min((s + 1) * seg, T)) with
    seg = ceil(T / fold) are non-empty, disjoint and cover [0, T), and none
    is longer than two tiles."""
    fold = snake_cuda.strip_fold(c, t, b, slots=slots)
    seg = -(-t // fold)
    assert fold >= 1 and (fold - 1) * seg < t <= fold * seg
    bounds = [(s * seg, min((s + 1) * seg, t)) for s in range(fold)]
    assert bounds[0][0] == 0 and bounds[-1][1] == t
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b_[0] for a, b_ in zip(bounds, bounds[1:]))
    assert seg <= snake_cuda.STRIPS_MAX_SEG


def test_strip_fold_and_gate_at_base_width():
    """One 1020-frame chunk at base width: strips takes the C = 20 and
    C = 10 stages (narrow, long), in segments of about 3100 samples that
    fill the card's 1056 block slots once (52 x 20 and 105 x 10 blocks)."""
    stages = [(160, 5100), (80, 20400), (40, 81600), (20, 163200), (10, 326400)]
    assert [snake_cuda.use_strips(c, t) for c, t in stages] == [False, False, False, True, True]
    assert [snake_cuda.strip_fold(c, t) for c, t in stages[3:]] == [52, 105]
    assert snake_cuda.use_strips(10, 8000, 16) and not snake_cuda.use_strips(10, 8000, 2)


def test_tf32_round_keeps_ten_mantissa_bits():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 3)
    r = snake_cuda.tf32_round(a)
    assert int((r.view(torch.int32) & 0x1FFF).abs().max()) == 0
    # nearest: within half a TF32 ulp (2^-11 relative)
    assert float(((r - a).abs() / a.abs()).max()) <= 2.0 ** -11
    hi, lo = snake_cuda.tf32_split(a)
    assert float(((hi + lo - a).abs() / a.abs()).max()) <= 2.0 ** -21


def _windows(x, start, n_windows, width):
    """rows x[start + 16 w : start + 16 w + width] of a 1-D tensor."""
    idx = start + 16 * torch.arange(n_windows)[:, None] + torch.arange(width)[None, :]
    return x[idx]


def test_3xtf32_banded_fir_reproduces_the_f32_product():
    """The scheme the mma kernel relies on, in plain torch: both operands
    masked to TF32, three products (lo x hi, hi x lo, hi x hi) summed in f32,
    reproduce the f32 banded down-FIR product to 2e-6, where one TF32 product
    does not (about 1e-3)."""
    rng = np.random.default_rng(1)
    e, o = (torch.from_numpy((rng.standard_normal(16 * 64 + 24) * 1.5).astype(np.float32))
            for _ in range(2))
    a = torch.cat([_windows(e, 0, 64, 24), _windows(o, 0, 64, 24)], dim=1)  # [64, K = 48]
    b_dn = torch.from_numpy(snake_cuda.down_fir_matrix())
    want = (a.double() @ b_dn.double()).float()
    a_hi, a_lo = snake_cuda.tf32_split(a)
    b_hi, b_lo = snake_cuda.tf32_split(b_dn)
    one = a_hi @ b_hi
    three = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
    assert float((three - want).abs().max()) <= 2e-6
    assert float((one - want).abs().max()) > 1e-4


def test_mma_windows_and_matrices_give_the_plain_version():
    """The mma kernel's data flow in plain torch (f64): the direct kernel's
    warp segments (`snake_plan`), the phases at the 256 positions s - 3 ..
    s + 252 of a segment (clamps against global positions), then a 16 x 16
    output tile per segment, row r the outputs s + 16 r + j, from E and O
    windows of 24 from s - 3 + 16 r side by side (K = 48, B_dn [48, 16]);
    outputs past the segment's 248 dropped. Equals snake_alias_fused_cm at
    ragged lengths, a start off 16-byte alignment included."""
    rng = np.random.default_rng(2)
    alpha, beta = torch.tensor([0.2], dtype=torch.float64), torch.tensor([-0.1], dtype=torch.float64)
    b_dn = torch.from_numpy(snake_cuda.down_fir_matrix()).double()
    a, ib = torch.exp(alpha), 1.0 / (torch.exp(beta) + 1e-9)

    def snake(u):
        return u + ib * torch.sin(u * a) ** 2

    ae, ao = (torch.from_numpy(np.asarray(v, np.float64)) for v in _polyphase_taps(12, 12)[:2])
    for t in (1031, 701, 5):  # rows 1 and 2 of T = 701 start off 16-byte alignment
        x = torch.from_numpy(rng.standard_normal((3, t)) * 1.5)
        want = snake_alias_fused_cm(x[None], alpha.expand(3), beta.expand(3))[0]
        plan = snake_cuda.snake_plan(1, 3, t, 4)
        out = torch.full((3, t), float("nan"), dtype=torch.float64)
        for w in range(plan.warps):
            row, s, lo, hi = plan.segment(w)
            clamp = lambda p: x[row][p.clamp(0, t - 1)]  # noqa: E731
            head = snake((ae * clamp(torch.arange(-3, 3))).sum())
            tail = snake((ao * clamp(torch.arange(t - 3, t + 3))).sum())
            pos = s - 3 + torch.arange(256 + 16)
            xs = clamp(pos[:, None] - 3 + torch.arange(7)[None, :])  # x[p - 3 .. p + 3]
            se, so = xs[:, :6] @ ae, xs[:, 1:] @ ao
            ph = [torch.where(pos < 0, head, torch.where(pos > t - 1, tail, snake(p)))
                  for p in (se, so)]
            ph = [torch.where(torch.arange(256 + 16) < 256, p, 0.0) for p in ph]  # zero pad
            win = torch.cat([_windows(ph[0], 0, 16, 24), _windows(ph[1], 0, 16, 24)], dim=1)
            y = (win @ b_dn).reshape(256)[: snake_cuda.SEG_LEN]
            q = s + torch.arange(snake_cuda.SEG_LEN)
            keep = (q >= lo) & (q < hi)
            out[row, q[keep]] = y[keep]
        torch.testing.assert_close(out, want, atol=1e-12, rtol=1e-12)


def test_variant_under_autograd_raises():
    """The alternatives are forward only, as in the JAX package (its custom
    VJP wraps the default form alone); "direct" differentiates."""
    x, alpha, beta = (torch.from_numpy(a) for a in _inputs((1, 4, 64)))
    for variant in ("strips", "mma"):
        with pytest.raises(RuntimeError, match="forward only"):
            snake_cuda.snake_alias(x.clone().requires_grad_(True), alpha, beta, variant=variant)
        with pytest.raises(RuntimeError, match="forward only"):
            SnakeAlias(4, variant)(x)  # the module's alpha and beta want a gradient
        with torch.no_grad():
            torch.testing.assert_close(SnakeAlias(4, variant)(x), SnakeAlias(4)(x))
    with pytest.raises(ValueError, match="variant must be one of"):
        snake_cuda.snake_alias(x, alpha, beta, variant="mxu")
    y = snake_cuda.snake_alias(x.clone().requires_grad_(True), alpha, beta)
    assert y.grad_fn is not None


def test_cuda_entries_refuse_cpu_tensors():
    x, alpha, beta = (torch.from_numpy(a) for a in _inputs((1, 4, 64)))
    for fn in (snake_cuda.snake_alias_strips_cuda, snake_cuda.snake_alias_mma_cuda):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(x, alpha, beta)
    assert snake_cuda.launches_strips == snake_cuda.launches_mma == 0


def test_build_covers_every_source():
    """`build` with no argument compiles every source under csrc/: the seven
    the package binds."""
    from whisper_vits_svc_tpu_torch.ops import amp_cuda, crepe_conv_cuda, cuda_build, viterbi_cuda

    names = sorted(p.name for p in cuda_build.all_sources())
    assert names == ["amp_iter.cu", "crepe_conv.cu", "snake_alias.cu", "snake_alias_bwd.cu",
                     "snake_alias_mma.cu", "snake_alias_strips.cu", "viterbi_trellis.cu"]
    bound = {snake_cuda.SOURCE, snake_cuda.SOURCE_BWD, snake_cuda.SOURCE_STRIPS,
             snake_cuda.SOURCE_MMA, amp_cuda.SOURCE, viterbi_cuda.SOURCE, crepe_conv_cuda.SOURCE}
    assert set(cuda_build.all_sources()) == bound


@pytest.fixture(scope="module")
def micro():
    """micro_hp's JAX infer graph with perturbed params, its svc_infer output
    at noise_scale=0, and the port's state_dict of the same weights."""
    hp = micro_hp()
    jmodel = jpipeline.build_infer_model(hp)
    t = 8
    params = jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, t, hp.vits.ppg_dim)), jnp.zeros((1, t, hp.vits.vec_dim)),
        jnp.full((1, t), 200.0), jnp.zeros((1, hp.vits.spk_dim)),
        jnp.full((1,), t, jnp.int32), jnp.zeros((1, t * hp.data.hop_length, 1)),
    )["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        params)
    frames = 90
    pit = rng.uniform(100, 400, frames).astype(np.float32)
    pit[20:31] = 0.0
    feats = (rng.standard_normal(hp.vits.spk_dim).astype(np.float32), pit,
             (rng.standard_normal((frames, hp.vits.ppg_dim)) * 0.5).astype(np.float32),
             (rng.standard_normal((frames, hp.vits.vec_dim)) * 0.5).astype(np.float32))
    kw = dict(noise_scale=0.0, out_chunk=30, hop_frame=4)
    ref = jpipeline.svc_infer(jmodel, params, JDummyRetrieval(), *feats, hp, **kw)
    return config_from_dict(hp), from_jax_params(params), feats, kw, np.asarray(ref)


@pytest.mark.parametrize("config", [dict(amp_fused_iter=True), dict(snake_variant="strips"),
                                    dict(snake_variant="mma")],
                         ids=["fused", "strips", "mma"])
def test_svc_infer_in_each_configuration(micro, config):
    """The slice as a whole at tiny width: each configuration loads the same
    state_dict, equals the port's default svc_infer (1e-5: the fused
    iteration folds each kernel once and sums in the same order) and the JAX
    svc_infer on the same params and features (1e-4 on a tanh waveform, as
    tests/test_torch_pipeline.py holds the default)."""
    hp, sd, feats, kw, ref = micro
    default = pipeline.build_infer_model(hp, device="cpu")
    default.load_state_dict(sd, strict=True)
    model = pipeline.build_infer_model(hp, device="cpu", **config)
    model.load_state_dict(sd, strict=True)
    want = pipeline.svc_infer(default, DummyRetrieval(), *feats, hp, device="cpu", **kw)
    got = pipeline.svc_infer(model, DummyRetrieval(), *feats, hp, device="cpu", **kw)
    assert got.shape == ref.shape and np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-4)
