"""The work plans of the two tensor-core kernels, held on the CPU, where the
kernels cannot run: the mma snake (csrc/snake_alias_mma.cu) and the fused
AMP iteration (csrc/amp_iter.cu), through emulations in plain torch written
from the kernels' index arithmetic.

- mma snake: the warp segments of `snake_plan` cover every output of every
  row once (at the chunk's five stage shapes and odd shapes; its 16 x 16
  output tile keeps exactly the segment's 248); split-once 3xTF32 through
  the new windows equals `snake_alias_fused_cm` at the f32 tolerance, also
  at large arguments, where a 3xTF32 up FIR would not (why the up FIRs stay
  on the CUDA cores, bitwise the plain version's).
- fused AMP iteration: `amp_tile` / `amp_geometry` give tiles that cover
  [0, T) once for every base-width (C, k, d) and the odd cases, fit two
  blocks an SM, and whose stage ranges hold what each stage reads; a tile
  by tile emulation (stage ranges, index offsets, edge clamps, 3xTF32 channel
  mixes with K = k C packed in k-steps of 8, truncating f32 accumulation per
  mma, each group of 3 k-steps summed on its own) equals `amp_iter_ref` at atol 2e-5 / rtol 1e-5, for float32 and
  bfloat16 inputs and K = k C up to 352.
"""

import math

import numpy as np
import pytest
import torch

from whisper_vits_svc_tpu_torch.nn.snake import _polyphase_taps, snake_alias_fused_cm
from whisper_vits_svc_tpu_torch.ops import amp_cuda, snake_cuda

F32_TOL = dict(atol=2e-5, rtol=2e-5)
AMP_F32_TOL = dict(atol=2e-5, rtol=1e-5)
SEG = snake_cuda.SEG_LEN
CHUNK_STAGES = [(1, 160, 5100), (1, 80, 20400), (1, 40, 81600), (1, 20, 163200),
                (1, 10, 326400)]
ODD_SHAPES = [(1, 1, 1), (1, 5, 5), (1, 3, SEG - 1), (3, 5, 131), (1, 8, 130), (1, 80, 20401),
              (2, 16, 1024)]
BASE_KD = [(k, d) for k in (3, 7, 11) for d in (1, 3, 5)]
AMP_ODD_CASES = [(1, 10, 1280, 3, 1), (2, 16, 1024, 7, 3), (1, 12, 2560, 11, 5),
                 (1, 10, 1279, 7, 3), (1, 10, 30, 11, 5), (1, 10, 1, 11, 5),
                 (2, 32, 3000, 11, 5)]


# --- the mma snake ---------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", CHUNK_STAGES + ODD_SHAPES)
def test_mma_tiles_cover_every_output_once(shape, itemsize):
    """Each segment's 16 x 16 tile (row r: outputs s + 16 r + j) keeps the
    outputs of [lo, hi) among its first 248; over the plan every output of
    every row is kept exactly once."""
    b, c, t = shape
    plan = snake_cuda.snake_plan(b, c, t, itemsize)
    hits = np.zeros(b * c * t, np.int32)
    q_tile = (16 * np.arange(16)[:, None] + np.arange(16)[None, :]).ravel()
    kept_tile = q_tile[q_tile < SEG]
    assert sorted(kept_tile) == list(range(SEG))
    for w in range(plan.warps):
        row, s, lo, hi = plan.segment(w)
        q = s + kept_tile
        q = q[(q >= lo) & (q < hi)]
        np.add.at(hits, row * t + q, 1)
    assert (hits == 1).all()


def _snake_params(large):
    if large:  # chip_smoke's large arguments: e^alpha up to 4.5, 1 / e^beta up to 20
        return torch.tensor([0.5, 1.5], dtype=torch.float32), torch.tensor([-3.0, -1.0])
    return torch.tensor([0.2, -0.3]), torch.tensor([-0.1, 0.25])


def _mma_emulation(x, alpha, beta, up_3xtf32=False):
    """The mma kernel on float32 rows x [2, T] (channel = row): per segment
    the phases at s - 3 .. s + 252 (the up FIR unfused in the plain
    version's order, or as 3xTF32 products), split once, the down FIR as a
    3xTF32 product of the [16, 48] windows with B_dn, f32 accumulation."""
    ae, ao, _, _, de, do_, _, _ = _polyphase_taps(12, 12)
    ae, ao = (torch.tensor(np.asarray(v, np.float32)) for v in (ae, ao))
    b_hi, b_lo = snake_cuda.tf32_split(torch.from_numpy(snake_cuda.down_fir_matrix()))
    c, t = x.shape
    out = torch.empty_like(x)
    plan = snake_cuda.snake_plan(1, c, t, 4)
    pos = torch.arange(-3, 253)
    for w in range(plan.warps):
        row, s, lo, hi = plan.segment(w)
        xr = x[row]
        a = torch.exp(alpha[row])
        ib = 1.0 / (torch.exp(beta[row]) + 1e-9)

        def at(p):
            return xr[p.clamp(0, t - 1)]

        def up(p, taps, off):
            if up_3xtf32:
                win = torch.stack([at(p + off + m) for m in range(6)], dim=1)
                w_hi, w_lo = snake_cuda.tf32_split(win)
                t_hi, t_lo = snake_cuda.tf32_split(taps)
                return ((w_lo.double() @ t_hi.double() + w_hi.double() @ t_lo.double()
                         + w_hi.double() @ t_hi.double())).float()
            u = taps[0] * at(p + off)
            for m in range(1, 6):
                u = u + taps[m] * at(p + off + m)
            return u

        def snake(u):
            return u + ib * torch.square(torch.sin(u * a))

        p = s + pos
        e, o = snake(up(p, ae, -3)), snake(up(p, ao, -2))
        head = snake(up(torch.tensor([0]), ae, -3))[0]
        tail = snake(up(torch.tensor([t - 1]), ao, -2))[0]
        e = torch.where(p < 0, head, torch.where(p > t - 1, tail, e))
        o = torch.where(p < 0, head, torch.where(p > t - 1, tail, o))
        pad = torch.zeros(16)
        e, o = torch.cat([e, pad]), torch.cat([o, pad])
        idx = 16 * torch.arange(16)[:, None] + torch.arange(24)[None, :]
        a_hi, a_lo = snake_cuda.tf32_split(torch.cat([e[idx], o[idx]], dim=1))  # [16, 48]
        y = torch.zeros(16, 16)
        for part_a, part_b in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            y = (y.double() + part_a.double() @ part_b.double()).float()
        q = s + torch.arange(SEG)
        keep = (q >= lo) & (q < hi)
        out[row, q[keep]] = y.reshape(256)[:SEG][keep]
    return out


@pytest.mark.parametrize("large", [False, True], ids=["normal", "large_args"])
@pytest.mark.parametrize("t", [700, 1031])
def test_mma_split_once_3xtf32_matches_plain(t, large):
    rng = np.random.default_rng(t)
    x = torch.from_numpy((rng.standard_normal((2, t)) * (100.0 if large else 1.5))
                         .astype(np.float32))
    alpha, beta = _snake_params(large)
    want = snake_alias_fused_cm(x[None], alpha, beta)[0]
    got = _mma_emulation(x, alpha, beta)
    torch.testing.assert_close(got, want, **F32_TOL)


def test_mma_up_fir_in_3xtf32_misses_large_arguments():
    """Why the kernel keeps the up FIRs on the CUDA cores: at |e^alpha u| ~
    1e3 and 1 / e^beta ~ 20 a few ulp of u move the snake past the f32
    tolerance; the plain version's own order keeps u to the bit."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((2, 1031)) * 100.0).astype(np.float32))
    alpha, beta = _snake_params(True)
    want = snake_alias_fused_cm(x[None], alpha, beta)[0]
    got = _mma_emulation(x, alpha, beta, up_3xtf32=True)
    ratio = ((got - want).abs() / (F32_TOL["atol"] + F32_TOL["rtol"] * want.abs())).max()
    assert float(ratio) > 2.0


# --- the fused AMP iteration -----------------------------------------------

def _amp_cases():
    base = [(1, c, t, k, d) for c, t in ((20, 163200), (10, 326400)) for k, d in BASE_KD]
    return base + AMP_ODD_CASES


@pytest.mark.parametrize("case", _amp_cases())
def test_amp_tiles_cover_and_fit(case):
    """The tiles cover [0, T) once; two blocks fit an SM's shared memory
    wherever a base-width C of 20 or less is asked; the grid at the two long
    stages fills more than 95% of whole waves of 2 x 132 blocks; each stage's
    range holds what the next one reads, and each R1 row what a snake lane
    reads (up to its first output + 15, for outputs up to 5 past the stage)."""
    b, c, t, k, d = case
    tile = amp_cuda.amp_tile(b, c, t, k, d)
    g = amp_cuda.amp_geometry(k, d, tile)
    assert tile % 8 == 0 and 8 <= tile <= amp_cuda.MAX_TILE
    tiles = math.ceil(t / tile)
    assert tiles * tile >= t > (tiles - 1) * tile  # [0, T) once, no empty tile
    smem = g.smem_bytes(c, k)
    if c <= 20:
        assert amp_cuda.BLOCKS_PER_SM * (smem + 1024) <= amp_cuda.SMEM_PER_SM
    assert smem <= 232448
    if t >= 100_000:
        slots = 132 * amp_cuda.BLOCKS_PER_SM
        waves = math.ceil(b * tiles / slots)
        assert b * tiles / (waves * slots) > 0.95
    # s2 over [-r2, tile + r2); c1 over 6 more a side; s1 over r1 more
    assert g.s2_lo == -g.r2 and g.l2 == tile + 2 * g.r2 and g.lc == g.l2 + 12
    assert g.s1_lo % 8 == 0 and g.s1_lo + g.e1 == g.s2_lo - 6 - g.r1
    assert g.l1 == g.e1 + g.lc + 2 * g.r1
    # conv1 reads s1 up to index e1 + 16 ceil(lc / 16) - 1 + (k - 1) d
    assert g.ls2 >= g.e1 + 16 * math.ceil(g.lc / 16) + (k - 1) * d
    assert g.ls2 % 16 == 4 and g.lr1 % 32 == 8 and g.lr1 % 8 == 0
    last_lane = 8 * ((g.l1 + 5) // 8)
    assert g.lr1 >= last_lane + 16 and g.lr1 >= g.lc + 2
    # at base width each warp holds all its m-tiles at once (one round)
    if t >= 100_000:
        mtw = amp_cuda.MTW[-(-c // 8)]
        assert math.ceil(math.ceil(g.lc / 16) / 8) <= mtw and math.ceil(tile / 128) <= mtw
    assert amp_cuda.ksteps(c, k) * 8 >= k * c > (amp_cuda.ksteps(c, k) - 1) * 8


def _toward_zero(v):
    """float64 -> float32 rounded toward zero, as the tensor cores' f32
    accumulation rounds."""
    f = v.float()
    return torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _tf32_mix(w, s, k, step, n_out, flush=True):
    """sum_m W_m s[:, j + m step], j < n_out, as the kernel's mma chain: K
    = k C packed as kk = m C + i into k-steps of 8 (zero past k C); per
    k-step three products (lo x hi, hi x lo, hi x hi), each summed exactly
    and rounded toward zero into an f32 accumulator; with `flush` (the
    kernel) each group of KGROUP k-steps into fresh accumulators, added in
    f32."""
    c = w.shape[0]
    n_ks = amp_cuda.ksteps(c, k)
    a = torch.zeros(c, 8 * n_ks)
    b = torch.zeros(8 * n_ks, n_out)
    for m in range(k):
        a[:, m * c:(m + 1) * c] = w[:, :, m]
        b[m * c:(m + 1) * c] = s[:, m * step:m * step + n_out]
    a_hi, a_lo = snake_cuda.tf32_split(a)
    b_hi, b_lo = snake_cuda.tf32_split(b)
    acc = torch.zeros(c, n_out)
    for g0 in range(0, n_ks, amp_cuda.KGROUP):
        part = torch.zeros(c, n_out) if flush else acc
        for ks in range(g0, min(g0 + amp_cuda.KGROUP, n_ks)):
            kk = slice(8 * ks, 8 * ks + 8)
            for wa, sb in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                part = _toward_zero(part.double() + wa[:, kk].double() @ sb[kk].double())
        acc = acc + part if flush else part
    return acc


def _amp_emulation(x, params, k, d, flush=True):
    """The fused kernel tile by tile on x [B, C, T] (float32 math): x over
    the tile's range clamped; s1 over [s1_lo, s1_lo + l1) zero outside
    [0, T); c1 = b1 + the 3xTF32 mix of s1 read at index e1 + j + m d, then
    clamped to c1[0] / c1[T-1] outside [0, T); s2 over [s2_lo, s2_lo + l2)
    from c1 alone (a row that holds only the tile's c1); out = x + b2 + the
    mix of s2 read at index j + m."""
    k1, b1, a1, be1, k2, b2, a2, be2 = params
    bsz, c, t = x.shape
    tile = amp_cuda.amp_tile(bsz, c, t, k, d)
    g = amp_cuda.amp_geometry(k, d, tile)
    out = torch.empty_like(x)
    s1_full = snake_alias_fused_cm(x, a1, be1)  # every snake output is a function of x
    for bi in range(bsz):
        for t0 in range(0, t, tile):
            def positions(lo, n):
                return t0 + lo + torch.arange(n)

            def inside(p):
                return (p >= 0) & (p < t)

            p1 = positions(g.s1_lo, g.l1 + 8 * k * d)  # + what padded n-tiles read
            s1 = torch.where(inside(p1), s1_full[bi][:, p1.clamp(0, t - 1)], 0.0)
            c1 = b1[:, None] + _tf32_mix(k1, s1[:, g.e1:], k, d, 16 * math.ceil(g.lc / 16), flush)
            c1 = c1[:, : g.lc]
            pc = positions(g.s2_lo - 6, g.lc)
            row = torch.zeros(c, t)
            row[:, pc[inside(pc)]] = c1[:, inside(pc)]
            p2 = positions(g.s2_lo, g.l2 + 8)
            s2 = torch.where(inside(p2), snake_alias_fused_cm(row[None], a2, be2)[0][
                :, p2.clamp(0, t - 1)], 0.0)
            c2 = b2[:, None] + _tf32_mix(k2, s2, k, 1, tile, flush)
            n = min(tile, t - t0)
            out[bi, :, t0: t0 + n] = x[bi, :, t0: t0 + n] + c2[:, :n]
    return out


def _amp_inputs(case, scale=1.0, weight=0.1):
    b, c, t, k, d = case
    rng = np.random.default_rng(c * t + k)

    def r(*shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32))

    x = r(b, c, t, s=scale)
    params = (r(c, c, k, s=weight), r(c, s=0.1), r(c, s=0.3), r(c, s=0.3),
              r(c, c, k, s=weight), r(c, s=0.1), r(c, s=0.3), r(c, s=0.3))
    return x, params


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [(1, 20, 700, 11, 5), (1, 10, 900, 7, 3), (1, 20, 600, 3, 1),
                                  (2, 32, 300, 11, 5), (1, 10, 30, 11, 5), (1, 12, 1, 3, 3)])
def test_amp_tile_emulation_matches_plain(case, dtype):
    """K = k C up to 352 (C = 32, k = 11); T = 1 and T shorter than the
    halo; bfloat16 inputs are rounded first and computed in float32."""
    x, params = _amp_inputs(case)
    x = x.to(dtype).float()
    k, d = case[3:]
    want = amp_cuda.amp_iter_ref(x, *params, k, d)
    got = _amp_emulation(x, params, k, d)
    torch.testing.assert_close(got, want, **AMP_F32_TOL)


def test_amp_grouped_sums_hold_the_tolerance():
    """Why the kernel sums each group of 3 k-steps on its own: with one
    accumulator through all 3 K / 8 mma (K = 352 at C = 32, k = 11) the
    truncating accumulation misses the tolerance, as the first card run of
    the design did (5.9e-5 at [20, 163200], 8.4e-5 at C = 32)."""
    case = (1, 32, 600, 11, 5)
    x, params = _amp_inputs(case)
    want = amp_cuda.amp_iter_ref(x, *params, 11, 5)
    chained = _amp_emulation(x, params, 11, 5, flush=False)
    tol = AMP_F32_TOL["atol"] + AMP_F32_TOL["rtol"] * want.abs()
    assert float(((chained - want).abs() / tol).max()) > 1.0
    torch.testing.assert_close(_amp_emulation(x, params, 11, 5), want, **AMP_F32_TOL)


def test_amp_large_arguments():
    """chip_smoke's large-argument case: x * 100 sends |e^alpha x| to ~1e3
    in the first snake, with the mixes' weights at 1e-3 so that the second
    snake's argument stays ~10. With the main cases' weights (0.1) c1 reaches
    ~1e3 and the second snake is so ill-conditioned there that the plain
    version in float32 misses its own float64 value by several times the
    tolerance: no other order of the sums could hold to it."""
    case = (1, 20, 700, 11, 5)
    x, params = _amp_inputs(case, scale=100.0, weight=1e-3)
    want = amp_cuda.amp_iter_ref(x, *params, 11, 5)
    torch.testing.assert_close(_amp_emulation(x, params, 11, 5), want, **AMP_F32_TOL)

    x, params = _amp_inputs(case, scale=100.0)
    f32 = amp_cuda.amp_iter_ref(x, *params, 11, 5).double()
    f64 = amp_cuda.amp_iter_ref(x.double(), *(p.double() for p in params), 11, 5)
    tol = AMP_F32_TOL["atol"] + AMP_F32_TOL["rtol"] * f64.abs()
    assert float(((f32 - f64).abs() / tol).max()) > 2.0
