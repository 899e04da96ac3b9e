"""The work plan of the snake forward and backward CUDA kernels
(ops/snake_cuda.py::snake_plan, csrc/snake_alias.cuh, csrc/snake_alias_bwd.cu),
held on the CPU, where the kernels cannot run.

- The plan's warp segments cover every output of every row exactly once, at
  every base-width stage shape of an inference chunk and of a training step
  and at odd shapes (T = 1, T < 12, T = 32 * RUN +- 1, odd T with B * C no
  multiple of the warps of a block, the JAX package's test shapes), for
  float32 and bfloat16 rows, and each segment starts 16-byte aligned.
- A numpy emulation of the kernels' bodies, lane by lane as the kernels
  run them (runs of RUN outputs, the 6 samples before a run and the phases
  after it from the neighbour lanes, the clamps from the phases of the warp,
  the backward's clamp sums from the staged dy through `clamp_taps`,
  dalpha/dbeta summed per warp and then per channel in slot order), equals
  the plain versions `snake_alias_fused_cm` and `snake_alias_bwd_plain`:
  forward at atol/rtol 2e-5 (f32 sums in another order), backward at atol
  3e-4 / rtol 2e-4 (as tests/test_torch_snake_bwd.py holds it), also at
  the large-argument case (|e^alpha u| ~ 1e3, ib ~ 20), where the up FIR
  must round each product and sum as the plain version does.
- The strips kernel's walk over the same body gives the direct kernel's
  outputs bit for bit, at any fold.
"""

import numpy as np
import pytest
import torch

from whisper_vits_svc_tpu_torch.nn.snake import _polyphase_taps, snake_alias_fused_cm
from whisper_vits_svc_tpu_torch.ops import snake_cuda
from whisper_vits_svc_tpu_torch.ops.snake_cuda import RUN, SEG_LEN

LANES = 32
F32 = np.float32
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
BWD_TOL = dict(atol=3e-4, rtol=2e-4)

# base width: one 1020-frame chunk (B = 1) and a training step (B = 16,
# 25-frame segments)
INFER_STAGES = [(1, 160, 5100), (1, 80, 20400), (1, 40, 81600), (1, 20, 163200),
                (1, 10, 326400)]
TRAIN_STAGES = [(16, 160, 125), (16, 80, 500), (16, 40, 2000), (16, 20, 4000), (16, 10, 8000)]
# T = 1, T < 12, T = 32 * RUN +- 1, T = SEG_LEN - 1 (rows whose aligned
# start needs a second segment), odd T with B * C no multiple of WARPS,
# chip_smoke's ODD_SHAPES and the JAX package's backward test shapes
ODD_SHAPES = [(1, 1, 1), (2, 3, 1), (1, 5, 5), (3, 3, 11), (1, 3, 32 * RUN - 1),
              (1, 3, 32 * RUN + 1), (2, 3, SEG_LEN - 1), (3, 5, 131), (1, 7, 997),
              (1, 8, 130), (1, 80, 20401),
              (2, 16, 1024), (1, 10, 700), (1, 3, 130), (2, 20, 4000)]


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", INFER_STAGES + TRAIN_STAGES + ODD_SHAPES)
def test_plan_covers_every_output_once(shape, itemsize):
    b, c, t = shape
    plan = snake_cuda.snake_plan(b, c, t, itemsize)
    assert plan.rows == b * c and plan.vec == 16 // itemsize
    hits = np.zeros(b * c * t, np.int32)
    for w in range(plan.warps):
        row, s, lo, hi = plan.segment(w)
        assert (row * t + s) % plan.vec == 0  # 16-byte aligned start
        assert -plan.vec < s <= lo and hi <= s + SEG_LEN  # lanes 0..30 hold [s, s + SEG_LEN)
        if lo < hi:
            hits[row * t + lo: row * t + hi] += 1
    assert (hits == 1).all()


def _shfl_up(v):
    """Each lane's value from lane - 1 (lane 0 keeps its own), axis -2 lanes."""
    return np.concatenate([v[..., :1, :], v[..., :-1, :]], axis=-2)


def _shfl_down(v):
    """Each lane's value from lane + 1 (lane 31 keeps its own)."""
    return np.concatenate([v[..., 1:, :], v[..., -1:, :]], axis=-2)


def _stage(rows, row_idx, q0, t, zero):
    """xe[w, lane, i] = row[q0 - 6 + i], i < RUN + 6, as `stage_run` builds it:
    own run, then the 6 before it from the lane below (lane 0 loads them)."""
    def load(pos):
        if zero:
            inside = (pos >= 0) & (pos < t)
            return np.where(inside, rows[row_idx[..., None], np.clip(pos, 0, t - 1)], F32(0))
        return rows[row_idx[..., None], np.clip(pos, 0, t - 1)]

    own = load(q0[..., None] + np.arange(RUN))
    halo = _shfl_up(own[..., RUN - 6:])
    halo[:, 0] = load(q0[:, :1, None] - 6 + np.arange(6))[:, 0]
    return np.concatenate([halo, own], axis=-1)


def _fir(taps, ext, first, sign=1):
    """sum_m taps[m] * ext[..., first + sign * m], accumulated in the kernel's
    order, float32."""
    acc = F32(taps[0]) * ext[..., first]
    for m in range(1, 6):
        acc = acc + F32(taps[m]) * ext[..., first + sign * m]
    return acc


def _segments(plan, strips_fold=None):
    """(row, s, lo, hi) per warp: the direct kernel's plan, or the strips
    kernel's walk of each fold segment in warp segments."""
    if strips_fold is None:
        return [plan.segment(w) for w in range(plan.warps)]
    t, seg_len = plan.t, -(-plan.t // strips_fold)
    out = []
    for row in range(plan.rows):
        for f in range(strips_fold):
            seg_lo, seg_hi = min(f * seg_len, t), min((f + 1) * seg_len, t)
            base = seg_lo - (row * t + seg_lo) % plan.vec
            for s in range(base, seg_hi, SEG_LEN):
                out.append((row, s, max(s, seg_lo), min(s + SEG_LEN, seg_hi)))
    return out


def _exp(v):
    """e^v in float32 as torch computes it: the kernels' expf and sinf and
    the plain version's torch.exp and torch.sin agree on the card, and a
    one-ulp difference of e^alpha moves sin(e^alpha u) by ulp * |e^alpha u|."""
    return torch.exp(torch.from_numpy(np.asarray(v, F32))).numpy()


def _sin(v):
    return torch.sin(torch.from_numpy(np.asarray(v, F32))).numpy()


def _cos(v):
    return torch.cos(torch.from_numpy(np.asarray(v, F32))).numpy()


def emulate_forward(x, alpha, beta, itemsize=4, strips_fold=None):
    """snake_segment over the plan in numpy float32; x [B, C, T] float32."""
    b, c, t = x.shape
    ae, ao, _, _, de, do_, _, _ = _polyphase_taps(12, 12)
    plan = snake_cuda.snake_plan(b, c, t, itemsize)
    segs = np.array(_segments(plan, strips_fold))
    row_idx, s, lo, hi = (segs[:, i] for i in range(4))
    rows = x.reshape(b * c, t).astype(F32)
    a = _exp(alpha)[row_idx % c][:, None]
    ib = (F32(1) / (_exp(beta) + F32(1e-9)))[row_idx % c][:, None]
    q0 = s[:, None] + RUN * np.arange(LANES)  # [W, lanes]
    xe = _stage(rows, np.broadcast_to(row_idx[:, None], q0.shape), q0, t, zero=False)

    def snake(u):
        return u + ib * np.square(_sin(u * a))

    ph_e = np.stack([snake(_fir(ae, xe, j)) for j in range(RUN)], axis=-1)
    ph_o = np.stack([snake(_fir(ao, xe, j + 1)) for j in range(RUN)], axis=-1)
    p = q0[..., None] - 3 + np.arange(RUN)
    # clamps from the lane holding position 0 / T-1 of the same warp
    for w in range(len(segs)):
        if (p[w] == 0).any():
            head = ph_e[w][p[w] == 0][0]
            ph_e[w][p[w] < 0] = ph_o[w][p[w] < 0] = head
        if (p[w] == t - 1).any():
            tail = ph_o[w][p[w] == t - 1][0]
            ph_e[w][p[w] > t - 1] = ph_o[w][p[w] > t - 1] = tail
    e = np.concatenate([ph_e, _shfl_down(ph_e[..., :6])], axis=-1)
    o = np.concatenate([ph_o, _shfl_down(ph_o[..., :5])], axis=-1)
    y = np.zeros((len(segs), LANES, RUN), F32)
    for i in range(RUN):
        acc = F32(de[0]) * e[..., i + 1] + F32(do_[0]) * o[..., i]
        for m in range(1, 6):
            acc = acc + F32(de[m]) * e[..., i + 1 + m]
            acc = acc + F32(do_[m]) * o[..., i + m]
        y[..., i] = acc
    out = np.full(b * c * t, np.nan, F32)
    pos = q0[..., None] + np.arange(RUN)
    live = (np.arange(LANES)[None, :, None] < LANES - 1) & (pos >= lo[:, None, None]) \
        & (pos < hi[:, None, None])
    flat = (row_idx[:, None, None] * t + pos)[live]
    assert len(np.unique(flat)) == len(flat) == b * c * t  # each output once
    out[flat] = y[live]
    return out.reshape(b, c, t)


def _warp_sum(v):
    """The xor shuffle tree over the lanes (axis -1)."""
    lanes = np.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ off]
    return v


def emulate_backward(x, alpha, beta, dy, itemsize=4):
    """snake_alias_bwd_kernel over the plan in numpy float32."""
    b, c, t = x.shape
    ae, ao, _, _, de, do_, _, _ = _polyphase_taps(12, 12)
    k = snake_cuda.clamp_taps()
    plan = snake_cuda.snake_plan(b, c, t, itemsize)
    segs = np.array(_segments(plan))
    row_idx, s, lo, hi = (segs[:, i] for i in range(4))
    a_c = _exp(alpha)
    eb_c = _exp(beta)
    ib_c = F32(1) / (eb_c + F32(1e-9))
    a, ib = a_c[row_idx % c][:, None], ib_c[row_idx % c][:, None]
    q0 = s[:, None] + RUN * np.arange(LANES)
    rix = np.broadcast_to(row_idx[:, None], q0.shape)
    xe = _stage(x.reshape(b * c, t).astype(F32), rix, q0, t, zero=False)
    ye = _stage(dy.reshape(b * c, t).astype(F32), rix, q0, t, zero=True)
    du_e = np.zeros((len(segs), LANES, RUN), F32)
    du_o = np.zeros_like(du_e)
    sum_a = np.zeros((len(segs), LANES), F32)
    sum_b = np.zeros_like(sum_a)
    for j in range(RUN):
        p = q0 - 3 + j
        ue, uo = _fir(ae, xe, j), _fir(ao, xe, j + 1)
        dse, dso = _fir(de, ye, j + 5, sign=-1), _fir(do_, ye, j + 6, sign=-1)
        head = (F32(k["hd"][0]) * ye[..., j + 3] + F32(k["hd"][1]) * ye[..., j + 4]
                + F32(k["hd"][2]) * ye[..., j + 5])
        tail = (F32(k["td"][0]) * ye[..., j + 1] + F32(k["td"][1]) * ye[..., j + 2]
                + F32(k["td"][2]) * ye[..., j + 3])
        dse = np.where(p == 0, dse + head, dse)
        dso = np.where(p == t - 1, dso + tail, dso)
        sne, cse, sno, cso = _sin(a * ue), _cos(a * ue), _sin(a * uo), _cos(a * uo)
        sqe, sqo = sne * sne, sno * sno
        s2e, s2o = F32(2) * sne * cse, F32(2) * sno * cso
        live = (p >= 0) & (p < t)
        du_e[..., j] = np.where(live, dse * (F32(1) + ib * a * s2e), F32(0))
        du_o[..., j] = np.where(live, dso * (F32(1) + ib * a * s2o), F32(0))
        own = live & (p >= s[:, None]) & (p < s[:, None] + SEG_LEN)
        sum_a = sum_a + np.where(own, dse * ue * s2e + dso * uo * s2o, F32(0))
        sum_b = sum_b + np.where(own, dse * sqe + dso * sqo, F32(0))
    e = np.concatenate([du_e, _shfl_down(du_e[..., :6])], axis=-1)
    o = np.concatenate([du_o, _shfl_down(du_o[..., :5])], axis=-1)
    dx = np.full(b * c * t, np.nan, F32)
    pos = q0[..., None] + np.arange(RUN)
    for i in range(RUN):
        acc = F32(ae[0]) * e[..., i + 6] + F32(ao[0]) * o[..., i + 5]
        for m in range(1, 6):
            acc = acc + F32(ae[m]) * e[..., i + 6 - m]
            acc = acc + F32(ao[m]) * o[..., i + 5 - m]
        head = sum(F32(k["hxe"][n]) * e[..., i + 3 + n] + F32(k["hxo"][n]) * o[..., i + 3 + n]
                   for n in range(3))
        tail = sum(F32(k["txe"][n]) * e[..., i + 1 + n] + F32(k["txo"][n]) * o[..., i + 1 + n]
                   for n in range(3))
        acc = np.where(pos[..., i] == 0, acc + head, acc)
        acc = np.where(pos[..., i] == t - 1, acc + tail, acc)
        live = (np.arange(LANES) < LANES - 1) & (pos[..., i] >= lo[:, None]) \
            & (pos[..., i] < hi[:, None])
        dx[(row_idx[:, None] * t + pos[..., i])[live]] = acc[live]
    assert not np.isnan(dx).any()
    # dalpha/dbeta: warp slots, then per channel the slots (b, segment) in order
    slots_a, slots_b = _warp_sum(sum_a)[:, 0], _warp_sum(sum_b)[:, 0]
    dalpha, dbeta = np.zeros(c, F32), np.zeros(c, F32)
    per_channel = b * plan.n_seg
    for ch in range(c):
        order = [(bb * c + ch) * plan.n_seg + seg for bb in range(b) for seg in range(plan.n_seg)]
        lanes_a, lanes_b = np.zeros(LANES, F32), np.zeros(LANES, F32)
        for i in range(per_channel):
            lanes_a[i % LANES] += slots_a[order[i]]
            lanes_b[i % LANES] += slots_b[order[i]]
        ta, tb = _warp_sum(lanes_a)[0], _warp_sum(lanes_b)[0]
        dalpha[ch] = a_c[ch] * ib_c[ch] * ta
        dbeta[ch] = -eb_c[ch] * ib_c[ch] * ib_c[ch] * tb
    return dx.reshape(b, c, t), dalpha, dbeta


def _inputs(shape, large=False, seed=0):
    """x, alpha, beta, dy. `large`: the large-argument case, x * 100 with
    e^alpha in [1.6, 4.5] and beta down to -3 (ib up to ~20), so that
    |e^alpha u| reaches ~1e3, as chip_smoke.py makes it."""
    rng = np.random.default_rng(seed + shape[1] * shape[2])
    b, c, t = shape
    if large:
        return ((rng.standard_normal(shape) * 100).astype(F32),
                (1.0 + rng.uniform(-0.5, 0.5, c)).astype(F32),
                rng.uniform(-3.0, 0.0, c).astype(F32),
                rng.standard_normal(shape).astype(F32))
    return ((rng.standard_normal(shape) * 1.5).astype(F32),
            (rng.standard_normal(c) * 0.3).astype(F32),
            (rng.standard_normal(c) * 0.3).astype(F32),
            rng.standard_normal(shape).astype(F32))


# small widths and the corner shapes, and the large-argument case at two
EMULATE_SHAPES = [(1, 1, 1), (2, 3, 1), (1, 5, 5), (3, 3, 11), (1, 3, 32 * RUN - 1),
                  (1, 3, 32 * RUN + 1), (2, 3, SEG_LEN - 1), (3, 5, 131), (2, 4, 125), (1, 3, 130), (1, 10, 700),
                  (2, 16, 1024), (1, 2, 1500)]
CASES = [(shape, False) for shape in EMULATE_SHAPES] + [((2, 3, 400), True),
                                                         ((4, 8, 2000), True)]


def _plain(fn, *arrays):
    """A plain version in float32 on the CPU, as chip_smoke.py runs it on the
    card: the emulation's sin argument then equals the plain version's."""
    out = fn(*(torch.from_numpy(v) for v in arrays))
    return [o.numpy() for o in out] if isinstance(out, tuple) else out.numpy()


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32-plan", "bf16-plan"])
@pytest.mark.parametrize("shape,large", CASES)
def test_forward_emulation_matches_plain(shape, large, itemsize):
    x, alpha, beta, _ = _inputs(shape, large)
    want = _plain(snake_alias_fused_cm, x, alpha, beta)
    got = emulate_forward(x, alpha, beta, itemsize)
    np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize("shape,large", CASES)
def test_backward_emulation_matches_plain(shape, large):
    x, alpha, beta, dy = _inputs(shape, large)
    want = _plain(snake_cuda.snake_alias_bwd_plain, x, alpha, beta, dy)
    got = emulate_backward(x, alpha, beta, dy)
    for name, g, w in zip(("dx", "dalpha", "dbeta"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **BWD_TOL)


@pytest.mark.parametrize("fold", [1, 3, 7])
@pytest.mark.parametrize("shape", [(1, 3, 131), (2, 4, 1500), (1, 2, 32 * RUN + 1)])
def test_strips_walk_equals_direct_bitwise(shape, fold):
    x, alpha, beta, _ = _inputs(shape)
    direct = emulate_forward(x, alpha, beta)
    strips = emulate_forward(x, alpha, beta, strips_fold=min(fold, shape[2]))
    assert np.array_equal(direct, strips)


def test_clamp_taps_equal_the_edge_sums():
    """clamp_taps' weights of the values next to each edge give the sums
    they stand for: sum_{q<0} dE[q] + dO[q] and sum_{q>T-1} of the same, and
    sum_{q<0} dxp[q], sum_{q>T-1} dxp[q], for dy and du zero outside [0, T)."""
    ae, ao, _, _, de, do_, _, _ = (np.asarray(v, np.float64) if isinstance(v, np.ndarray)
                                   else v for v in _polyphase_taps(12, 12))
    k = snake_cuda.clamp_taps()
    rng = np.random.default_rng(3)
    t = 9
    dy, du_e, du_o = (rng.standard_normal(t) for _ in range(3))

    def at(v, p):
        return v[p] if 0 <= p < t else 0.0

    def dsum(q):
        return sum(de[m] * at(dy, q + 2 - m) + do_[m] * at(dy, q + 3 - m) for m in range(6))

    def dxp(q):
        return sum(ae[m] * at(du_e, q + 3 - m) + ao[m] * at(du_o, q + 2 - m) for m in range(6))

    np.testing.assert_allclose(k["hd"] @ dy[:3], sum(dsum(q) for q in (-3, -2, -1)), rtol=1e-6)
    np.testing.assert_allclose(k["td"] @ dy[t - 3:], sum(dsum(q) for q in (t, t + 1, t + 2)),
                               rtol=1e-6)
    np.testing.assert_allclose(k["hxe"] @ du_e[:3] + k["hxo"] @ du_o[:3],
                               sum(dxp(q) for q in (-3, -2, -1)), rtol=1e-6)
    np.testing.assert_allclose(k["txe"] @ du_e[t - 3:] + k["txo"] @ du_o[t - 3:],
                               sum(dxp(q) for q in (t, t + 1, t + 2)), rtol=1e-6)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel entries launch or raise; the plain versions are taken only
    by `snake_alias` for CPU tensors."""
    x, alpha, beta, dy = (torch.from_numpy(v) for v in _inputs((1, 4, 64)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        snake_cuda.snake_alias_cuda(x, alpha, beta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        snake_cuda.snake_alias_bwd_cuda(x, alpha, beta, dy)
    assert snake_cuda.launches == snake_cuda.launches_bwd == 0
