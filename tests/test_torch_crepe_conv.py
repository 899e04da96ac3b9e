"""CREPE's convolution layers in the port (ops/crepe_conv_cuda.py,
csrc/crepe_conv.cu): on the CPU the plain version is the forward as it was
before the kernel, bit for bit; the kernel's tile and split-K plan, mirrored
in numpy, covers every output exactly once and walks every stage of every
split once, for both capacities' six layers at 1, 50, 64 and 512 rows; the
kernel's index arithmetic (the stage loads, the strided layer as phase
channels, the split sums in slot order, the epilogue), emulated in float64,
is the float64 convolution; the serving artifact keeps the kernel's
operator, one node a layer; the CUDA entry refuses CPU tensors and counts
nothing, and the CPU forward launches nothing. The kernel itself is tested
where there is a card (marker `card`, skipped here)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from whisper_vits_svc_tpu_torch.models import crepe
from whisper_vits_svc_tpu_torch.ops import crepe_conv_cuda as cc

PADS = [(254, 254)] + [(31, 32)] * 5
# H100 SXM: 132 SMs; resident blocks an SM at each tile height (512 threads
# of 128 registers)
SMS, BLOCKS_PER_SM = 132, {32: 8, 64: 4, 128: 2}


def _model(capacity: str, seed: int = 0) -> crepe.Crepe:
    """A seeded CREPE with BatchNorm statistics away from their defaults."""
    torch.manual_seed(seed)
    model = crepe.Crepe(capacity).eval()
    with torch.no_grad():
        for i in range(1, 7):
            bn = getattr(model, f"conv{i}_BN")
            bn.running_mean.uniform_(-0.2, 0.2)
            bn.running_var.uniform_(0.5, 1.5)
            bn.weight.uniform_(0.8, 1.2)
            bn.bias.uniform_(-0.1, 0.1)
    return model


def _frames(rows: int, seed: int) -> torch.Tensor:
    """[rows, 1024] normalised frames of a noisy tone."""
    rng = np.random.default_rng(seed)
    t = np.arange(1024) / 16000
    f0 = rng.uniform(80, 800, (rows, 1))
    x = np.sin(2 * np.pi * f0 * t) + 0.1 * rng.standard_normal((rows, 1024))
    return crepe.normalize_frames(torch.from_numpy(x.astype(np.float32)))


def _previous_forward(model: crepe.Crepe, frames: torch.Tensor) -> torch.Tensor:
    """Crepe.forward as it was before the kernel: pad, Conv1d, ReLU, the
    folded BatchNorm, the pool, a layer at a time in PyTorch."""
    x = frames[:, None, :]
    for i in range(1, 7):
        conv, bn = getattr(model, f"conv{i}"), getattr(model, f"conv{i}_BN")
        x = F.pad(x, (254, 254) if i == 1 else (31, 32))
        x = F.relu(F.conv1d(x, conv.weight[..., 0], conv.bias, stride=conv.stride[0]))
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        bias = bn.bias - bn.running_mean * scale
        x = F.max_pool1d(x * scale[:, None] + bias[:, None], 2, 2)
    return torch.sigmoid(model.classifier(x.transpose(1, 2).reshape(len(x), model.in_features)))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().view(np.int32)


@pytest.mark.parametrize("rows", [1, 7, 64])
@pytest.mark.parametrize("capacity", ["tiny", "full"])
def test_cpu_forward_equals_the_previous_forward_bit_for_bit(capacity, rows):
    model = _model(capacity, seed=rows)
    frames = _frames(rows, seed=rows)
    with torch.inference_mode():
        np.testing.assert_array_equal(_bits(model(frames)), _bits(_previous_forward(model,
                                                                                    frames)))


def _layers(capacity: str) -> list[tuple[int, int, int, int, int, tuple[int, int]]]:
    """(length in, ci, co, k, stride, pad) of each layer."""
    out_ch, _ = crepe.CAPACITIES[capacity]
    layers, length, ci = [], 1024, 1
    for i, co in enumerate(out_ch):
        k, stride = (512, 4) if i == 0 else (64, 1)
        layers.append((length, ci, co, k, stride, PADS[i]))
        length = ((length + sum(PADS[i]) - k) // stride + 1) // 2
        ci = co
    return layers


def _thread_outputs(p: cc.Plan):
    """The epilogue's (row, position) of every (position tile, tx, j) and
    the channel offset of every (ty, i) within a channel tile, by the
    kernel's formulas; rows past n are the ones it skips."""
    tx = np.arange(16)[:, None] * 8 + np.arange(8)[None, :]  # [16, 8] positions in a tile
    r_thr = (tx // 8 * 8) // p.seg
    t_loc = tx - r_thr * p.seg
    g = np.arange(p.pos_tiles)[:, None, None] * p.rows_per_tile + r_thr[None]
    row = g // p.segs_per_row
    pos = (g - row * p.segs_per_row) * p.seg + t_loc[None]
    ty = np.arange(p.bm // 8)[:, None]
    co_off = ty + (p.bm // 8) * np.arange(8)[None, :]  # [bm / 8, 8]
    return row, pos, co_off


@pytest.mark.parametrize("rows", [1, 50, 64, 512])
@pytest.mark.parametrize("capacity", ["full", "tiny"])
def test_kernel_plan_covers_every_output_once(capacity, rows):
    """The grid is a product of (position tile, thread column, position)
    and (channel tile, thread row, channel), so each output is written once
    where each factor covers its range once: every (row, position) once,
    every channel once; each tile's splits walk the stages [0, iters) once,
    in order; the splits fill at most the card's slots (or are 1)."""
    for length, ci, co, k, stride, pad in _layers(capacity):
        form = cc.walk(length, ci, k, stride, pad)
        p = cc.plan(rows, co, form, SMS, BLOCKS_PER_SM)
        row, pos, co_off = _thread_outputs(p)
        kept = row < rows
        seen = np.zeros((rows, form.t), np.int64)
        np.add.at(seen, (row[kept], pos[kept]), 1)
        assert (seen == 1).all(), (capacity, rows, co)
        assert (pos[kept] % 8 == 0).sum() * 8 == rows * form.t  # 8-aligned runs: whole pools
        chans = (np.arange(p.co_tiles)[:, None, None] * p.bm + co_off[None]).ravel()
        assert np.array_equal(np.sort(chans[chans < co]), np.arange(co))
        assert p.bm == min(h for h in cc.TILE_HEIGHTS if h >= min(co, 128))
        walked = [it for s in range(p.splits) for it in range(*p.split_range(s))]
        assert walked == list(range(p.iters)) and p.iters == form.ci * form.k // cc.BK
        assert all(p.split_range(s)[1] - p.split_range(s)[0] >= min(cc.MIN_ITERS, p.iters)
                   for s in range(p.splits))
        assert p.splits == 1 or p.blocks <= SMS * BLOCKS_PER_SM[p.bm]


def test_plan_splits_the_second_layer_at_the_stream_batch():
    """64 rows of the second layer of "full" are 64 tiles: 4 splits of 256
    stages on 132 SMs at 2 blocks an SM; 512 rows need none; the first
    layer walks 4 phase channels of 128 taps."""
    length, ci, co, k, stride, pad = _layers("full")[1]
    form = cc.walk(length, ci, k, stride, pad)
    assert form == cc.Walk(1024, 64, 128)
    assert cc.plan(64, co, form, SMS, BLOCKS_PER_SM).splits == 4
    assert cc.plan(50, co, form, SMS, BLOCKS_PER_SM).splits == 5
    assert cc.plan(512, co, form, SMS, BLOCKS_PER_SM).splits == 1
    first = _layers("full")[0]
    assert cc.walk(first[0], first[1], first[3], first[4], first[5]) == cc.Walk(4, 128, 256)


def _emulate(x: np.ndarray, w: np.ndarray, b, scale, shift, stride: int, pad) -> np.ndarray:
    """The kernel's arithmetic in float64 on x [n, ci, L] and w [co, ci, K]:
    each stage's weights and input windows gathered by the kernel's index
    formulas (strides of the contiguous tensors, a strided layer as phase
    channels), each split's stages summed into its slot, the slots summed
    in slot order, then the epilogue and the pool placed by its formulas."""
    n, ci, length = x.shape
    co, _, k = w.shape
    form = cc.walk(length, ci, k, stride, pad)
    p = cc.plan(n, co, form, SMS, BLOCKS_PER_SM)
    xf, wf = x.ravel(), w.ravel()
    sx_n, sw_co = ci * length, ci * k
    if stride == 1:
        sx_c, cphase, sw_c, sw_k = length, 0, k, 1
    else:
        sx_c, cphase, sw_c, sw_k = 0, 1, 1, stride
    wlen = p.seg + cc.BK
    g = np.arange(p.pos_tiles)[:, None] * p.rows_per_tile + np.arange(p.rows_per_tile)[None]
    seg_row = g // p.segs_per_row                                   # [pos_tiles, R]
    seg_t0 = (g - seg_row * p.segs_per_row) * p.seg
    co_all = np.arange(p.co_tiles * p.bm)
    taps = np.arange(cc.BK)
    slots = []
    for s in range(p.splits):
        acc = np.zeros((p.pos_tiles, p.rows_per_tile, p.co_tiles * p.bm, p.seg))
        for it in range(*p.split_range(s)):
            c, kc0 = it // (form.k // cc.BK), it % (form.k // cc.BK) * cc.BK
            a_ok = co_all < co
            a = np.where(a_ok[:, None], wf[np.where(a_ok, co_all, 0)[:, None] * sw_co
                                           + c * sw_c + (kc0 + taps)[None] * sw_k], 0.0)
            pw = np.arange(wlen)
            u = seg_t0[..., None] + kc0 + pw
            idx = u * stride + c * cphase - pad[0]
            ok = ((seg_row < n)[..., None] & (pw < p.seg + cc.BK - 1) & (idx >= 0)
                  & (idx < length))
            addr = np.where(ok, seg_row[..., None] * sx_n + c * sx_c + idx, 0)
            win = np.where(ok, xf[addr], 0.0)                        # [pos_tiles, R, wlen]
            cols = win[..., np.arange(p.seg)[:, None] + taps[None]]  # [pt, R, seg, BK]
            acc += np.einsum("ok,prtk->prot", a, cols)
        slots.append(acc)
    total = slots[0]
    for acc in slots[1:]:
        total = total + acc
    z = np.maximum(total[:, :, :co] + b[None, None, :, None], 0.0)
    z = z * scale[None, None, :, None] + shift[None, None, :, None]
    pooled = np.maximum(z[..., 0::2], z[..., 1::2])
    out = np.full((n, co, form.t // 2), np.nan)
    keep = seg_row < n
    for pt, r in zip(*np.nonzero(keep)):
        t0 = seg_t0[pt, r] // 2
        out[seg_row[pt, r], :, t0 : t0 + p.seg // 2] = pooled[pt, r]
    return out


@pytest.mark.parametrize("capacity,rows", [("tiny", 1), ("tiny", 7), ("full", 1)])
def test_kernel_arithmetic_emulated_is_the_convolution(capacity, rows):
    """Layer after layer, the emulated kernel in float64 against the plain
    version in float64, within float64 rounding; every output written."""
    model = _model(capacity, seed=3).double()
    x = _frames(rows, seed=4).double()[:, None, :]
    for i in range(1, 7):
        conv, bn = getattr(model, f"conv{i}"), getattr(model, f"conv{i}_BN")
        with torch.no_grad():
            scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
            shift = bn.bias - bn.running_mean * scale
            w = conv.weight[..., 0]
            want = cc.conv_relu_affine_pool_plain(x, w, conv.bias, scale, shift,
                                                  conv.stride[0], PADS[i - 1])
        got = _emulate(*(v.detach().numpy() for v in (x, w, conv.bias, scale, shift)),
                       conv.stride[0], PADS[i - 1])
        assert not np.isnan(got).any()
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=1e-12)
        x = want


def test_walk_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="strided layer"):
        cc.walk(1024, 2, 512, 4, (254, 254))
    with pytest.raises(ValueError, match="output positions"):
        cc.walk(100, 16, 64, 1, (31, 32))
    with pytest.raises(ValueError, match="taps a channel"):
        cc.walk(128, 16, 32, 1, (15, 16))


def test_cuda_entry_refuses_cpu_tensors_and_counts_nothing():
    model = _model("tiny")
    before = cc.counts()
    bn = model.conv2_BN
    with pytest.raises(ValueError, match="CUDA tensor"):
        cc.conv_relu_affine_pool_cuda(torch.zeros(2, 128, 128), model.conv2.weight[..., 0],
                                      model.conv2.bias, bn.weight, bn.bias, 1, (31, 32))
    assert cc.counts() == before
    cc.add_counts({"launches_crepe_conv": 6})
    assert cc.counts() == {"launches_crepe_conv": before["launches_crepe_conv"] + 6}
    cc.add_counts({"launches_crepe_conv": -6})


@pytest.mark.parametrize("capacity", ["tiny", "full"])
def test_artifact_keeps_the_operator(capacity, tmp_path, monkeypatch):
    """Exported through the card's route (the plain version standing in
    for the kernel behind svc::crepe_conv), CREPE's serving artifact holds
    one svc.crepe_conv node a layer: the trace launches nothing (torch.export
    cannot trace the ctypes call; the operator's fake gives each layer's
    shape), and a call of the loaded artifact runs the operator six times
    and gives the plain forward to the bit."""
    from whisper_vits_svc_tpu_torch.infer import serving

    model = _model(capacity, seed=9)
    frames = _frames(4, seed=9)
    with torch.inference_mode():
        want = model(crepe.normalize_frames(frames))
    calls = []

    def fwd(x, w, b, scale, shift, stride, pad):
        calls.append(tuple(x.shape))
        return cc.conv_relu_affine_pool_plain(x, w, b, scale, shift, stride, pad)

    monkeypatch.setattr(cc, "conv_relu_affine_pool_cuda", fwd)
    monkeypatch.setattr(cc, "conv_relu_affine_pool",
                        lambda x, w, b, scale, shift, stride, pad:
                        cc.crepe_conv_op(x, w, b, scale, shift, stride, pad[0], pad[1]))
    path = str(tmp_path / "crepe.pt2")
    assert serving.export_extractor("crepe", model, path, batch=4) > 0
    nodes = [str(n.target) for n in torch.export.load(path).graph.nodes]
    assert calls == [] and nodes.count("svc.crepe_conv.default") == 6
    with torch.inference_mode():
        got = serving.load_exported(path)(frames)
    assert len(calls) == 6 and calls[0] == (4, 1, 1024)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_cpu_forward_launches_nothing():
    model = _model("tiny")
    before = cc.counts()
    with torch.inference_mode():
        probs = crepe.crepe_probabilities(model, _frames(70, seed=5).numpy(), batch_size=64)
    assert probs.shape == (70, crepe.PITCH_BINS) and cc.counts() == before


# ------------------------------------------------------------------ card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    from whisper_vits_svc_tpu_torch.utils.device import resolve_device
    return resolve_device("cuda")  # TF32 off: the plain version in float32


def _layer_inputs(capacity: str, rows: int, seed: int, dev):
    """Each layer's (x, w, b, scale, shift, stride, pad) on `dev`, x the
    plain version's output of the layer before."""
    model = _model(capacity, seed=seed).to(dev)
    x = _frames(rows, seed=seed).to(dev)[:, None, :]
    out = []
    with torch.inference_mode():
        for i in range(1, 7):
            conv, bn = getattr(model, f"conv{i}"), getattr(model, f"conv{i}_BN")
            scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
            shift = bn.bias - bn.running_mean * scale
            args = (x, conv.weight[..., 0], conv.bias, scale, shift, conv.stride[0], PADS[i - 1])
            out.append(args)
            x = cc.conv_relu_affine_pool_plain(*args)
    return out


@pytest.mark.card
@pytest.mark.parametrize("rows", [1, 64, 512])
@pytest.mark.parametrize("capacity", ["full", "tiny"])
def test_card_each_layer_against_float64(card, capacity, rows):
    """Each layer's kernel output against the float64 layer on the same
    float32 inputs: the difference within 1e-6 of the scale of a float32
    dot product's rounding, |scale| x the sum of |w| |x| over the taps
    (pooled as the outputs are), elementwise; one launch a layer."""
    for x, w, b, scale, shift, stride, pad in _layer_inputs(capacity, rows, rows, card):
        launches = cc.launches_crepe_conv
        got = cc.conv_relu_affine_pool(x, w, b, scale, shift, stride, pad)
        torch.cuda.synchronize()
        assert cc.launches_crepe_conv == launches + 1
        d = [v.double() for v in (x, w, b, scale, shift)]
        want = cc.conv_relu_affine_pool_plain(*d, stride, pad)
        terms = F.conv1d(F.pad(d[0].abs(), pad), d[1].abs(), stride=stride)
        tol = 1e-6 * F.max_pool1d(terms * d[3].abs()[:, None], 2, 2) + 1e-7 * want.abs()
        assert got.shape == want.shape
        assert ((got.double() - want).abs() <= tol).all(), float(((got.double() - want).abs()
                                                                  / tol).max())


@pytest.mark.card
@pytest.mark.parametrize("rows", [1, 50, 64, 512])
@pytest.mark.parametrize("capacity", ["full", "tiny"])
def test_card_forward_against_plain(card, capacity, rows):
    """The whole forward through the kernel against the plain version on
    the card (cuDNN, float32): probabilities within 1e-6; six launches a
    forward; a second call bitwise equal to the first."""
    model = _model(capacity, seed=rows).to(card)
    frames = _frames(rows, seed=rows).to(card)
    with torch.inference_mode():
        launches = cc.launches_crepe_conv
        got = model(frames)
        again = model(frames)
        torch.cuda.synchronize()
        assert cc.launches_crepe_conv == launches + 12
        want = _previous_forward(model, frames)
    assert (got - want).abs().max().item() <= 1e-6
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
