"""Wrapper of the CREPE convolution CUDA kernel (csrc/crepe_conv.cu).

Replaces no Pallas kernel: the JAX package leaves CREPE's convolutions to
XLA (whisper_vits_svc_tpu/models/crepe.py), and the port ran them through
cuDNN's float32 convolution, whose choice at these shapes is its legacy
implicit GEMM without tensor cores. One launch is one layer of
`Crepe.forward`: the conv1d (zero padding read as bounds, never made), the
bias, ReLU, the folded BatchNorm's multiply and add, and the max-pool by 2,
in float32 on the CUDA cores (no TF32). Bound: float32 FMAs (CREPE "full"
is 2.82 GFLOP a frame, 76% of it in the second layer; its bytes take 1-3%
of that time at the card's rates). Design (see the note in the source):
register-blocked tiles of BM channels x 128 positions, the K walk channel
by channel through cp.async double-buffered stages, each channel's input
window loaded once into shared memory and the im2col operand read from it
by offset; a strided layer walked as `stride` phase channels; split-K with
a fixed-order sum by the tile's last block (an integer ticket), so a call is
bitwise repeatable. It is built and bound by ops/cuda_build.py.

`plan` chooses the tile height BM from the output channels and the splits
from the tiles and the card's block slots (its SMs times the kernel's
resident blocks an SM, asked of the card once): one algorithm whose
parameters come from the shape it is given, 64 rows or 512.

`conv_relu_affine_pool` takes the plain PyTorch version
(`conv_relu_affine_pool_plain`: F.pad, F.conv1d, relu, the affine,
max_pool1d) only for a CPU tensor; for a CUDA tensor it launches the kernel
through the operator `svc::crepe_conv` (`crepe_conv_op`), which torch.export
keeps as one node, or raises. `launches_crepe_conv` counts kernel launches
(`counts`, `add_counts`; utils/counters.py).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import torch
import torch.nn.functional as F

from ..utils import counters
from .cuda_build import CSRC, load_library, param, tickets

SOURCE = CSRC / "crepe_conv.cu"
BN = 128          # positions a tile
BK = 64           # taps a stage of the K walk
TILE_HEIGHTS = (32, 64, 128)   # output channels a tile (BM)
MIN_ITERS = 8     # stages a split walks at least

launches_crepe_conv = 0
counts, add_counts = counters.declare(__name__, "launches_crepe_conv")


def conv_relu_affine_pool_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                                scale: torch.Tensor, shift: torch.Tensor, stride: int,
                                pad: tuple[int, int]) -> torch.Tensor:
    """The plain version: x [N, Ci, L], w [Co, Ci, K] -> [N, Co, T // 2]."""
    x = F.relu(F.conv1d(F.pad(x, pad), w, b, stride=stride))
    return F.max_pool1d(x * scale[:, None] + shift[:, None], 2, 2)


@dataclass(frozen=True)
class Walk:
    """The kernel's form of a layer: `ci` channels of `k` taps at stride 1
    (a strided layer of one channel as `stride` phase channels of
    K / stride taps), over `t` output positions before the pool."""

    ci: int
    k: int
    t: int


def walk(length: int, ci: int, k: int, stride: int, pad: tuple[int, int]) -> Walk:
    """The K walk of a layer with inputs [., ci, length] and taps k, or
    ValueError where the kernel does not take it."""
    t = (length + pad[0] + pad[1] - k) // stride + 1
    if stride != 1 and (ci != 1 or k % stride):
        raise ValueError(f"crepe_conv: a strided layer takes one channel and taps a multiple of "
                         f"the stride, got {ci} channels, {k} taps, stride {stride}")
    if min(pad) < 0 or t < 8 or t % 8 or (BN % t if t <= BN else t % BN):
        raise ValueError(f"crepe_conv: {t} output positions (a multiple of 8 that divides {BN} "
                         f"or is a multiple of it) from length {length}, pad {pad}")
    form = Walk(ci * stride, k // stride, t)
    if form.k % BK:
        raise ValueError(f"crepe_conv: {form.k} taps a channel, not a multiple of {BK}")
    return form


@dataclass(frozen=True)
class Plan:
    """The grid of one launch: tiles of `bm` channels x BN positions, row
    segments of `seg` positions (`rows_per_tile` of them a tile when a row
    is shorter than BN), the K walk's `iters` stages cut into `splits`."""

    bm: int
    seg: int
    rows_per_tile: int
    segs_per_row: int
    pos_tiles: int
    co_tiles: int
    iters: int
    splits: int

    @property
    def tiles(self) -> int:
        return self.pos_tiles * self.co_tiles

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def split_range(self, s: int) -> tuple[int, int]:
        """The stages [lo, hi) that split s walks (the kernel's formula)."""
        return s * self.iters // self.splits, (s + 1) * self.iters // self.splits


def plan(n: int, co: int, form: Walk, sms: int, blocks_per_sm: dict[int, int]) -> Plan:
    """The tile height: the smallest of TILE_HEIGHTS that holds `co`, else
    the largest. The splits: as many as the card's slots (`sms` times the
    resident blocks an SM at that height) hold for the tiles, at most one
    per MIN_ITERS stages, at least 1: 64 rows of the second layer (64 tiles)
    take 4 splits on 132 SMs, 512 rows none."""
    bm = next((h for h in TILE_HEIGHTS if co <= h), TILE_HEIGHTS[-1])
    seg = min(form.t, BN)
    rows_per_tile, segs_per_row = BN // seg, form.t // seg
    pos_tiles = -(-n * segs_per_row // rows_per_tile)
    co_tiles = -(-co // bm)
    iters = form.ci * (form.k // BK)
    slots = sms * blocks_per_sm[bm]
    splits = max(1, min(slots // (pos_tiles * co_tiles), iters // MIN_ITERS))
    return Plan(bm, seg, rows_per_tile, segs_per_row, pos_tiles, co_tiles, iters, splits)


@lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib = load_library(
        SOURCE, "crepe_conv_forward",
        [ptr, i64, i64, i32, i32, i32, i32, ptr, i64, i64, i64, ptr, ptr, ptr, ptr]
        + [i32] * 7 + [ptr, ptr, ptr],
        "crepe_conv_error_string")
    lib.crepe_conv_blocks_per_sm.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
    lib.crepe_conv_blocks_per_sm.restype = ctypes.c_int
    return lib


def _error(lib: ctypes.CDLL, err: int) -> str:
    return lib.crepe_conv_error_string(err).decode()


@lru_cache(maxsize=None)
def card_slots(device: torch.device) -> tuple[int, dict[int, int]]:
    """(SMs, {tile height: resident blocks an SM}) of the card, asked once."""
    lib = _library()
    blocks = {}
    with torch.cuda.device(device):
        for bm in TILE_HEIGHTS:
            out = ctypes.c_int(0)
            err = lib.crepe_conv_blocks_per_sm(bm, ctypes.byref(out))
            if err or out.value < 1:
                raise RuntimeError(f"crepe_conv: no resident block at height {bm}: "
                                   f"{_error(lib, err) if err else 'occupancy 0'}")
            blocks[bm] = out.value
    return torch.cuda.get_device_properties(device).multi_processor_count, blocks


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"conv_relu_affine_pool_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or w.dtype != torch.float32 or x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"conv_relu_affine_pool_cuda takes float32 x [N, Ci, L] and w "
                         f"[Co, Ci, K], got {x.dtype} {tuple(x.shape)} and {w.dtype} "
                         f"{tuple(w.shape)}")
    if w.shape[1] != x.shape[1] or w.device != x.device or b is None:
        raise ValueError(f"conv_relu_affine_pool_cuda: w {tuple(w.shape)} on {w.device} and a "
                         f"bias for x {tuple(x.shape)} on {x.device}")
    if len(x) < 1:
        raise ValueError("conv_relu_affine_pool_cuda: no rows")


def conv_relu_affine_pool_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                               scale: torch.Tensor, shift: torch.Tensor, stride: int,
                               pad: tuple[int, int]) -> torch.Tensor:
    """One launch of the kernel: arguments and result as
    `conv_relu_affine_pool_plain`, float32 on the card, equal to it up to
    the order of the float32 sums. Launches on the current stream; does
    not synchronize."""
    global launches_crepe_conv
    _check(x, w, b)
    if x.stride(2) != 1:
        x = x.contiguous()
    n, ci, length = x.shape
    co, _, k = w.shape
    form = walk(length, ci, k, stride, pad)
    if stride == 1:
        sx_c, cphase, sw_c, sw_k = x.stride(1), 0, w.stride(1), w.stride(2)
    else:  # phase r of the one channel: x index 4 u + r - pad, tap 4 q + r
        sx_c, cphase, sw_c, sw_k = 0, 1, w.stride(2), stride * w.stride(2)
    dev = x.device
    p = plan(n, co, form, *card_slots(dev))
    b, scale, shift = (param(v, dev) for v in (b, scale, shift))
    out = torch.empty((n, co, form.t // 2), dtype=torch.float32, device=dev)
    ws = (torch.empty(p.blocks * p.bm * BN, dtype=torch.float32, device=dev)
          if p.splits > 1 else None)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ticket = tickets(dev, p.tiles, stream) if p.splits > 1 else None
        err = lib.crepe_conv_forward(
            x.data_ptr(), x.stride(0), sx_c, length, stride, cphase, pad[0],
            w.data_ptr(), w.stride(0), sw_c, sw_k, b.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), out.data_ptr(), n, co, form.t, form.ci, form.k, p.bm, p.splits,
            None if ws is None else ws.data_ptr(), None if ticket is None else ticket.data_ptr(),
            stream)
    if err:
        raise RuntimeError(f"crepe_conv kernel launch failed: {_error(lib, err)}")
    launches_crepe_conv += 1
    return out


@torch.library.custom_op("svc::crepe_conv", mutates_args=())
def crepe_conv_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, scale: torch.Tensor,
                  shift: torch.Tensor, stride: int, pad_left: int,
                  pad_right: int) -> torch.Tensor:
    """The kernel as the operator `torch.ops.svc.crepe_conv` (one launch of
    `conv_relu_affine_pool_cuda`), so that torch.export records it as one
    node of a graph where it cannot trace the ctypes call: CREPE's serving
    artifact (infer/serving.py) keeps the kernel, and finds this operator
    by name once this module is imported before torch.export.load."""
    return conv_relu_affine_pool_cuda(x, w, b, scale, shift, stride, (pad_left, pad_right))


@crepe_conv_op.register_fake
def _crepe_conv_fake(x, w, b, scale, shift, stride, pad_left, pad_right):
    t = (x.shape[2] + pad_left + pad_right - w.shape[2]) // stride + 1
    return x.new_empty((x.shape[0], w.shape[0], t // 2))


def conv_relu_affine_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          scale: torch.Tensor, shift: torch.Tensor, stride: int,
                          pad: tuple[int, int]) -> torch.Tensor:
    """One CREPE layer, x [N, Ci, L] -> [N, Co, T // 2]: the kernel (through
    `crepe_conv_op`) for a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return conv_relu_affine_pool_plain(x, w, b, scale, shift, stride, pad)
    return crepe_conv_op(x, w, b, scale, shift, stride, pad[0], pad[1])
