"""Wrapper of the fused AMP dilation-iteration CUDA kernel (csrc/amp_iter.cu).

Replaces the TPU kernel whisper_vits_svc_tpu/ops/pallas_amp.py::amp_iter: one
launch computes `x + conv2_{k,1}(SnakeAlias(conv1_{k,d}(SnakeAlias(x))))` on
[B, C, T], both convolutions zero-padded, both snakes edge-replicated, with
the weight norm already folded into the (C, C, k) kernels. The kernel is
bound by its two channel mixes, which it runs as 3xTF32 products on the
tensor cores (see the note in the source). It is built and bound by
ops/cuda_build.py and reads the snake kernels' FIR taps
(`snake_cuda.fir_taps`); `amp_geometry` and `amp_tile` give its tile plan,
as the source computes it.

`amp_iter` takes the plain PyTorch version (`amp_iter_ref`) only for a CPU
tensor; for a CUDA tensor it launches the kernel or raises. The kernel is
forward only, as in the JAX package. `launches` counts kernel launches
(`counts`, `add_counts`; utils/counters.py).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import torch
import torch.nn.functional as F

from ..nn.snake import snake_alias_fused_cm
from ..utils import counters
from .cuda_build import CSRC, load_library, param
from .snake_cuda import fir_taps

SOURCE = CSRC / "amp_iter.cu"
# the kernel holds every channel of a time tile in one block
MAX_C = 32
# shared memory of an H100 SM, and the kernel's target of two resident
# blocks an SM (its __launch_bounds__), each with the 1 KB the card reserves
SMEM_PER_SM = 233472
BLOCKS_PER_SM = 2
SMEM_BUDGET = SMEM_PER_SM // BLOCKS_PER_SM - 1024
MAX_TILE = 512
# no tile shorter than this (or than T): the halo a tile recomputes is up to
# 50 s1 positions
MIN_TILE = 128
H100_SMS = 132

launches = 0
counts, add_counts = counters.declare(__name__, "launches")


def use_fused_iter(c: int, t: int, b: int = 1) -> bool:
    """The shapes AMPBlock(fused_iter=True) gives to `amp_iter`: every
    [B, C, T] with C <= 32 (the generator's last two stages at base width)."""
    return c <= MAX_C


def _round_to(v: int, mod: int, rem: int) -> int:
    """The least w >= v with w = rem (mod `mod`)."""
    return v + (rem - v) % mod


@dataclass(frozen=True)
class AmpGeometry:
    """A tile's stage ranges (positions relative to the tile's first output)
    and shared-memory rows, as csrc/amp_iter.cu::geometry computes them."""
    tile: int
    r1: int
    r2: int
    l2: int      # s2 over [s2_lo, s2_lo + l2)
    lc: int      # c1 over [s2_lo - 6, s2_lo - 6 + lc)
    l1: int      # s1 over [s1_lo, s1_lo + l1)
    s1_lo: int
    s2_lo: int
    e1: int      # s1 positions before the first one conv1 reads
    lr1: int     # row of R1 (x, then c1), floats
    ls2: int     # row of R2 (s1, then s2), float2

    def smem_bytes(self, c: int, kernel_size: int) -> int:
        """R1 and R2 for c rows, and the staged fragments of up to
        MAX_STAGED_KSTEPS k-steps (a float4 a lane for each of the ceil(C /
        8) n-tiles of a k-step)."""
        staged = min(ksteps(c, kernel_size), MAX_STAGED_KSTEPS)
        return c * (4 * self.lr1 + 8 * self.ls2) + 16 * staged * 32 * -(-c // 8)


# k-steps (8 of the k C (tap, input channel) pairs) of a conv's fragments a
# block stages in shared memory at once, at most; and k-steps summed apart
MAX_STAGED_KSTEPS = 18
KGROUP = 3
# m-tiles of 16 positions a warp holds at once, by its n-tiles of 8 output
# channels (ceil(C / 8))
MTW = {1: 4, 2: 4, 3: 2, 4: 2}


def ksteps(c: int, kernel_size: int) -> int:
    """k-steps of one conv's packed K = k C."""
    return -(-kernel_size * c // 8)


def amp_geometry(kernel_size: int, d: int, tile: int) -> AmpGeometry:
    r2, r1 = (kernel_size - 1) // 2, d * (kernel_size - 1) // 2
    l2 = tile + 2 * r2
    lc = l2 + 12
    want = -r2 - 6 - r1
    s1_lo = -8 * ((7 - want) // 8)
    e1 = want - s1_lo
    l1 = e1 + lc + 2 * r1
    return AmpGeometry(tile=tile, r1=r1, r2=r2, l2=l2, lc=lc, l1=l1, s1_lo=s1_lo, s2_lo=-r2,
                       e1=e1, lr1=_round_to(8 * -(-(l1 + 21) // 8), 32, 8),
                       ls2=_round_to(8 * -(-l1 // 8) + 16, 16, 4))


def amp_tile(b: int, c: int, t: int, kernel_size: int, d: int, sms: int = H100_SMS) -> int:
    """Outputs per block: the largest multiple of 8 up to MAX_TILE that fits
    BLOCKS_PER_SM blocks an SM and lets each warp hold its m-tiles of the
    channel mixes in one round (8 x MTW m-tiles of c1), then shrunk so that
    the b * ceil(t / tile) blocks fill whole waves of sms * BLOCKS_PER_SM as
    nearly as they can, but not below MIN_TILE (or t rounded up to 8)."""
    def fits(tile):
        g = amp_geometry(kernel_size, d, tile)
        # each of the 8 warps holds all its m-tiles of c1 in one round
        one_round = -(-g.lc // 16) <= 8 * MTW[-(-c // 8)]
        return one_round and g.smem_bytes(c, kernel_size) <= SMEM_BUDGET

    tile_max = next((tile for tile in range(MAX_TILE, 0, -8) if fits(tile)), 0)
    if not tile_max:
        raise ValueError(f"amp_iter: C={c}, k={kernel_size}, d={d} does not fit a block's "
                         f"shared memory")
    slots = sms * BLOCKS_PER_SM
    waves = -(-b * -(-t // tile_max) // slots)
    per_row = max(1, waves * slots // b)
    tile = 8 * -(-t // (8 * per_row))  # ceil(t / per_row), up to a multiple of 8
    return max(min(MIN_TILE, 8 * -(-t // 8)), min(tile, tile_max))


def amp_iter_ref(x: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor, a1: torch.Tensor,
                 be1: torch.Tensor, k2: torch.Tensor, b2: torch.Tensor, a2: torch.Tensor,
                 be2: torch.Tensor, kernel_size: int, d: int) -> torch.Tensor:
    """Plain PyTorch version of one fused iteration, the four modules
    composed. x [B, C, T]; k1, k2 folded kernels (C, C, k) in torch's
    (out, in, tap) order; b1, b2 biases [C]; a1, be1, a2, be2 log-scale snake
    parameters [C]."""
    pad1 = (kernel_size * d - d) // 2
    pad2 = (kernel_size - 1) // 2
    s1 = snake_alias_fused_cm(x, a1, be1)
    c1 = F.conv1d(s1, k1.to(x.dtype), b1.to(x.dtype), padding=pad1, dilation=d)
    s2 = snake_alias_fused_cm(c1, a2, be2)
    return x + F.conv1d(s2, k2.to(x.dtype), b2.to(x.dtype), padding=pad2)


@lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    ptr, integer = ctypes.c_void_p, ctypes.c_int
    return load_library(
        SOURCE, "amp_iter_forward",
        [ptr] * 11 + [ctypes.POINTER(ctypes.c_float)] + [integer] * 7 + [ptr],
        "amp_iter_error_string")


def wfrag_floats(c: int, kernel_size: int) -> int:
    """Floats of the kernel's weight-fragment scratch: two convolutions,
    ceil(k C / 8) k-steps, ceil(C / 8) n-tiles, 32 lanes, hi and lo of two
    values."""
    return 2 * ksteps(c, kernel_size) * -(-c // 8) * 32 * 4


def amp_iter_cuda(x: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor, a1: torch.Tensor,
                  be1: torch.Tensor, k2: torch.Tensor, b2: torch.Tensor, a2: torch.Tensor,
                  be2: torch.Tensor, kernel_size: int, d: int) -> torch.Tensor:
    """Launch the kernel on x [B, C, T] (CUDA, contiguous, float32 or
    bfloat16; math in float32, channel mixes as 3xTF32 products; C <= 32,
    any T >= 1), arguments as `amp_iter_ref`. Returns a new tensor of x's
    dtype. Launches on the current stream (the weights' split, then the
    iteration); does not synchronize."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"amp_iter_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"amp_iter_cuda takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"amp_iter_cuda needs a contiguous [B, C, T] tensor, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    b, c, t = x.shape
    if not (0 < b <= 65535 and 0 < c <= MAX_C and 0 < t < 2**31 - 2048):
        raise ValueError(f"amp_iter_cuda: unsupported shape {tuple(x.shape)} (C <= {MAX_C})")
    if kernel_size % 2 != 1 or d < 1:
        raise ValueError(f"amp_iter_cuda: kernel_size must be odd and d >= 1, got "
                         f"{kernel_size}, {d}")
    for name, w in (("k1", k1), ("k2", k2)):
        if w.shape != (c, c, kernel_size):
            raise ValueError(f"{name} must be ({c}, {c}, {kernel_size}), got {tuple(w.shape)}")
    for name, v in (("b1", b1), ("a1", a1), ("be1", be1), ("b2", b2), ("a2", a2), ("be2", be2)):
        if v.shape != (c,):
            raise ValueError(f"{name} must be [{c}], got {tuple(v.shape)}")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile = amp_tile(b, c, t, kernel_size, d, sms)
    params = [param(p, x.device) for p in (k1, b1, a1, be1, k2, b2, a2, be2)]
    out = torch.empty_like(x)
    wfrag = torch.empty(wfrag_floats(c, kernel_size), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.amp_iter_forward(
            x.data_ptr(), out.data_ptr(), *(p.data_ptr() for p in params), wfrag.data_ptr(),
            fir_taps(), int(x.dtype == torch.bfloat16), b, c, t, kernel_size, d, tile,
            stream)
    if err:
        raise RuntimeError(f"amp_iter kernel launch failed: "
                           f"{lib.amp_iter_error_string(err).decode()}")
    launches += 1
    return out


def amp_iter_kernel(x: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor, a1: torch.Tensor,
                    be1: torch.Tensor, k2: torch.Tensor, b2: torch.Tensor, a2: torch.Tensor,
                    be2: torch.Tensor, kernel_size: int, d: int) -> torch.Tensor:
    """The kernel route: one launch, and no graph (the kernel has no
    backward: it raises where autograd would record one)."""
    args = (x, k1, b1, a1, be1, k2, b2, a2, be2)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        raise RuntimeError("amp_iter is forward only; use AMPBlock(fused_iter=False) where "
                           "a gradient is wanted")
    return amp_iter_cuda(*args, kernel_size, d)


def amp_iter(x: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor, a1: torch.Tensor,
             be1: torch.Tensor, k2: torch.Tensor, b2: torch.Tensor, a2: torch.Tensor,
             be2: torch.Tensor, kernel_size: int, d: int) -> torch.Tensor:
    """One fused AMP dilation iteration on [B, C, T]: the kernel for a CUDA
    tensor, the plain version (differentiated by autograd) for a CPU tensor."""
    if x.device.type == "cpu":
        return amp_iter_ref(x, k1, b1, a1, be1, k2, b2, a2, be2, kernel_size, d)
    return amp_iter_kernel(x, k1, b1, a1, be1, k2, b2, a2, be2, kernel_size, d)
