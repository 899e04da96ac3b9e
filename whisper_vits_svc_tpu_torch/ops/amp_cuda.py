"""Wrapper of the fused AMP dilation-iteration CUDA kernel (csrc/amp_iter.cu).

Replaces the TPU kernel whisper_vits_svc_tpu/ops/pallas_amp.py::amp_iter: one
launch computes `x + conv2_{k,1}(SnakeAlias(conv1_{k,d}(SnakeAlias(x))))` on
[B, C, T], both convolutions zero-padded, both snakes edge-replicated, with
the weight norm already folded into the (C, C, k) kernels. The kernel is
bound by f32 operations, not bytes (see the note in the source). It is built
and bound as the snake kernels are (ops/snake_cuda.py).

`amp_iter` takes the plain PyTorch version (`amp_iter_ref`) only for a CPU
tensor; for a CUDA tensor it launches the kernel or raises. The kernel is
forward only, as in the JAX package. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F

from ..nn.snake import snake_alias_fused_cm
from . import snake_cuda

SOURCE = snake_cuda.CSRC / "amp_iter.cu"
# the kernel holds every channel's accumulators in registers and both folded
# kernels (2 k C^2 floats: 90 KB at C = 32, k = 11) in shared memory
MAX_C = 32
# a block's dynamic shared memory on Hopper, less a margin
SMEM_BUDGET = 232448 - 1024
# outputs per block: with the 22 positions conv1 runs wider (k = 11) this is
# one pass of 256 threads x 2 positions
MAX_TILE = 480

launches = 0


def use_fused_iter(c: int, t: int, b: int = 1) -> bool:
    """The shapes AMPBlock(fused_iter=True) gives to `amp_iter`: every
    [B, C, T] with C <= 32 (the generator's last two stages at base width)."""
    return c <= MAX_C


def halo(kernel_size: int, d: int) -> int:
    """Samples of x a tile needs past each end."""
    return (kernel_size - 1) // 2 + 12 + d * (kernel_size - 1) // 2


def amp_tile(c: int, kernel_size: int, d: int) -> int:
    """Outputs per block: MAX_TILE, or the largest multiple of 32 whose four
    [C, tile + 2 halo] buffers fit in shared memory beside the two kernels."""
    cp = 4 * (-(-c // 4))
    fixed = 4 * (2 * kernel_size * c * cp + 6 * cp)
    width = (SMEM_BUDGET - fixed) // (16 * c)
    tile = min(MAX_TILE, width - 2 * halo(kernel_size, d))
    tile -= tile % 32
    if tile < 32:
        raise ValueError(f"amp_iter: C={c}, k={kernel_size}, d={d} does not fit a block's "
                         f"shared memory")
    return tile


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
    return snake_cuda.load_library(
        SOURCE, "amp_iter_forward",
        [ptr] * 10 + [ctypes.POINTER(ctypes.c_float)] + [integer] * 7 + [ptr],
        "amp_iter_error_string")


def amp_iter_cuda(x: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor, a1: torch.Tensor,
                  be1: torch.Tensor, k2: torch.Tensor, b2: torch.Tensor, a2: torch.Tensor,
                  be2: torch.Tensor, kernel_size: int, d: int) -> torch.Tensor:
    """Launch the kernel on x [B, C, T] (CUDA, contiguous, float32 or
    bfloat16; math in float32; C <= 32, any T >= 1), arguments as
    `amp_iter_ref`. Returns a new tensor of x's dtype. Launches on the
    current stream; does not synchronize."""
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
    tile = amp_tile(c, kernel_size, d)
    params = [snake_cuda._param(p, x.device) for p in (k1, b1, a1, be1, k2, b2, a2, be2)]
    out = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.amp_iter_forward(
            x.data_ptr(), out.data_ptr(), *(p.data_ptr() for p in params), snake_cuda._taps(),
            int(x.dtype == torch.bfloat16), b, c, t, kernel_size, d, tile, stream)
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
