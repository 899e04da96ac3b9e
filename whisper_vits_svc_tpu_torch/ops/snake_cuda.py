"""Wrappers of the fused anti-aliased snake CUDA kernels (csrc/snake_alias.cu,
csrc/snake_alias_bwd.cu, csrc/snake_alias_strips.cu, csrc/snake_alias_mma.cu)
and their autograd Function.

Replace the TPU kernels whisper_vits_svc_tpu/ops/pallas_snake.py::
snake_alias_cm_pallas (forward; its `strips=True` launch and its `mxu=True`
form too) and ::snake_alias_cm_pallas_bwd (backward). Each source is
compiled at first use with nvcc into a plain C ABI shared library under
<repo>/build/kernels/ (keyed by the hash of the source and the headers
beside it) and bound with ctypes; `build` starts one nvcc per source, all at
once. The snake kernels are bound by HBM bytes (see the notes in the
sources).

`snake_alias` takes the plain PyTorch version (nn/snake.py) only for a CPU
tensor; for a CUDA tensor it launches the kernels or raises. When a gradient
is wanted it goes through `SnakeAliasFunction`, which saves only x, alpha
and beta (as the JAX custom VJP does) and runs the backward kernel; without
one (e.g. under torch.inference_mode) it launches the forward alone.
`variant` chooses the forward kernel: "direct" (one block per 1024-sample
tile), "strips" (narrow, long shapes cut into segments that fill the card
once; bitwise equal to "direct") or "mma" (the phase FIRs as 3xTF32 products
on the tensor cores). The two alternatives are forward only, as in the JAX
package. `launches`, `launches_bwd`, `launches_strips` and `launches_mma`
count kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..nn.snake import _polyphase_taps, snake_alias_fused_cm

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "snake_alias.cu"
SOURCE_BWD = CSRC / "snake_alias_bwd.cu"
SOURCE_STRIPS = CSRC / "snake_alias_strips.cu"
SOURCE_MMA = CSRC / "snake_alias_mma.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

VARIANTS = ("direct", "strips", "mma")
# "strips" takes narrow, long shapes (the generator's last two stages at base
# width); the others stay with the direct kernel
STRIPS_MAX_C = 32
STRIPS_MIN_BT = 100_000
# blocks an H100 holds at once: 132 SMs x 8 resident 256-thread blocks
H100_BLOCK_SLOTS = 132 * 8
STRIPS_MIN_SEG = 256
STRIPS_MAX_SEG = 2048  # two of the kernel's 1024-sample tiles

launches = 0
launches_bwd = 0
launches_strips = 0
launches_mma = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the snake kernels are built with the CUDA toolkit")
    return path


def all_sources() -> tuple[Path, ...]:
    """Every kernel source of the package."""
    return tuple(sorted(CSRC.glob("*.cu")))


def _lib_path(source: Path) -> Path:
    text = source.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build(*sources: Path) -> list[Path]:
    """Compile each source (default: every source under csrc/) into
    build/kernels/ once per source version, one nvcc process per source, all
    started together. Returns the libraries' paths."""
    sources = sources or all_sources()
    running = []
    for source in sources:
        lib = _lib_path(source)
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
            running.append((source, subprocess.Popen(cmd), tmp, lib))
    failed = [source.name for source, proc, _, _ in running if proc.wait() != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}")
    for _, _, tmp, lib in running:
        os.replace(tmp, lib)
    return [_lib_path(s) for s in sources]


def load_library(source: Path, entry: str, argtypes: list, error_string: str) -> ctypes.CDLL:
    """Build `source` if need be, load it, and declare its launch function
    (returns a cudaError_t as int) and its error-string function."""
    lib = ctypes.CDLL(str(build(source)[0]))
    launch = getattr(lib, entry)
    launch.argtypes, launch.restype = argtypes, ctypes.c_int
    message = getattr(lib, error_string)
    message.argtypes, message.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


_PTR, _INT, _TAPS = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float)


@lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return load_library(SOURCE, "snake_alias_forward",
                        [_PTR] * 4 + [_TAPS] + [_INT] * 4 + [_PTR], "snake_alias_error_string")


@lru_cache(maxsize=None)
def _library_bwd() -> ctypes.CDLL:
    lib = load_library(SOURCE_BWD, "snake_alias_backward",
                       [_PTR] * 9 + [_TAPS] + [_INT] * 4 + [_PTR],
                       "snake_alias_backward_error_string")
    lib.snake_alias_backward_tile.argtypes = []
    lib.snake_alias_backward_tile.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=None)
def _library_strips() -> ctypes.CDLL:
    return load_library(SOURCE_STRIPS, "snake_alias_strips_forward",
                        [_PTR] * 4 + [_TAPS] + [_INT] * 6 + [_PTR],
                        "snake_alias_strips_error_string")


@lru_cache(maxsize=None)
def _library_mma() -> ctypes.CDLL:
    return load_library(SOURCE_MMA, "snake_alias_mma_forward",
                        [_PTR] * 5 + [_TAPS] + [_INT] * 4 + [_PTR],
                        "snake_alias_mma_error_string")


@lru_cache(maxsize=None)
def _taps():
    ae, ao, oe, oo, de, do_, doe, doo = _polyphase_taps(12, 12)
    assert (oe, oo, doe, doo) == (-3, -2, -2, -3), "kernel assumes the k=12 geometry"
    assert len(ae) == len(ao) == len(de) == len(do_) == 6
    return (ctypes.c_float * 24)(*np.concatenate([ae, ao, de, do_]).tolist())


def _check_input(name: str, x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous [B, C, T] tensor, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    b, c, t = x.shape
    if not (0 < b <= 65535 and 0 < c <= 65535 and 0 < t < 2**31 - 2048):
        raise ValueError(f"{name}: unsupported shape {tuple(x.shape)}")
    if alpha.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"alpha/beta must be [{c}], got {tuple(alpha.shape)}, "
                         f"{tuple(beta.shape)}")


def _param(p: torch.Tensor, device: torch.device) -> torch.Tensor:
    return p.detach().to(device=device, dtype=torch.float32).contiguous()


def _launch_forward(name: str, library, x: torch.Tensor, alpha: torch.Tensor,
                    beta: torch.Tensor, before_taps: tuple = (), after_shape: tuple = ()):
    """Check the inputs, then launch `<name>_forward(x, out, alpha, beta,
    *before_taps, taps, is_bf16, B, C, T, *after_shape, stream)` of the
    library that `library()` loads, on the current stream; raises on a
    refused launch. Returns the output."""
    _check_input(f"{name}_cuda", x, alpha, beta)
    lib = library()
    b, c, t = x.shape
    alpha, beta = _param(alpha, x.device), _param(beta, x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"{name}_forward")(
            x.data_ptr(), out.data_ptr(), alpha.data_ptr(), beta.data_ptr(), *before_taps,
            _taps(), int(x.dtype == torch.bfloat16), b, c, t, *after_shape, stream)
    if err:
        message = getattr(lib, f"{name}_error_string")(err).decode()
        extra = f" with {after_shape}" if after_shape else ""
        raise RuntimeError(f"{name} kernel launch failed{extra}: {message}")
    return out


def snake_alias_cuda(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel on x [B, C, T] (CUDA, contiguous, float32
    or bfloat16; math in float32), alpha/beta [C]. Returns a new tensor of
    x's dtype. Launches on the current stream; does not synchronize."""
    global launches
    out = _launch_forward("snake_alias", _library, x, alpha, beta)
    launches += 1
    return out


def use_strips(c: int, t: int, b: int = 1) -> bool:
    """The shapes variant="strips" takes: narrow and long."""
    return c <= STRIPS_MAX_C and b * t >= STRIPS_MIN_BT


def strip_fold(c: int, t: int, b: int = 1, slots: int = H100_BLOCK_SLOTS) -> int:
    """Segments per [T] row for the strips launch: as many as fill the
    card's `slots` resident blocks once with b * c * fold blocks, but no
    segment shorter than STRIPS_MIN_SEG samples or longer than
    STRIPS_MAX_SEG (a block walks its segment tile after tile, and measured
    on an H100 a third tile a block already costs more than the fuller card
    gives). Segment s of a row is [s * seg, min((s + 1) * seg, t)) with
    seg = ceil(t / fold): the segments are non-empty and cover the row
    exactly once."""
    want = max(1, slots // (b * c))
    seg = min(max(-(-t // want), STRIPS_MIN_SEG), STRIPS_MAX_SEG, t)
    return -(-t // seg)


def snake_alias_strips_cuda(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                            fold: int | None = None) -> torch.Tensor:
    """Launch the strips kernel on x [B, C, T] (any shape `snake_alias_cuda`
    takes), each row in `fold` segments (default: `strip_fold` for this
    card). Bitwise equal to `snake_alias_cuda`. Launches on the current
    stream; does not synchronize."""
    global launches_strips
    _check_input("snake_alias_strips_cuda", x, alpha, beta)
    b, c, t = x.shape
    if fold is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        fold = strip_fold(c, t, b, slots=8 * sms)
    out = _launch_forward("snake_alias_strips", _library_strips, x, alpha, beta,
                          after_shape=(fold, -(-t // fold)))
    launches_strips += 1
    return out


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 number (10 mantissa bits, ties away from
    zero, as `cvt.rna.tf32.f32` rounds), held in float32."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a = hi + lo up to 2^-22 |a|, both TF32 numbers: the operands of a
    3xTF32 product (lo x hi + hi x lo + hi x hi)."""
    hi = tf32_round(a)
    return hi, tf32_round(a - hi)


@lru_cache(maxsize=None)
def fir_matrices() -> tuple[np.ndarray, np.ndarray]:
    """The banded FIR matrices of the mma kernel, from the 24 taps.
    B_up [24, 32]: a window of 16 phase positions from P reads x[P - 3 + i],
    i < 24; columns 0..15 give se[P + j], 16..31 so[P + j]. B_dn [48, 16]: a
    window of 16 outputs from q reads E[q - 2 + i] (rows 0..23) and
    O[q - 3 + i] (rows 24..47)."""
    ae, ao, _, _, de, do_, _, _ = _polyphase_taps(12, 12)
    _taps()  # asserts the geometry the offsets above assume
    b_up = np.zeros((24, 32), np.float32)
    b_dn = np.zeros((48, 16), np.float32)
    for j in range(16):
        for m in range(6):
            b_up[j + m, j] = ae[m]
            b_up[j + m + 1, 16 + j] = ao[m]
            b_dn[j + m, j] = de[m]
            b_dn[24 + j + m, j] = do_[m]
    return b_up, b_dn


@lru_cache(maxsize=None)
def _fir_device(device: torch.device) -> torch.Tensor:
    """[B_up hi, B_up lo, B_dn hi, B_dn lo] flattened, on `device`."""
    parts = []
    for m in fir_matrices():
        parts += [p.flatten() for p in tf32_split(torch.from_numpy(m))]
    return torch.cat(parts).to(device)


def snake_alias_mma_cuda(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Launch the tensor-core kernel on x [B, C, T] (any shape
    `snake_alias_cuda` takes). float32 accuracy through 3xTF32 products.
    Launches on the current stream; does not synchronize."""
    global launches_mma
    _check_input("snake_alias_mma_cuda", x, alpha, beta)
    out = _launch_forward("snake_alias_mma", _library_mma, x, alpha, beta,
                          before_taps=(_fir_device(x.device).data_ptr(),))
    launches_mma += 1
    return out


def snake_alias_bwd_cuda(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                         dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels: (dx in x's dtype, dalpha and dbeta in
    float32 [C]) for the cotangent dy of snake_alias_cuda(x, alpha, beta).
    dalpha/dbeta are reduced without atomics (bitwise reproducible).
    Launches on the current stream; does not synchronize."""
    global launches_bwd
    _check_input("snake_alias_bwd_cuda", x, alpha, beta)
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"dy must match x: {tuple(dy.shape)} on {dy.device} vs "
                         f"{tuple(x.shape)} on {x.device}")
    b, c, t = x.shape
    dy = dy.to(x.dtype).contiguous()
    alpha, beta = _param(alpha, x.device), _param(beta, x.device)
    lib = _library_bwd()
    tiles = -(-t // lib.snake_alias_backward_tile())
    dx = torch.empty_like(x)
    parts = torch.empty((2, c, b * tiles), dtype=torch.float32, device=x.device)
    grads = torch.empty((2, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.snake_alias_backward(
            x.data_ptr(), dy.data_ptr(), dx.data_ptr(), parts[0].data_ptr(),
            parts[1].data_ptr(), alpha.data_ptr(), beta.data_ptr(), grads[0].data_ptr(),
            grads[1].data_ptr(), _taps(), int(x.dtype == torch.bfloat16), b, c, t, stream)
    if err:
        raise RuntimeError(f"snake_alias backward kernel launch failed: "
                           f"{lib.snake_alias_backward_error_string(err).decode()}")
    launches_bwd += 1
    return dx, grads[0], grads[1]


def snake_alias_bwd_plain(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                          dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward: torch.autograd.grad through snake_alias_fused_cm."""
    with torch.enable_grad():
        x, alpha, beta = (t.detach().requires_grad_(True) for t in (x, alpha, beta))
        y = snake_alias_fused_cm(x, alpha, beta)
        return torch.autograd.grad(y, (x, alpha, beta), dy)


class SnakeAliasFunction(torch.autograd.Function):
    """SnakeAlias through the kernels: the forward kernel, and the backward
    kernel for (dx, dalpha, dbeta). Saves x, alpha and beta only; the
    T-sized phases are recomputed in the backward."""

    @staticmethod
    def forward(ctx, x, alpha, beta):
        ctx.save_for_backward(x, alpha, beta)
        return snake_alias_cuda(x, alpha, beta)

    @staticmethod
    def backward(ctx, dy):
        x, alpha, beta = ctx.saved_tensors
        dx, dalpha, dbeta = snake_alias_bwd_cuda(x, alpha, beta, dy.contiguous())
        return dx, dalpha.to(alpha.dtype), dbeta.to(beta.dtype)


def _wants_grad(variant: str, x: torch.Tensor, alpha: torch.Tensor,
                beta: torch.Tensor) -> bool:
    """Whether autograd records a graph for this call; refuses an unknown
    variant, and a forward-only one where it does."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    grad = torch.is_grad_enabled() and (x.requires_grad or alpha.requires_grad
                                        or beta.requires_grad)
    if grad and variant != "direct":
        raise RuntimeError(f'snake_alias variant "{variant}" is forward only; use '
                           f'"direct" where a gradient is wanted')
    return grad


def snake_alias_kernel(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                       variant: str = "direct") -> torch.Tensor:
    """The kernel route: through SnakeAliasFunction when autograd records a
    graph for any input (variant "direct" only: the others have no
    backward), else one forward launch of the variant's kernel. "strips"
    takes the shapes `use_strips` names and leaves the others to the direct
    kernel; "mma" takes every shape."""
    if _wants_grad(variant, x, alpha, beta):
        return SnakeAliasFunction.apply(x, alpha, beta)
    if variant == "mma":
        return snake_alias_mma_cuda(x, alpha, beta)
    if variant == "strips" and use_strips(x.shape[1], x.shape[2], x.shape[0]):
        return snake_alias_strips_cuda(x, alpha, beta)
    return snake_alias_cuda(x, alpha, beta)


def snake_alias(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                variant: str = "direct") -> torch.Tensor:
    """SnakeAlias with exact edges on [B, C, T]: the kernels for a CUDA
    tensor, the plain version (differentiated by autograd) for a CPU tensor.
    Every variant computes the same function."""
    if x.device.type == "cpu":
        _wants_grad(variant, x, alpha, beta)
        return snake_alias_fused_cm(x, alpha, beta)
    return snake_alias_kernel(x, alpha, beta, variant)
