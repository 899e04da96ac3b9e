"""Wrappers of the fused anti-aliased snake CUDA kernels (csrc/snake_alias.cu,
csrc/snake_alias_bwd.cu) and their autograd Function.

Replace the TPU kernels whisper_vits_svc_tpu/ops/pallas_snake.py::
snake_alias_cm_pallas (forward) and ::snake_alias_cm_pallas_bwd (backward).
Each source is compiled at first use with nvcc into a plain C ABI shared
library under <repo>/build/kernels/ (keyed by the source's hash) and bound
with ctypes; `build` starts one nvcc per source, all at once. Both kernels
are bound by HBM bytes (see the notes in the sources).

`snake_alias` takes the plain PyTorch version (nn/snake.py) only for a CPU
tensor; for a CUDA tensor it launches the kernels or raises. When a gradient
is wanted it goes through `SnakeAliasFunction`, which saves only x, alpha
and beta (as the JAX custom VJP does) and runs the backward kernel; without
one (e.g. under torch.inference_mode) it launches the forward alone.
`launches` and `launches_bwd` count kernel launches.
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
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

launches = 0
launches_bwd = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the snake kernels are built with the CUDA toolkit")
    return path


def _lib_path(source: Path) -> Path:
    digest = hashlib.sha1(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build(*sources: Path) -> list[Path]:
    """Compile each source (default: both) into build/kernels/ once per
    source version, one nvcc process per source, all started together.
    Returns the libraries' paths."""
    sources = sources or (SOURCE, SOURCE_BWD)
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


@lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(SOURCE)[0]))
    lib.snake_alias_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.snake_alias_forward.restype = ctypes.c_int
    lib.snake_alias_error_string.argtypes = [ctypes.c_int]
    lib.snake_alias_error_string.restype = ctypes.c_char_p
    return lib


@lru_cache(maxsize=None)
def _library_bwd() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(SOURCE_BWD)[0]))
    lib.snake_alias_backward.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.snake_alias_backward.restype = ctypes.c_int
    lib.snake_alias_backward_tile.argtypes = []
    lib.snake_alias_backward_tile.restype = ctypes.c_int
    lib.snake_alias_backward_error_string.argtypes = [ctypes.c_int]
    lib.snake_alias_backward_error_string.restype = ctypes.c_char_p
    return lib


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


def snake_alias_cuda(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Launch the forward kernel on x [B, C, T] (CUDA, contiguous, float32
    or bfloat16; math in float32), alpha/beta [C]. Returns a new tensor of
    x's dtype. Launches on the current stream; does not synchronize."""
    global launches
    _check_input("snake_alias_cuda", x, alpha, beta)
    b, c, t = x.shape
    alpha, beta = _param(alpha, x.device), _param(beta, x.device)
    out = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.snake_alias_forward(
            x.data_ptr(), out.data_ptr(), alpha.data_ptr(), beta.data_ptr(), _taps(),
            int(x.dtype == torch.bfloat16), b, c, t, stream)
    if err:
        raise RuntimeError(f"snake_alias kernel launch failed: "
                           f"{lib.snake_alias_error_string(err).decode()}")
    launches += 1
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


def snake_alias_kernel(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """The kernel route: through SnakeAliasFunction when autograd records a
    graph for any input, else one forward launch."""
    if torch.is_grad_enabled() and (x.requires_grad or alpha.requires_grad
                                    or beta.requires_grad):
        return SnakeAliasFunction.apply(x, alpha, beta)
    return snake_alias_cuda(x, alpha, beta)


def snake_alias(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """SnakeAlias with exact edges on [B, C, T]: the kernels for a CUDA
    tensor, the plain version (differentiated by autograd) for a CPU tensor."""
    if x.device.type == "cpu":
        return snake_alias_fused_cm(x, alpha, beta)
    return snake_alias_kernel(x, alpha, beta)
