"""Wrapper of the fused anti-aliased snake CUDA kernel (csrc/snake_alias.cu).

Replaces the TPU kernel whisper_vits_svc_tpu/ops/pallas_snake.py::
snake_alias_cm_pallas. The source is compiled at first use with nvcc into a
plain C ABI shared library under <repo>/build/kernels/ (keyed by the
source's hash) and bound with ctypes. The kernel is bound by HBM bytes: one
read of x and one write of the output (see the note in the source).

`snake_alias` takes the plain PyTorch version (nn/snake.py) only for a CPU
tensor; for a CUDA tensor it launches the kernel or raises. `launches`
counts kernel launches.
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

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "snake_alias.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

launches = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the snake kernel is built with the CUDA toolkit")
    return path


def build() -> Path:
    """Compile csrc/snake_alias.cu into build/kernels/ (once per source
    version) and return the library's path."""
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"libsnake_alias-{digest}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)], check=True)
        os.replace(tmp, lib)
    return lib


@lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
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
def _taps():
    ae, ao, oe, oo, de, do_, doe, doo = _polyphase_taps(12, 12)
    assert (oe, oo, doe, doo) == (-3, -2, -2, -3), "kernel assumes the k=12 geometry"
    assert len(ae) == len(ao) == len(de) == len(do_) == 6
    return (ctypes.c_float * 24)(*np.concatenate([ae, ao, de, do_]).tolist())


def snake_alias_cuda(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on x [B, C, T] (CUDA, contiguous, float32 or
    bfloat16; math in float32), alpha/beta [C]. Returns a new tensor of x's
    dtype. Launches on the current stream; does not synchronize."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"snake_alias_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"snake_alias_cuda takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"snake_alias_cuda needs a contiguous [B, C, T] tensor, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    b, c, t = x.shape
    if not (0 < b <= 65535 and 0 < c <= 65535 and 0 < t < 2**31 - 2048):
        raise ValueError(f"snake_alias_cuda: unsupported shape {tuple(x.shape)}")
    if alpha.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"alpha/beta must be [{c}], got {tuple(alpha.shape)}, "
                         f"{tuple(beta.shape)}")
    alpha = alpha.detach().to(device=x.device, dtype=torch.float32).contiguous()
    beta = beta.detach().to(device=x.device, dtype=torch.float32).contiguous()
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


def snake_alias(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """SnakeAlias with exact edges on [B, C, T]: the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return snake_alias_fused_cm(x, alpha, beta)
    return snake_alias_cuda(x, alpha, beta)
