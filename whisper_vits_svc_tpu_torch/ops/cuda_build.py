"""Build and load of the package's CUDA kernels (csrc/*.cu), shared by the
kernel wrappers (snake_cuda, amp_cuda, viterbi_cuda, crepe_conv_cuda).

Each source is compiled at first use with nvcc into a plain C ABI shared
library under <repo>/build/kernels/, keyed by the hash of the source, the
headers beside it and the flags, and bound with ctypes; `build` starts one
nvcc per source, all at once. `tickets` holds the zeroed integer tickets
that a kernel's last block takes to sum its split slots in a fixed order.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    """The CUDA compiler: on the PATH, else under CUDA_HOME (/usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the kernels are built with the CUDA toolkit")
    return path


def all_sources() -> tuple[Path, ...]:
    """Every kernel source of the package."""
    return tuple(sorted(CSRC.glob("*.cu")))


def _lib_path(source: Path) -> Path:
    """Where `build` puts the library of `source`."""
    headers = sorted(source.parent.glob("*.cuh"))
    text = source.read_bytes() + b"".join(h.read_bytes() for h in headers)
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


def param(p: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A kernel's parameter argument: `p` as float32, contiguous, on `device`."""
    return p.detach().to(device=device, dtype=torch.float32).contiguous()


_tickets: dict[tuple[torch.device, int], torch.Tensor] = {}


def tickets(device: torch.device, n: int, stream: int) -> torch.Tensor:
    """Integer tickets on `device` for `stream`: int32, at least n, zero
    between launches (a kernel that takes them sets each back to 0), so
    the kernels of one stream share one buffer, made at first use."""
    buf = _tickets.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[(device, stream)] = buf
    return buf
