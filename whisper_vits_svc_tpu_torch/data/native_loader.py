"""ctypes binding to the native C++ loader (native/svc_loader.cc).

The library is compiled from the repo's `native/svc_loader.cc` at first use,
with the flags of `native/Makefile`, into `build/native/` (ignored by git),
keyed by the hash of the source; nothing is written under `native/`. Without
a C++ compiler every entry point returns None and the dataset takes its numpy
route; `route()` says which one runs. This is host file I/O: the per-item
wav and npy reads of a training batch, with the npy reads of one item spread
over a C++ thread pool that runs without the GIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "svc_loader.cc"
BUILD_DIR = _REPO / "build" / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
MAX_WAV_SECONDS = 600.0
MAX_NPY_ELEMS = 1 << 24  # per file of a batch read
_lock = threading.Lock()
_lib = None
_tried = False


def lib_path() -> Path:
    """Where the library for the current source and flags is built."""
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libsvc_loader-{digest}.so"


def _build(lib: Path) -> bool:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None or not SOURCE.is_file():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def get_lib():
    """The loaded CDLL, building it first if need be, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not SOURCE.is_file():
            return None
        lib_file = lib_path()
        if not lib_file.is_file() and not _build(lib_file):
            return None
        try:
            lib = ctypes.CDLL(str(lib_file))
        except OSError:
            return None
        lib.svc_load_wav.restype = ctypes.c_int
        lib.svc_load_wav.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.svc_load_npy_many.restype = None
        lib.svc_load_npy_many.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def route() -> str:
    """"native" when the C++ loader serves the reads, else "numpy"."""
    return "native" if available() else "numpy"


def load_wav_native(path: str, sr_hint: int = 32000):
    """-> (float32 audio, sr), or None on any failure (the caller falls back)."""
    lib = get_lib()
    if lib is None:
        return None
    # a 16-bit PCM wav holds at most size / 2 samples: size the buffer from
    # the file, not from the worst case
    try:
        max_len = min(int(MAX_WAV_SECONDS * sr_hint), os.path.getsize(path) // 2 + 16)
    except OSError:
        return None
    buf = np.empty(max_len, np.float32)
    out_len = ctypes.c_int64(0)
    out_sr = ctypes.c_int32(0)
    rc = lib.svc_load_wav(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_len, ctypes.byref(out_len), ctypes.byref(out_sr),
    )
    if rc != 0:
        return None
    n = min(out_len.value, max_len)
    return buf[:n].copy(), int(out_sr.value)


def load_npy_native(path: str) -> np.ndarray | None:
    """One float32 .npy file through `load_npy_batch`, or None on any
    failure."""
    return load_npy_batch([path])[0]


def load_npy_batch(paths: list[str]) -> list[np.ndarray | None]:
    """Thread-pooled load of several float32 little-endian C-order .npy
    files; None for each one that fails, other dtypes included (or for all
    of them without the library). Each buffer is sized from its file (f32
    data bytes <= file size), capped at MAX_NPY_ELEMS; the C side picks the
    thread count."""
    lib = get_lib()
    if lib is None:
        return [None] * len(paths)
    n = len(paths)

    def _cap(p):
        # a missing path gets a token buffer; the loader reports it in status
        try:
            return min(MAX_NPY_ELEMS, os.path.getsize(p) // 4 + 16)
        except OSError:
            return 16

    caps = [_cap(p) for p in paths]
    bufs = [np.empty(c, np.float32) for c in caps]
    shapes = np.zeros(n * 4, np.int64)
    ndims = np.zeros(n, np.int32)
    status = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_outs = (ctypes.POINTER(ctypes.c_float) * n)(
        *[b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for b in bufs]
    )
    c_max = (ctypes.c_int64 * n)(*caps)
    lib.svc_load_npy_many(
        c_paths, c_outs, c_max,
        shapes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ndims.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, 0,  # threads: the hardware count
    )
    out = []
    for i in range(n):
        if status[i] != 0:
            out.append(None)
            continue
        shp = tuple(int(s) for s in shapes[4 * i : 4 * i + ndims[i]])
        total = int(np.prod(shp))
        if total > caps[i]:
            # more elements declared than the buffer holds: the C side
            # truncated the data, so this entry failed
            out.append(None)
            continue
        out.append(bufs[i][:total].reshape(shp).copy())
    return out
