"""Wrapper of the Viterbi trellis CUDA kernel (csrc/viterbi_trellis.cu).

Replaces the JAX package's `lax.scan` whisper_vits_svc_tpu/models/crepe.py::
_viterbi_trellis (no Pallas kernel there): CREPE's decode over 360 pitch
bins, n frames in one launch of one block. One frame is
scores[from, to] = value[from] + log_trans[from, to]; its pointers are the
first argmax over `from` (numpy's and torch's tie rule), its value the
maximum plus the frame's log observation, all in float32. The kernel reads
the transition matrix as a band of radius RADIUS and one number for every
entry outside it (`banded` checks that form on the matrix it is given, bit
for bit, and raises otherwise) and makes every score with the plain
version's float32 add, so values and pointers are bitwise equal to it
(see the note in the source). It is built and bound by
ops/cuda_build.py.

`viterbi_trellis` takes the plain PyTorch version (`viterbi_trellis_plain`,
a loop of one 360 x 360 add, max and argmax a frame) only for a CPU
tensor; for a CUDA tensor it launches the kernel or raises. Either returns
(value [BINS] float32, the value after the last frame; pointers [n', BINS]
int16, those of its n' steps) on the input's device. A call continues from
the value it is given, or, given none, starts at the first frame plus
log(1/360). `launches_trellis` counts kernel launches (`counts`,
`add_counts`; utils/counters.py).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..utils import counters
from .cuda_build import CSRC, load_library

SOURCE = CSRC / "viterbi_trellis.cu"
BINS = 360      # the kernel's bins (CREPE's pitch bins), one thread each
RADIUS = 11     # the band: |from - to| <= RADIUS
# the first frame's prior, log(1/360), in float32
INIT = np.float32(np.log(1.0 / BINS))

launches_trellis = 0
counts, add_counts = counters.declare(__name__, "launches_trellis")


@lru_cache(maxsize=None)
def _band_index() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(src, to, inside), each [BINS, 2 RADIUS + 1]: band entry [to, k] is
    the matrix's entry [src, to]; `inside` where src lies in [0, BINS)."""
    to = np.broadcast_to(np.arange(BINS)[:, None], (BINS, 2 * RADIUS + 1))
    src = to - RADIUS + np.arange(2 * RADIUS + 1)[None, :]
    return src, to, (src >= 0) & (src < BINS)


class BandedTransition:
    """A [BINS, BINS] log transition matrix, indexed [from, to], as the
    kernel reads it: `band` [BINS, 2 RADIUS + 1] float32 with band[to, k] =
    log_trans[to - RADIUS + k, to] (entries whose source lies outside
    [0, BINS) hold `far` and are not read), and `far`, every entry with
    |from - to| > RADIUS. `matrix` is the full matrix rebuilt from the two,
    the plain version's operand."""

    def __init__(self, band: np.ndarray, far: np.float32):
        self.band = np.ascontiguousarray(band, np.float32)
        self.far = np.float32(far)
        src, to, inside = _band_index()
        self.matrix = np.full((BINS, BINS), self.far, np.float32)
        self.matrix[src[inside], to[inside]] = self.band[inside]
        self._on: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def on(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """(band, matrix) as tensors on `device`, made once a device."""
        if device not in self._on:
            self._on[device] = (torch.from_numpy(self.band).to(device),
                                torch.from_numpy(self.matrix).to(device))
        return self._on[device]


def banded(log_trans: np.ndarray) -> BandedTransition:
    """`log_trans` [BINS, BINS] float32 in the kernel's form, or ValueError
    where the band and the one far number do not rebuild it bit for bit."""
    log_trans = np.asarray(log_trans)
    if log_trans.shape != (BINS, BINS) or log_trans.dtype != np.float32:
        raise ValueError(f"the trellis takes a float32 [{BINS}, {BINS}] transition matrix, "
                         f"got {log_trans.dtype} {log_trans.shape}")
    src, to, inside = _band_index()
    far = log_trans[0, BINS - 1]
    trans = BandedTransition(np.where(inside, log_trans[np.clip(src, 0, BINS - 1), to], far),
                             far)
    if not np.array_equal(trans.matrix.view(np.int32), log_trans.view(np.int32)):
        bad = np.argwhere(trans.matrix.view(np.int32) != log_trans.view(np.int32))[0]
        raise ValueError(f"the transition matrix is not banded: entry {tuple(bad)} outside "
                         f"|from - to| <= {RADIUS} is not the far entry {trans.far!r}")
    return trans


def viterbi_trellis_plain(obs: torch.Tensor, value: torch.Tensor | None,
                          trans: BandedTransition) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version on obs' device. Given `value` [BINS], the value
    before obs[0], every frame of obs [n, BINS] is a step from it (n' = n);
    without, the trellis starts at obs[0] + INIT and steps over the rest
    (n' = n - 1)."""
    _, log_trans = trans.on(obs.device)
    if value is None:
        value, obs = obs[0] + INIT, obs[1:]
    ptrs = torch.empty((len(obs), BINS), dtype=torch.int16, device=obs.device)
    for t in range(len(obs)):
        scores = value[:, None] + log_trans
        ptrs[t] = scores.argmax(dim=0)
        value = scores.amax(dim=0) + obs[t]
    return value, ptrs


@lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    ptr = ctypes.c_void_p
    return load_library(
        SOURCE, "viterbi_trellis_forward",
        [ptr] * 5 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ptr],
        "viterbi_trellis_error_string")


def _check(obs: torch.Tensor, value: torch.Tensor | None) -> None:
    if not obs.is_cuda:
        raise ValueError(f"viterbi_trellis_cuda needs a CUDA tensor, got {obs.device}")
    if obs.dtype != torch.float32 or obs.dim() != 2 or obs.shape[1] != BINS:
        raise ValueError(f"viterbi_trellis_cuda takes float32 [n, {BINS}] observations, "
                         f"got {obs.dtype} {tuple(obs.shape)}")
    if not (1 <= len(obs) < 2**31 // BINS):
        raise ValueError(f"viterbi_trellis_cuda: unsupported frame count {len(obs)}")
    if value is not None and (value.dtype != torch.float32 or value.shape != (BINS,)
                              or value.device != obs.device):
        raise ValueError(f"the value to continue from must be float32 [{BINS}] on {obs.device}, "
                         f"got {value.dtype} {tuple(value.shape)} on {value.device}")


def viterbi_trellis_cuda(obs: torch.Tensor, value: torch.Tensor | None,
                         trans: BandedTransition) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel on obs [n, BINS] (CUDA, float32, n >= 1),
    arguments and results as `viterbi_trellis_plain`, bitwise equal to it.
    Launches on the current stream; does not synchronize."""
    global launches_trellis
    _check(obs, value)
    obs = obs.contiguous()
    first = value is None
    band, _ = trans.on(obs.device)
    value_out = torch.empty(BINS, dtype=torch.float32, device=obs.device)
    ptrs = torch.empty((len(obs) - first, BINS), dtype=torch.int16, device=obs.device)
    value_in = value_out if first else value.contiguous()  # not read from the first frame
    lib = _library()
    with torch.cuda.device(obs.device):
        stream = torch.cuda.current_stream(obs.device).cuda_stream
        err = lib.viterbi_trellis_forward(
            obs.data_ptr(), value_in.data_ptr(), band.data_ptr(), value_out.data_ptr(),
            ptrs.data_ptr(), float(trans.far), float(INIT), len(obs), int(first), stream)
    if err:
        raise RuntimeError(f"viterbi_trellis kernel launch failed: "
                           f"{lib.viterbi_trellis_error_string(err).decode()}")
    launches_trellis += 1
    return value_out, ptrs


def viterbi_trellis(obs: torch.Tensor, value: torch.Tensor | None,
                    trans: BandedTransition) -> tuple[torch.Tensor, torch.Tensor]:
    """The trellis over obs [n, BINS] float32, from `value` or from obs[0]:
    the kernel for a CUDA tensor, the plain version for a CPU tensor;
    (value, pointers) as `viterbi_trellis_plain` gives them."""
    if obs.device.type == "cpu":
        return viterbi_trellis_plain(obs, value, trans)
    return viterbi_trellis_cuda(obs, value, trans)
