"""Tracing and step timing (JAX utils/profiling.py; the reference has none).

`trace(log_dir)` records a torch.profiler Chrome trace of its block into
`log_dir`: the host's operators, and the card's kernels and copies when
CUDA is present. `annotate(name)` names a region of that trace. `StepTimer`
times steps on the wall clock, after waiting for the card, and keeps a
moving window.
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str | None):
    """A torch.profiler trace of the block, written on exit to
    `log_dir/<host>_<pid>.<ns>.pt.trace.json` (Perfetto or chrome://tracing
    shows it; utils/device_trace.py reads it); does nothing when `log_dir` is
    None. Yields the profiler, or None."""
    if log_dir is None:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()  # the block's kernels end inside the trace


def annotate(name: str):
    """A named region of the trace (a torch.profiler record_function)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step times; `stop` first waits for the card to finish the
    work of the tensors it is given. Keeps the last `window` times."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, *sync_on) -> float:
        for device in {x.device for x in sync_on if isinstance(x, torch.Tensor) and x.is_cuda}:
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)
