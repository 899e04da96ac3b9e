"""Tracing and step timing (JAX utils/profiling.py; the reference has none).

`trace(log_dir)` records a torch.profiler Chrome trace of its block into
`log_dir`: the host's operators, and the card's kernels and copies when
CUDA is present; `start_trace` / `stop_trace` are the same session opened
and closed at two points of a loop. `span(name)` names a region of the
program (`annotate` is the JAX package's name for it). `StepTimer` times
steps on the wall clock, after waiting for the card, and keeps a moving
window.

Spans are on exactly while a torch.profiler session is active. Off, a span
is one flag check and a shared null context: it builds no `record_function`
and records nothing. On, it opens a `record_function` range of its name (so
it lands in the Chrome trace beside the kernels) and, when it closes,
appends a `Span` to a bounded in-memory record that `spans()` returns. Its
times come from `time.time_ns()`, the Unix clock that the profiler's CPU
timestamps are converted to, so the record and a trace share one clock up
to a constant per process. A span never waits for the card and never
touches a tensor.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

RECORD_LEN = 50_000  # spans kept, newest last: some 4,000 pushes or steps


class Span(NamedTuple):
    """One closed span: `unit` is shared by every span of one push or step
    (the outermost span's, inherited by its children); `parent` is the
    enclosing span's id, or None."""
    name: str
    id: int
    parent: int | None
    unit: int | None
    t0_ns: int
    t1_ns: int


_record: collections.deque[Span] = collections.deque(maxlen=RECORD_LEN)
_ids = itertools.count(1)
_open = threading.local()  # .stack: this thread's open spans, innermost last
_OFF = contextlib.nullcontext()


class _Open:
    """A span while a profiler session is active."""

    __slots__ = ("name", "unit", "id", "parent", "t0", "rf")

    def __init__(self, name: str, unit: int | None):
        self.name, self.unit = name, unit

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        outer = stack[-1] if stack else None
        self.parent = outer.id if outer is not None else None
        if self.unit is None and outer is not None:
            self.unit = outer.unit
        self.id = next(_ids)
        stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.rf.__exit__(*exc)
        _open.stack.pop()
        _record.append(Span(self.name, self.id, self.parent, self.unit, self.t0, t1))
        return False


def span(name: str, unit: int | None = None):
    """A named region of the program: a no-op unless a torch.profiler
    session is active (then a trace range and a `Span` in `spans()`).
    `unit` ids a push or step; nested spans take their parent's."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, unit)


def annotate(name: str, unit: int | None = None):
    """The JAX package's name for `span`."""
    return span(name, unit)


def spans() -> list[Span]:
    """The recorded spans, in the order they closed (children before their
    parent), at most RECORD_LEN of the newest."""
    return list(_record)


def self_ns(s: Span, record: list[Span]) -> int:
    """The span's duration less the part of it that its children in
    `record` cover."""
    covered, end = 0, s.t0_ns
    for c in sorted((c for c in record if c.parent == s.id), key=lambda c: c.t0_ns):
        a, b = max(c.t0_ns, end), min(c.t1_ns, s.t1_ns)
        if b > a:
            covered += b - a
            end = b
    return s.t1_ns - s.t0_ns - covered


def start_trace(cuda: bool | None = None, on_trace_ready=None):
    """A started torch.profiler session of the host's operators and, with
    `cuda` (default: when CUDA is present), the card's kernels and copies."""
    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts, on_trace_ready=on_trace_ready)
    prof.start()
    return prof


def stop_trace(prof, path: str | None = None, device=None) -> None:
    """Waits for `device`'s work (default: the current card's, when CUDA is
    present), so that it ends inside the trace, stops the session and, with
    `path`, writes its Chrome trace there."""
    if device is None:
        wait = torch.cuda.is_available()
    else:
        device = torch.device(device)
        wait = device.type == "cuda"
    if wait:
        torch.cuda.synchronize(device)
    prof.stop()
    if path is not None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        prof.export_chrome_trace(path)


@contextlib.contextmanager
def trace(log_dir: str | None):
    """A torch.profiler trace of the block, written on exit to
    `log_dir/<host>_<pid>.<ns>.pt.trace.json` (Perfetto or chrome://tracing
    shows it; utils/device_trace.py reads it); does nothing when `log_dir` is
    None. Yields the profiler, or None."""
    if log_dir is None:
        yield None
        return
    prof = start_trace(on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    try:
        yield prof
    finally:
        stop_trace(prof)


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
