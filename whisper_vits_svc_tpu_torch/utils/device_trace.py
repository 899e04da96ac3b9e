"""Device time per call from a torch.profiler trace (JAX
utils/device_trace.py, which reads the spans of the XLA trace's programs).

Here a span is one kernel on the card: an event of category "kernel" in the
Chrome trace that `utils/profiling.py::trace` writes. A kernel matches a
name prefix when its base name starts with it: the demangled name less its
return type and its namespaces, so that "snake_alias" matches the snake
kernel, traced as "void (anonymous namespace)::snake_alias_kernel<float>(
float const*, ...)" (and the other `snake_alias_*` kernels, which inference
does not launch). On the CPU a trace holds no kernel, and every function
here returns None.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
import tempfile
from typing import Callable

from .profiling import trace

__all__ = ["device_ms_per_call", "device_total_ms", "measure_device_ms",
           "measure_device_total_ms"]


def kernel_base_name(name: str) -> str:
    """"void ns::(anonymous namespace)::k<T>(args)" -> "k<T>(args)"."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", name, maxsplit=1)[0]
    return name[head.rfind("::") + 2:] if "::" in head else name


def _kernel_spans(trace_dir: str, name_prefixes: tuple[str, ...]) -> list[float]:
    """Durations (us) of the matching kernels in the newest trace of
    `trace_dir`; empty if there is no trace."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "*.pt.trace.json*")))
    if not paths:
        return []
    with (gzip.open if paths[-1].endswith(".gz") else open)(paths[-1], "rt") as f:
        events = json.load(f).get("traceEvents", [])
    return [e["dur"] for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"
            and kernel_base_name(e.get("name", "")).startswith(name_prefixes)]


def device_ms_per_call(trace_dir: str, name_prefix: str) -> float | None:
    """Mean device duration (ms) of the kernels matching `name_prefix` in the
    trace, or None if there is no trace or no such kernel."""
    spans = _kernel_spans(trace_dir, (name_prefix,))
    return sum(spans) / len(spans) / 1e3 if spans else None


def device_total_ms(trace_dir: str, name_prefixes: tuple[str, ...]) -> float | None:
    """Total device duration (ms) of the kernels matching any of
    `name_prefixes` (for a walk of several kinds, such as every kernel of a
    chunk), or None."""
    spans = _kernel_spans(trace_dir, tuple(name_prefixes))
    return sum(spans) / 1e3 if spans else None


def measure_device_total_ms(run_calls: Callable[[], None],
                            name_prefixes: tuple[str, ...]) -> float | None:
    """Trace `run_calls()` and return the total device ms of the matching
    kernels (device_total_ms)."""
    with tempfile.TemporaryDirectory(prefix="device_trace_") as d:
        with trace(d):
            run_calls()
        return device_total_ms(d, tuple(name_prefixes))


def measure_device_ms(run_calls: Callable[[], None], name_prefix: str) -> float | None:
    """Trace `run_calls()` and return the mean device ms of a matching kernel
    (device_ms_per_call): `measure_device_ms(fn, "snake_alias")` is the snake
    kernel's time per launch over fn's launches."""
    with tempfile.TemporaryDirectory(prefix="device_trace_") as d:
        with trace(d):
            run_calls()
        return device_ms_per_call(d, name_prefix)
