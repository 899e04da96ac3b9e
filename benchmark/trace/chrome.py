"""Read torch.profiler's Chrome trace: what ran on the device, when the device
was idle, and what the host was doing then.

Device operations are the events of category "kernel", "gpu_memcpy" and
"gpu_memset" (not the "gpu_user_annotation" projections of host ranges).
The window is the host range (`record_function`) named by the caller. Busy
time is the union of the device operations' intervals clipped to the
window, so that overlapping kernels on several streams count once; idle
gaps are the rest of the window. A gap is labelled by the innermost host
range of the benchmark (names starting with "bench.") and the innermost
host operation (aten op or CUDA runtime call) open at its middle.

A kernel's base name drops the return type, the namespaces and the
arguments: "void (anonymous namespace)::snake_alias_kernel<float>(float
const*, ...)" is "snake_alias_kernel<float>" (the rule of the program's
utils/device_trace.py, copied so that the yardstick does not move with it).
"""

from __future__ import annotations

import gzip
import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OP_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
SPAN_PREFIX = "bench."


def kernel_base_name(name: str) -> str:
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", name, maxsplit=1)[0]
    if "::" in head:
        name = name[head.rfind("::") + 2 :]
    depth, out = 0, []
    for ch in name:  # cut the argument list, keep the template arguments
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        out.append(ch)
    return "".join(out)


def load_events(path: str) -> list[dict]:
    with (gzip.open if path.endswith(".gz") else open)(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """The device's work and idle time inside the host range `window_name`."""

    def __init__(self, events: list[dict], window_name: str):
        spans = [e for e in events if e.get("ph") == "X" and e.get("name") == window_name
                 and e.get("cat") == "user_annotation"]
        if not spans:
            raise ValueError(f"no host range {window_name!r} in the trace")
        w = max(spans, key=lambda e: e["dur"])
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.device: list[tuple[float, float, str]] = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
            a, b = max(a, self.t0), min(b, self.t1)
            if b > a:
                self.device.append((a, b, kernel_base_name(e.get("name", ""))))
        self.host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("cat"),
                      e.get("name", ""))
                     for e in events if e.get("ph") == "X"
                     and (e.get("cat") in HOST_OP_CATS
                          or (e.get("cat") == "user_annotation"
                              and e.get("name", "").startswith(SPAN_PREFIX)))]
        self.busy = _union([(a, b) for a, b, _ in self.device])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def gaps(self) -> list[tuple[float, float]]:
        out, t = [], self.t0
        for a, b in self.busy:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def kernel_s(self, prefixes: tuple[str, ...]) -> float:
        """Device seconds of the operations whose base name starts with any
        of `prefixes`."""
        return sum(b - a for a, b, name in self.device if name.startswith(prefixes)) / 1e6

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for a, b, name in self.device:
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def label(self, t: float) -> str:
        span = op = None
        for a, b, cat, name in self.host:
            if a <= t <= b:
                if cat == "user_annotation":
                    if span is None or a >= span[0]:
                        span = (a, name)
                elif op is None or a >= op[0]:
                    op = (a, name)
        return f"{span[1] if span else 'host'} > {op[1] if op else 'python'}"

    def top_gaps(self, n: int = 10) -> list[list]:
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return [[self.label((a + b) / 2), (b - a) / 1e6] for a, b in gaps]
