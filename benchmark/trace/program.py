"""The program's own spans (`utils/profiling.py` of the port: name, id,
parent, unit, t0_ns / t1_ns on the Unix clock) placed on the device trace's
axis, and the device's idle time inside them.

The Chrome trace's host timestamps are the same Unix clock less a constant
(the trace's base, and the profiler's own conversion), and `Trace` keeps
only the benchmark's ranges of the raw events. So the constant is found
from the units: the k-th program unit span (`svc.push`, `svc.step`) of the
slice is paired with the k-th driver range of the same unit (`bench.push`,
`bench.step`), which opens a few us before it. The offset is the smallest
`prog.t0 - bench.ts` over the units and their spread (largest less
smallest) is the alignment's error. The ends are not used: `bench.step`
also holds the driver's read-back of the losses after `svc.step` closes.
With the offset taken off, every program unit span has to lie inside its
driver range.

`align`, and so every reader built on it, returns None, never 0, when the
program recorded no spans (a program without them, or tracing that never
came on), when the units do not pair, when a unit span falls outside its
range, or when the spread is over MAX_SPREAD_US.
"""

from __future__ import annotations

import bisect
import sys
from types import SimpleNamespace

MAX_SPREAD_US = 200.0


def program_spans() -> list | None:
    """The program's span record, or None if the program keeps none."""
    try:
        from whisper_vits_svc_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    return spans()


def _descendants(root, children: dict) -> list:
    out, todo = [], [root]
    while todo:
        s = todo.pop()
        out.append(s)
        todo.extend(children.get(s.id, ()))
    return out


def align(trace, record, bench_name: str, prog_name: str):
    """The slice's units on the trace's axis: SimpleNamespace(units, spans,
    offset_ns, spread_us, to_us), where `units` pairs each program unit span
    with its driver range (us), `spans` holds every span of those units and
    `to_us(t_ns)` maps a program time onto the trace; or None."""
    if trace is None or not record:
        return None
    ranges = sorted((a, b) for a, b, cat, name in trace.host
                    if cat == "user_annotation" and name == bench_name)
    units = sorted((s for s in record if s.name == prog_name), key=lambda s: s.t0_ns)
    if not ranges or len(units) < len(ranges):
        return None
    units = units[-len(ranges):]  # the slice's: spans are recorded only while profiling
    lag_ns = [s.t0_ns - round(a * 1e3) for s, (a, _) in zip(units, ranges)]
    offset_ns = min(lag_ns)
    spread_us = (max(lag_ns) - offset_ns) / 1e3

    def to_us(t_ns: int) -> float:
        return (t_ns - offset_ns) / 1e3

    inside = all(a <= to_us(s.t0_ns) and to_us(s.t1_ns) <= b for s, (a, b) in zip(units, ranges))
    print(f"align {prog_name} in {bench_name}: units {len(units)} spread_us {spread_us!r} "
          f"inside {inside}", file=sys.stderr)
    if spread_us > MAX_SPREAD_US or not inside:
        return None
    children: dict = {}
    for s in record:
        children.setdefault(s.parent, []).append(s)
    spans = [d for u in units for d in _descendants(u, children)]
    return SimpleNamespace(units=list(zip(units, ranges)), spans=spans, offset_ns=offset_ns,
                           spread_us=spread_us, to_us=to_us)


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_us(trace, intervals) -> float:
    """Microseconds of the union of `intervals` (us, clipped to the trace's
    window) that no device operation covers."""
    busy = trace.busy
    starts = [a for a, _ in busy]
    total = 0.0
    for a, b in _union((max(a, trace.t0), min(b, trace.t1)) for a, b in intervals):
        covered = 0.0
        for ba, bb in busy[max(bisect.bisect_right(starts, a) - 1, 0):]:
            if ba >= b:
                break
            covered += max(0.0, min(b, bb) - max(a, ba))
        total += (b - a) - covered
    return total


def self_intervals(s, spans) -> list[tuple[int, int]]:
    """The parts of span `s` (ns) that none of its children in `spans` covers."""
    out, t = [], s.t0_ns
    for a, b in _union((c.t0_ns, c.t1_ns) for c in spans if c.parent == s.id):
        if a > t:
            out.append((t, min(a, s.t1_ns)))
        t = max(t, b)
    if s.t1_ns > t:
        out.append((t, s.t1_ns))
    return out


def slice_units(ctx, bench_name: str, prog_name: str):
    """`align` of the program's record with the trace of a reader's ctx."""
    return align(ctx.trace, program_spans(), bench_name, prog_name)


def idle_ms_per_unit(ctx, bench_name: str, prog_name: str, names: tuple[str, ...],
                     self_of: tuple[str, ...] = ()) -> float | None:
    """Device-idle ms per unit inside the spans named `names`, plus the self
    time of the spans named `self_of`, over the slice's units."""
    al = slice_units(ctx, bench_name, prog_name)
    if al is None:
        return None
    ns = [(s.t0_ns, s.t1_ns) for s in al.spans if s.name in names]
    for s in al.spans:
        if s.name in self_of:
            ns += self_intervals(s, al.spans)
    if not ns:
        return None
    idle = idle_us(ctx.trace, [(al.to_us(a), al.to_us(b)) for a, b in ns])
    return idle / 1e3 / len(al.units)
