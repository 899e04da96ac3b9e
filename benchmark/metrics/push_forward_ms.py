"""Median host time of the program's `svc.push.forward` span over the
profiled slice's pushes, in ms: the host issuing the synthesizer's ops (the
card runs them behind it). Read from the program's span record placed on
the trace (trace/program.py); None without it."""

import statistics

from benchmark.trace.program import slice_units


def read(ctx):
    al = slice_units(ctx, "bench.push", "svc.push")
    if al is None:
        return None
    ms = [(s.t1_ns - s.t0_ns) / 1e6 for s in al.spans if s.name == "svc.push.forward"]
    return statistics.median(ms) if ms else None
