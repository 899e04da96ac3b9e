"""Median host time of the program's `svc.extract` span over the profiled
slice's pushes, in ms: the three streaming extractors, their read-backs,
CREPE's trellis and the emission, before the synthesis (trace/program.py
places the spans). None when the program keeps no such span."""

import statistics

from benchmark.trace.program import slice_units


def read(ctx):
    al = slice_units(ctx, "bench.push_audio", "svc.push_audio")
    if al is None:
        return None
    ms = [(s.t1_ns - s.t0_ns) / 1e6 for s in al.spans if s.name == "svc.extract"]
    return statistics.median(ms) if ms else None
