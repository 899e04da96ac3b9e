"""Device-idle ms per push inside the program's `svc.push.forward` span:
the card waiting while the host dispatches the synthesizer (trace/program.py)."""

from benchmark.trace.program import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, "bench.push", "svc.push", ("svc.push.forward",))
