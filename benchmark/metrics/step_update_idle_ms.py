"""Device-idle ms per training step inside the program's `svc.step.update`
span: grad norms, the clamp, the accumulation and both AdamWs
(trace/program.py)."""

from benchmark.trace.program import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, "bench.step", "svc.step", ("svc.step.update",))
