"""Device-idle ms per training step inside the program's
`svc.step.d_backward` and `.g_backward` spans, the wall intervals of the
two `autograd.grad` calls (trace/program.py)."""

from benchmark.trace.program import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, "bench.step", "svc.step",
                            ("svc.step.d_backward", "svc.step.g_backward"))
