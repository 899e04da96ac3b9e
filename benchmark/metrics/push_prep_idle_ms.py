"""Device-idle ms per push inside the program's `svc.push.prep`, `.upload`
and `.source` spans and the self time of `svc.push`: the card waiting on
the push's host work around the synthesizer (numpy padding, the noise draw,
the copies, the excitation) (trace/program.py)."""

from benchmark.trace.program import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, "bench.push", "svc.push",
                            ("svc.push.prep", "svc.push.upload", "svc.push.source"),
                            self_of=("svc.push",))
