"""Device-idle ms per push inside the program's `svc.extract` span (and so
inside its stages, `svc.extract.whisper`, `.hubert`, `.crepe` with its
host trellis, and `.emit`): the card waiting on the extractors' host work
and read-backs (trace/program.py)."""

from benchmark.trace.program import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, "bench.push_audio", "svc.push_audio", ("svc.extract",))
