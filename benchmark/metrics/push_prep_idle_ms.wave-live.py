"""Device-idle ms per wave push inside the program's `svc.push.prep`,
`.upload` and `.source` spans and the self time of `svc.push`, within
`svc.push_audio` (trace/program.py): `push_prep_idle_ms.py` of the live
cell, on the wave cell's units."""

from benchmark.trace.program import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, "bench.push_audio", "svc.push_audio",
                            ("svc.push.prep", "svc.push.upload", "svc.push.source"),
                            self_of=("svc.push",))
