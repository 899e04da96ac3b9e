"""Device-idle ms per training step inside the program's `svc.step.upload`,
`.g_forward`, `.audio_losses` (D's forward among them) and `.kl` spans: the
card waiting while the host issues the step's forward (trace/program.py)."""

from benchmark.trace.program import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, "bench.step", "svc.step",
                            ("svc.step.upload", "svc.step.g_forward", "svc.step.audio_losses",
                             "svc.step.kl"))
