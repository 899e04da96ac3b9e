"""Share of the profiled slice's pushes, in %, whose `svc.push.forward`
span holds a `svc.push.forward.replay` span: the pushes whose synthesizer
forward was one CUDA graph replay rather than its ops issued one by one
(trace/program.py places the spans). None when the program keeps no spans,
or has no graph counters (a program without the replay)."""

from benchmark.trace.program import slice_units


def read(ctx):
    try:
        from whisper_vits_svc_tpu_torch.infer import stream
    except ImportError:
        return None
    if not hasattr(stream, "graph_replays"):
        return None
    al = slice_units(ctx, "bench.push", "svc.push")
    if al is None:
        return None
    forwards = {s.id for s in al.spans if s.name == "svc.push.forward"}
    replayed = {s.parent for s in al.spans if s.name == "svc.push.forward.replay"} & forwards
    return 100.0 * len(replayed) / len(al.units)
