"""Share of the profiled slice's wave pushes, in %, whose `svc.push.forward`
span holds a `svc.push.forward.replay` span: `push_graph_share.py` of the
live cell, on the wave cell's `svc.push_audio` units. None when the
program keeps no such spans, or has no graph counters."""

from benchmark.trace.program import slice_units


def read(ctx):
    try:
        from whisper_vits_svc_tpu_torch.infer import stream
    except ImportError:
        return None
    if not hasattr(stream, "graph_replays"):
        return None
    al = slice_units(ctx, "bench.push_audio", "svc.push_audio")
    if al is None:
        return None
    forwards = {s.id for s in al.spans if s.name == "svc.push.forward"}
    replayed = {s.parent for s in al.spans if s.name == "svc.push.forward.replay"} & forwards
    return 100.0 * len(replayed) / len(al.units)
