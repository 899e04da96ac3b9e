"""Device-busy ms a push inside the program's `svc.extract.crepe.probs`
spans: CREPE's forward over the push's new frames, from the frames' upload
to the probabilities' read-back (the span closes after it, so the batch's
device work lies inside it). The union of the slice's spans less the
device's idle time inside them (kernels, copies and memsets), as
whisper_roofline.py computes it, over the slice's units. None when the
program keeps no such span."""

from benchmark.trace.program import _union, idle_us, slice_units


def read(ctx):
    al = slice_units(ctx, "bench.push_audio", "svc.push_audio")
    if al is None:
        return None
    tr = ctx.trace
    spans = [(al.to_us(s.t0_ns), al.to_us(s.t1_ns)) for s in al.spans
             if s.name == "svc.extract.crepe.probs"]
    if not spans:
        return None
    inside = sum(b - a for a, b in _union((max(a, tr.t0), min(b, tr.t1)) for a, b in spans))
    return (inside - idle_us(tr, spans)) / 1e3 / len(al.units)
