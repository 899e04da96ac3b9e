"""Whisper's share of the card's float32 peak while it runs, in percent: the
reference's matmul and convolution FLOPs of one 15 s window
(work_extract.whisper_flops, the driver's `whisper_flops`) times the
slice's `svc.extract.whisper` spans, over the device's busy time inside
those spans (the union of kernels, copies and memsets; the span closes
after the PPG's read-back, so the window's device work lies inside it),
over the configuration's precision's peak. None when the program keeps no
such span or the spans hold no device work."""

from benchmark.trace.program import _union, idle_us, slice_units


def read(ctx):
    flops = ctx.work.get("whisper_flops")
    peak = ctx.peaks.get(ctx.work.get("precision", "") + "_flops_per_s")
    al = slice_units(ctx, "bench.push_audio", "svc.push_audio")
    if not flops or peak is None or al is None:
        return None
    tr = ctx.trace
    spans = [(al.to_us(s.t0_ns), al.to_us(s.t1_ns)) for s in al.spans
             if s.name == "svc.extract.whisper"]
    inside = sum(b - a for a, b in _union((max(a, tr.t0), min(b, tr.t1)) for a, b in spans))
    busy_s = (inside - idle_us(tr, spans)) / 1e6
    if not spans or busy_s <= 0.0:
        return None
    return 100.0 * flops * len(spans) / busy_s / peak
