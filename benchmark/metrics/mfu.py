"""Model FLOPs over wall time over the card's peak, in percent.

The FLOPs are the matmuls and convolutions of the benchmark's reference at
the cell's exact shapes (work.count_flops on the meta device: each request's
padded chunks, each push, or each step's forward and both backward passes),
summed over the units the window completed, over the window's wall time
(the unprofiled part of the traced run). The peak is the configuration's
precision's (float32 outside the tensor cores), never what the program
launched.
"""


def read(ctx):
    w = ctx.work
    if not w.get("flops") or not w.get("wall_s"):
        return None
    peak = ctx.peaks.get(w["precision"] + "_flops_per_s")
    if peak is None:
        return None
    return 100.0 * w["flops"] / w["wall_s"] / peak
