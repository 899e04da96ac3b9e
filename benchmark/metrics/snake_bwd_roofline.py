"""The backward snake kernel's share of its roofline, in percent: as
snake_fwd_roofline, with the backward's bytes and operations
(work.snake_bound_s(backward=True)) over the `snake_alias_bwd` kernels."""

from benchmark.work import snake_bound_s

KERNELS = ("snake_alias_bwd",)


def read(ctx):
    if ctx.trace is None or not ctx.work.get("snake_bwd_calls"):
        return None
    spent = ctx.trace.kernel_s(KERNELS)
    if spent <= 0.0:
        return None
    return 100.0 * snake_bound_s(ctx.work["snake_bwd_calls"], ctx.peaks, backward=True) / spent
