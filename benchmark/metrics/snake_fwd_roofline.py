"""The forward snake kernels' share of their roofline, in percent: the
bound of every call of the profiled slice (work.snake_bound_s over the
generator's stage shapes from the configuration, times the chunks, pushes
or steps in the slice) over the device time of the kernels named here."""

from benchmark.work import snake_bound_s

KERNELS = ("snake_alias_kernel", "snake_alias_strips_kernel", "snake_alias_mma_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    spent = ctx.trace.kernel_s(KERNELS)
    if spent <= 0.0:
        return None
    return 100.0 * snake_bound_s(ctx.work["snake_fwd_calls"], ctx.peaks) / spent
