"""Share of the profiled slice in which no kernel, copy or memset ran on the
device (the union of their intervals, trace/chrome.py), in percent."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
