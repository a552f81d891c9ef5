"""device.idle_pct: the share of the profiled stretch of the window in
which the card runs no kernel, copy or memset (the union of the trace's
device records; portbench/trace.py). Nothing, without a trace that holds
a device record."""


def read(ctx):
    t = ctx.trace
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
