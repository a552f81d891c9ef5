"""pipeline.reads_per_s: every read of every pass of the window over the
window's wall time, a pair counted once (the measure of reads_per_s), in
the cells whose runs spread too widely across machines for the rate to
stand end to end under its bound (PERF.md). In the traced run the
profiled passes are among them."""


def read(ctx):
    passes = ctx.window_passes
    if not passes or ctx.setup.get("window_s", 0) <= 0:
        return None
    return sum(p["stats"]["n_reads"] for p in passes) / ctx.setup["window_s"]
