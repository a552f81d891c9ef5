"""pipeline.warmup_ms: what run_pipeline spends in a pass before its
first batch: the sample's length pre-scan, the engine's stream and
outputs opened, the gene names registered, one warm-up batch. The mean,
over the window's passes that ran without the profiler, of the
program's own warmup_s (PhaseTimer)."""


def read(ctx):
    ws = [p["stats"]["warmup_s"] for p in ctx.window_passes
          if not p["profiled"]]
    return 1e3 * sum(ws) / len(ws) if ws else None
