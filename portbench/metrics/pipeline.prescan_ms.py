"""pipeline.prescan_ms: the wait for the sample's length pre-scan, a
pass: join_scan() in pipeline._run_pipeline_inner. The program's span
"prescan_wait" (shark_tpu_torch/utils/timers.py), its time over its
count in a pass; the mean over the window's passes that ran without the
profiler. None where no pass recorded the span (a program without
spans)."""


def read(ctx):
    per = [p["stats"]["spans"]["prescan_wait"] for p in ctx.window_passes
           if not p["profiled"] and "prescan_wait" in p["stats"].get("spans", {})]
    return sum(r["ms"] / r["n"] for r in per) / len(per) if per else None
