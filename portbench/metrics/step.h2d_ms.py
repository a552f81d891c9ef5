"""step.h2d_ms: the copy of a batch's planar reads to the card, a batch:
the two .to(device, non_blocking=True) of Classifier.upload (the pass's
warm-up batch counts too). The program's span "h2d"
(shark_tpu_torch/utils/timers.py), its time over its count in a pass;
the mean over the window's passes that ran without the profiler. None
where no pass recorded the span (a program without spans)."""


def read(ctx):
    per = [p["stats"]["spans"]["h2d"] for p in ctx.window_passes
           if not p["profiled"] and "h2d" in p["stats"].get("spans", {})]
    return sum(r["ms"] / r["n"] for r in per) / len(per) if per else None
