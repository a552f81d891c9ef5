"""step.launch_ms: the host's time to queue a batch's kernels, a batch:
the rest of Classifier.call_packed, K1, the probe and K3 launched (the
pass's warm-up batch counts too). The program's span "launch"
(shark_tpu_torch/utils/timers.py), its time over its count in a pass;
the mean over the window's passes that ran without the profiler. None
where no pass recorded the span (a program without spans)."""


def read(ctx):
    per = [p["stats"]["spans"]["launch"] for p in ctx.window_passes
           if not p["profiled"] and "launch" in p["stats"].get("spans", {})]
    return sum(r["ms"] / r["n"] for r in per) / len(per) if per else None
