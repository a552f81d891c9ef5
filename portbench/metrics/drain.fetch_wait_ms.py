"""drain.fetch_wait_ms: the drain's wait for a group's packed verdicts
on the host, a group: _HostCopy.numpy() in pipeline._run_native. The
program's span "fetch_wait" (shark_tpu_torch/utils/timers.py), its time
over its count in a pass; the mean over the window's passes that ran
without the profiler. None where no pass recorded the span (a program
without spans)."""


def read(ctx):
    per = [p["stats"]["spans"]["fetch_wait"] for p in ctx.window_passes
           if not p["profiled"] and "fetch_wait" in p["stats"].get("spans", {})]
    return sum(r["ms"] / r["n"] for r in per) / len(per) if per else None
