"""engine.ring_wait_ms: the dispatch thread's wait for a batch from the
engine's ring, a batch: NativeStream.next_batch in pipeline._run_native
(the last call of a pass finds the sample's end). The program's span
"ring_wait" (shark_tpu_torch/utils/timers.py), its time over its count
in a pass; the mean over the window's passes that ran without the
profiler. None where no pass recorded the span (a program without
spans)."""


def read(ctx):
    per = [p["stats"]["spans"]["ring_wait"] for p in ctx.window_passes
           if not p["profiled"] and "ring_wait" in p["stats"].get("spans", {})]
    return sum(r["ms"] / r["n"] for r in per) / len(per) if per else None
