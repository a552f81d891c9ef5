"""drain.emit_ms: the drain's write of a batch's ssv lines and FASTQ
records, a batch: NativeStream.emit in pipeline._run_native. The
program's span "emit" (shark_tpu_torch/utils/timers.py), its time over
its count in a pass; the mean over the window's passes that ran without
the profiler. None where no pass recorded the span (a program without
spans)."""


def read(ctx):
    per = [p["stats"]["spans"]["emit"] for p in ctx.window_passes
           if not p["profiled"] and "emit" in p["stats"].get("spans", {})]
    return sum(r["ms"] / r["n"] for r in per) / len(per) if per else None
