"""pipeline.queue_wait_ms: the dispatch thread blocked on the drain's
full queue, a batch: the program's span "queue_wait" (q.put of a group
of verdicts in pipeline._run_native; shark_tpu_torch/utils/timers.py),
its total in a pass over the engine's batches in that pass; the mean
over the window's passes that ran without the profiler. None where no
pass recorded it (a program without spans or engine counters)."""


def read(ctx):
    per = [p["stats"]["spans"]["queue_wait"]["ms"]
           / p["stats"]["engine"]["batches"]
           for p in ctx.window_passes
           if not p["profiled"]
           and "queue_wait" in p["stats"].get("spans", {})
           and p["stats"].get("engine", {}).get("batches")]
    return sum(per) / len(per) if per else None
