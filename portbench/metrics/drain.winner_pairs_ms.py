"""drain.winner_pairs_ms: the drain's decode of a batch's verdicts into
(read, gene) pairs, a batch: pipeline._winner_pairs. The program's span
"winner_pairs" (shark_tpu_torch/utils/timers.py), its time over its
count in a pass; the mean over the window's passes that ran without the
profiler. None where no pass recorded the span (a program without
spans)."""


def read(ctx):
    per = [p["stats"]["spans"]["winner_pairs"] for p in ctx.window_passes
           if not p["profiled"] and "winner_pairs" in p["stats"].get("spans", {})]
    return sum(r["ms"] / r["n"] for r in per) / len(per) if per else None
