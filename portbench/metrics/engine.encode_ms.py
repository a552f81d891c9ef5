"""engine.encode_ms: the engine's encoder threads busy in
encode_batch_rows (encode, quality mask, planar pack), summed, a batch:
the engine's counter encode_ns (steady-clock ns, kept in
shark_tpu_torch/native/shark_native.cpp and read once a pass into
run_pipeline's stats["engine"]) over its counter batches, in ms; the
mean over the window's passes that ran without the profiler. None where
no pass has the counters (a program without them)."""


def read(ctx):
    per = [p["stats"]["engine"]["encode_ns"] / p["stats"]["engine"]["batches"]
           / 1e6 for p in ctx.window_passes
           if not p["profiled"]
           and p["stats"].get("engine", {}).get("batches")]
    return sum(per) / len(per) if per else None
