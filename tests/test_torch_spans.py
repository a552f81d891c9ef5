"""The spans and the engine's counters of a pass of shark_tpu_torch's
pipeline, on the CPU through the native engine, on a tiny sample whose
genes include a family sharing a core (so that GROUP verdicts and the
speculative winner pairs run):

- run_pipeline's stats["spans"] holds every span of the pass, each with
  the count of the batches, groups or passes it wraps, and
  stats["engine"] the engine's counters: as many batches as the loop
  took, none negative, the parser busy, emit_bytes the bytes of the
  files written, the ring's wait and copy inside the span that wraps
  them; on the device path (single-end and paired, a fetch a batch), on
  the Python I/O path (the same loop: the same spans and counts, the
  same bytes) and on --backend native;
- under torch.profiler the Chrome trace holds a user_annotation record
  shark::<name> for every span, the drain's on a thread of its own, and
  the output bytes are those of a pass without the profiler (a profiler
  started around the pass, and --profile-dir read through
  shark_tpu_torch/utils/trace.py);
- with no profiler recording, no record_function is made;
- timers.Spans keeps each thread's totals apart, adds them up, and
  counts a span inside another once in the time covered.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from shark_tpu_torch import cli, pipeline
from shark_tpu_torch.io import native
from shark_tpu_torch.pipeline import run_pipeline
from shark_tpu_torch.utils import timers, trace
from test_torch_threads import one_torch_thread  # noqa: F401

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
N_READS, BATCH = 300, 64
BATCHES = -(-N_READS // BATCH)
# a device pass's dispatch spans (it runs no pre-scan: prescan_wait is
# --backend native's)
DISPATCH = ("ring_wait", "h2d", "launch", "spec_pairs", "group_copy",
            "queue_wait", "drain_join", "stream_open", "warmup_batch")
DRAIN = ("fetch_wait", "winner_pairs", "emit")
# the drain's span inside winner_pairs, on a batch with GROUP verdicts
NESTED = ("group_expand",)


@pytest.fixture
def sample(tmp_path, monkeypatch):
    """Twelve genes, four of them sharing a 200-base core; 300 reads (or
    pairs) of 90 bases from them; -b 1 is 2^20 bits here."""
    if not native.available():
        pytest.skip("the C++ engine (g++) is needed")
    monkeypatch.setattr("shark_tpu_torch.config.BF_UNIT_BITS", 1 << 20)
    rng = np.random.default_rng(8)
    core = BASES[rng.integers(0, 4, size=200)]
    genes = []
    for i in range(12):
        g = BASES[rng.integers(0, 4, size=400)]
        genes.append(np.concatenate([g[:100], core, g[300:]]) if i < 4
                     else g)
    fa = tmp_path / "genes.fa"
    fa.write_bytes(b"".join(b">g%d\n%s\n" % (i, g.tobytes())
                            for i, g in enumerate(genes)))
    mates = [[], []]
    for i in range(N_READS):
        g = genes[int(rng.integers(0, 12))]
        for m in mates:
            s = int(rng.integers(0, 310))
            m.append(b"@r%04d\n%s\n+\n%s\n" % (i, g[s:s + 90].tobytes(),
                                                 b"I" * 90))
    fq = [tmp_path / "reads_1.fq", tmp_path / "reads_2.fq"]
    for path, m in zip(fq, mates):
        path.write_bytes(b"".join(m))
    return tmp_path, str(fa), [str(p) for p in fq]


def _config(sample, tag, backend="cpu", paired=False, extra=()):
    tmp, fa, fq = sample
    out = [str(tmp / f"{tag}_1.fq"), str(tmp / f"{tag}_2.fq")]
    argv = ["-r", fa, "-1", fq[0], "-o", out[0], "--ssv",
            str(tmp / f"{tag}.ssv"), "-k", "15", "--batch-size", str(BATCH),
            "--backend", backend, *extra]
    if paired:
        argv += ["-2", fq[1], "-p", out[1]]
    return cli.config_from_args(cli.build_parser().parse_args(argv))


def _outputs(cfg):
    paths = [cfg.ssv_path, cfg.out1_path] + (
        [cfg.out2_path] if cfg.out2_path else [])
    out = []
    for p in paths:
        with open(p, "rb") as f:
            out.append(f.read())
    return out


@pytest.mark.parametrize("backend,paired,stream", [
    ("cpu", False, "engine"), ("cpu", True, "engine"),
    ("native", False, "engine"), ("cpu", False, "python")])
def test_every_span_counts_its_work(sample, backend, paired, stream):
    cfg = _config(sample, "run", backend, paired,
                  extra=["--no-native"] if stream == "python" else [])
    t = time.perf_counter()
    stats = run_pipeline(cfg)
    wall_ms = 1e3 * (time.perf_counter() - t)
    spans, engine = stats["spans"], stats["engine"]
    files = _outputs(cfg)
    assert files[0], "the sample gave no association"
    assert stats["native"] is (stream == "engine")
    n = {k: r["n"] for k, r in spans.items()}
    if backend == "native":
        # the last wait on the ring finds the end of the sample; the
        # pre-scan sizes host classify's one width
        assert n == {"ring_wait": BATCHES + 1, "emit": BATCHES,
                     "prescan_wait": 1}
    else:
        assert stats["group_rows"] > 0  # GROUP verdicts were drained
        assert 1 <= stats["group_batches"] <= BATCHES
        assert stats["fetch_groups"] == BATCHES
        assert n == {
            "ring_wait": BATCHES + 1,
            # the pass's warm-up batch is copied and launched too
            "h2d": BATCHES + 1, "launch": BATCHES + 1,
            "spec_pairs": n["spec_pairs"],
            "group_copy": BATCHES, "queue_wait": BATCHES,
            "fetch_wait": BATCHES,
            "winner_pairs": BATCHES, "emit": BATCHES,
            "group_expand": stats["group_batches"],
            "stream_open": 1, "warmup_batch": 1,
            "drain_join": 1}
        assert 1 <= n["spec_pairs"] <= BATCHES  # where armed
    assert all(r["ms"] >= 0 for r in spans.values())
    if stream == "python":
        # the Python I/O path runs the engine's loop: its spans count
        # what the engine's pass counts, and it writes the same bytes
        on_engine = _config(sample, "engine", backend, paired)
        engine_stats = run_pipeline(on_engine)
        assert n == {k: r["n"] for k, r in engine_stats["spans"].items()}
        for key in ("n_reads", "n_associations", "n_reads_out",
                    "fetch_groups", *pipeline.DRAIN_COUNTS):
            assert stats[key] == engine_stats[key], key
        assert files == _outputs(on_engine)
        assert engine == {}  # no engine, no engine counters
    else:
        assert set(engine) == set(native.ENGINE_COUNTERS)
        assert engine["batches"] == BATCHES
        assert all(v >= 0 for v in engine.values()), engine
        assert engine["parse_ns"] > 0 and engine["encode_ns"] > 0
        assert engine["emit_bytes"] == sum(len(b) for b in files)
        # the span around next_batch holds the engine's wait and copy
        assert (engine["next_wait_ns"] + engine["next_copy_ns"]) / 1e6 <= \
            spans["ring_wait"]["ms"]
    covered = stats["spans_covered_ms"]
    assert covered["dispatch"] <= wall_ms
    if backend == "native":  # one thread: it emits too
        assert covered == {"dispatch": pytest.approx(
            sum(r["ms"] for r in spans.values()))}
    else:
        assert covered["drain"] == pytest.approx(
            sum(spans[k]["ms"] for k in DRAIN))
        # the warm-up batch's own h2d and launch lie inside warmup_batch
        assert covered["dispatch"] < sum(
            spans[k]["ms"] for k in DISPATCH)


def _annotations(events):
    """{span name: thread ids} of the shark:: user_annotation records."""
    out = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e["name"].startswith("shark::")):
            out.setdefault(e["name"][len("shark::"):], set()).add(
                e.get("tid"))
    return out


@pytest.mark.parametrize("how", ["profile", "profile_dir"])
def test_spans_reach_the_trace(sample, how):
    plain_cfg = _config(sample, "plain")
    run_pipeline(plain_cfg)
    tmp = sample[0]
    if how == "profile":
        cfg = _config(sample, "traced")
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=timers.all_threads_config()) as prof:
            run_pipeline(cfg)
        path = str(tmp / "pass.pt.trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            marks = _annotations(json.load(f)["traceEvents"])
        threads = {k: next(iter(v)) for k, v in marks.items()}
        dispatch = threads["ring_wait"]
    else:
        cfg = _config(sample, "traced",
                      extra=["--profile-dir", str(tmp / "prof")])
        run_pipeline(cfg)
        s = trace.summarize(trace.newest_trace(str(tmp / "prof")))
        threads = {k: tid for tid, rows in s["spans"].items() for k in rows}
        dispatch = s["dispatch_thread"]
        assert s["spans"][dispatch]["ring_wait"]["n"] == BATCHES + 1
    assert set(threads) == set(DISPATCH) | set(DRAIN) | set(NESTED)
    assert {threads[k] for k in DISPATCH} == {dispatch}
    assert len({threads[k] for k in DRAIN + NESTED}) == 1
    assert threads["emit"] != dispatch
    assert _outputs(cfg) == _outputs(plain_cfg)


def test_no_record_function_without_a_profiler(sample, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function made with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    stats = run_pipeline(_config(sample, "quiet"))
    assert set(stats["spans"]) == set(DISPATCH) | set(DRAIN) | set(NESTED)


def test_spans_add_up_by_thread_and_nest():
    spans = timers.Spans()
    assert not spans.profiled
    with timers.recording(spans, "dispatch"):
        with timers.span("outer"):
            with timers.span("inner"):
                time.sleep(0.002)
        with timers.span("inner"):
            pass

        def drain():
            with timers.recording(spans, "drain"):
                for _ in range(3):
                    with timers.span("inner"):
                        pass

        th = threading.Thread(target=drain)
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
    with timers.span("outside"):  # no pass recording: nothing kept
        pass
    s = spans.summary()
    assert {k: r["n"] for k, r in s.items()} == {"outer": 1, "inner": 5}
    assert s["outer"]["ms"] >= 2.0
    covered = spans.covered_ms()
    # the first inner lies inside outer: counted once in the time covered
    assert covered["dispatch"] < s["outer"]["ms"] + s["inner"]["ms"]
    assert covered["dispatch"] >= s["outer"]["ms"]
    assert set(covered) == {"dispatch", "drain"}
    assert spans.n("inner") == 5 and spans.n("absent") == 0


def test_covered_time_is_the_pass_not_the_index(sample):
    """A warm classifier reused, as a benchmark's passes reuse it: the
    dispatch thread's spans cover most of the pass."""
    from shark_tpu_torch.classify.step import Classifier
    from shark_tpu_torch.pipeline import load_or_build_index
    from shark_tpu_torch.utils.timers import PhaseTimer

    cfg = _config(sample, "warm")
    clf = Classifier(load_or_build_index(cfg, PhaseTimer()),
                     max_winners=cfg.max_winners, c=cfg.c, device="cpu")
    run_pipeline(cfg, classifier=clf)
    t = time.perf_counter()
    stats = run_pipeline(cfg, classifier=clf)
    wall_ms = 1e3 * (time.perf_counter() - t)
    assert stats["spans_covered_ms"]["dispatch"] >= 0.5 * wall_ms
    assert os.path.getsize(cfg.ssv_path) > 0


NEW_METRICS = ("engine.ring_wait_ms", "engine.parse_ms", "engine.encode_ms",
               "step.h2d_ms", "step.launch_ms", "pipeline.queue_wait_ms",
               "pipeline.prescan_ms", "drain.fetch_wait_ms",
               "drain.winner_pairs_ms", "drain.emit_ms")


def test_the_benchmark_reads_the_spans(tmp_path):
    """A --trace 1 run of the benchmark's harness on the CPU, in a tiny
    paired cell added from new files (portbench/tests/conftest.py's
    rehearsal): every per-layer metric that reads a span or an engine
    counter is a number, in ms, but pipeline.prescan_ms: a device pass
    runs no pre-scan, so it reads nothing."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "portbench_rehearsal", os.path.join(root, "portbench", "tests",
                                            "conftest.py"))
    pb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pb)
    bench = pb.Bench(str(tmp_path))
    cell = bench.add_cell("tiny.paired", pb.TINY_GENES, pb.TINY_FLAGS,
                          pb.tiny_traffic("paired"), "tiny_paired")
    rc, result, err = bench.rehearse(cell, trace=1)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, err[-3000:]
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        declared = {m["name"] for m in json.load(f)["per_layer"]}
    for name in NEW_METRICS:
        assert name in declared
        if name == "pipeline.prescan_ms":
            assert name not in result["metrics"]
            continue
        m = result["metrics"][name]
        assert m["unit"] == "ms"
        assert isinstance(m["value"], float) and m["value"] >= 0, name
