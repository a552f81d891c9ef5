"""The port's end-to-end stage profilers, on the CPU at a tiny size.

- scripts/profile_e2e_torch.py's serial pass (no drain thread, a clock on
  every stage) writes the ssv and FASTQ bytes of run_pipeline's
  overlapped loop, and of shark_tpu's run_pipeline, on a panel-like and
  a homolog-like workload of bench_gpu.py's generators; every stage key
  is present and non-negative, and the stages add up to at most the
  serial total; main() prints one line a workload with its passes' bytes
  equal, and without a card and without --cpu exits 1;
- shark_tpu_torch/utils/trace.py gives the totals a hand-written Chrome
  trace was written with (kernels, copies by kind, memsets, each host
  thread's torch operators, CUDA calls and the rest, the program's spans
  by thread, and the card's idle time by the dispatch thread's span),
  and scripts/trace_report_torch.py prints them;
- scripts/native_stage_bench_torch.cpp compiles with g++ and times every
  read, single-end and paired (skipped without g++);
- scripts/dispatch_bench_torch.py and scripts/parser_bench_torch.py run
  end to end with --cpu;
- shark_tpu_torch/floors.py's bare gathers, which bench_gpu.py's gather
  ceiling takes, fold each row on CPU tensors as a numpy fold does.

The -b unit is shrunk to 2^22 bits (config.BF_UNIT_BITS) in both
packages, and the batch to 64 reads.
"""

import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess

import pytest
import torch

import bench_gpu
from shark_tpu_torch import config
from shark_tpu_torch.io import native
from shark_tpu_torch.pipeline import run_pipeline
from shark_tpu_torch.utils import trace
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(N_GENES=20, N_READS=300, N_PAIRS=100, HOMOLOG_GENES=48,
            HOMOLOG_READS=300, BATCH=64)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_under_test", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    if shutil.which("g++") is None or not native.available():
        pytest.skip("the C++ engine (g++) is needed")
    monkeypatch.setattr(config, "BF_UNIT_BITS", 1 << 22)
    monkeypatch.setattr(bench_gpu, "CACHE", str(tmp_path / "cache"))
    for name, v in TINY.items():
        monkeypatch.setattr(bench_gpu, name, v)
    return tmp_path


def _serial(tmp_path, wl):
    """(profile_e2e module, cfg, classifier, the serial pass's result and
    its ssv and FASTQ bytes) for `wl` on the CPU."""
    pe = _script("profile_e2e_torch")
    b = bench_gpu.Bench(torch.device("cpu"), float("inf"))
    cfg, clf = pe.workload_config(b, wl)
    pe.warm(cfg, clf)
    ssv, fq = str(tmp_path / "serial.ssv"), str(tmp_path / "serial.fq")
    s = pe.serial_pass(cfg, clf, ssv, fq, "")
    with open(ssv, "rb") as f1, open(fq, "rb") as f2:
        return pe, cfg, clf, s, (f1.read(), f2.read())


def _bytes(cfg):
    with open(cfg.ssv_path, "rb") as f1, open(cfg.out1_path, "rb") as f2:
        return f1.read(), f2.read()


@pytest.mark.parametrize("wl", ["panel", "homolog"])
def test_serial_pass_writes_the_overlapped_bytes(tiny, wl):
    pe, cfg, clf, s, got = _serial(tiny, wl)
    assert got[0], "the workload emitted no association"
    assert s["reads"] == TINY["N_READS"]
    assert s["batches"] == -(-TINY["N_READS"] // TINY["BATCH"])
    assert set(s["stages_s"]) == set(pe.STAGES)
    assert all(v >= 0 for v in s["stages_s"].values()), s["stages_s"]
    assert sum(s["stages_s"].values()) <= s["serial_total_s"]
    assert len(s["per_batch_s"]) == s["batches"]
    assert s["synced"] is False
    if wl == "homolog":
        assert s["group_rows"] > 0  # GROUP verdicts went through the drain
    run_pipeline(cfg, classifier=clf)
    assert _bytes(cfg) == got


@pytest.mark.parametrize("wl", ["panel", "homolog"])
def test_serial_pass_writes_shark_tpu_bytes(tiny, monkeypatch, wl):
    pytest.importorskip("jax")
    from shark_tpu import config as jconfig
    from shark_tpu.config import SharkConfig as JConfig
    from shark_tpu.pipeline import run_pipeline as jrun

    monkeypatch.setattr(jconfig, "BF_UNIT_BITS", 1 << 22)
    _, cfg, _, _, got = _serial(tiny, wl)
    fields = dataclasses.asdict(cfg)
    fields.update(ssv_path=str(tiny / "jax.ssv"),
                  out1_path=str(tiny / "jax.fq"), backend="cpu")
    jcfg = JConfig(**fields)
    jrun(jcfg)
    assert _bytes(jcfg) == got


def test_main_prints_a_line_with_equal_bytes(tiny, capsys):
    pe = _script("profile_e2e_torch")
    rc = pe.main(["--workload", "panel", "--reads", str(TINY["N_READS"]),
                  "--cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    line = json.loads(out[-1])
    assert line["workload"] == "panel" and line["device"] == "cpu"
    assert line["bytes_equal"] is True
    assert line["reads"] == TINY["N_READS"]
    assert set(line["stages_s"]) == set(line["stages_ms_per_batch"]) == set(
        pe.STAGES)
    assert line["stages_sum_s"] <= line["serial_total_s"]
    assert line["ring_s"] > 0 and line["ring_first_batch_s"] > 0
    assert line["drain_s"] == pytest.approx(
        line["stages_s"]["winner_pairs"] + line["stages_s"]["emit"], abs=2e-6)
    assert line["gc_collections"] >= 0 and line["cuda_mallocs"] == 0
    assert len(line["overlapped_classify_s"]) == 2
    assert line["profiled_classify_s"] > 0
    assert line["trace"]["kernels"] == 0  # the CPU records no kernel
    assert any(h["ops_ms"] > 0 for h in line["trace"]["host"].values())
    assert line["launches"] == {"serial": {}, "overlapped": {}}


def test_main_without_a_card_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench_gpu, "CACHE", "/nonexistent/profile_e2e")
    assert _script("profile_e2e_torch").main(["--workload", "panel"]) == 1
    assert "no CUDA card" in capsys.readouterr().err


def _event(cat, name, ts, dur, tid=1, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if args:
        e["args"] = args
    return e


TRACE = [
    {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1, "args": {}},
    {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 45, "id": 1},
    _event("kernel", "void (anonymous namespace)::front_kernel(Args)", 100,
           10, tid=7),
    _event("kernel", "void probe_kernel<8>(Args, int)", 105, 10, tid=7),
    _event("kernel", "void (anonymous namespace)::front_kernel(Args)", 200,
           20, tid=7),
    _event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 50, 30, tid=7,
           bytes=1000),
    _event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 90, 20, tid=7,
           bytes=500),
    _event("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 230, 5, tid=7,
           bytes=64),
    _event("gpu_memset", "Memset (Device)", 40, 2, tid=7),
    _event("cpu_op", "aten::to", 0, 50),
    _event("cpu_op", "aten::copy_", 10, 20),
    _event("cuda_runtime", "cudaMemcpyAsync", 45, 40),
    _event("cuda_runtime", "cudaLaunchKernel", 95, 5),
    _event("cpu_op", "aten::empty", 300, 10),
    _event("python_function", "loop", 0, 400),
    _event("cuda_runtime", "cudaEventSynchronize", 120, 30, tid=2),
    # the program's spans: the dispatch thread's (1) around the card's
    # one idle gap in the window, 115-200, and the drain's (2)
    _event("user_annotation", "shark::ring_wait", 110, 40),
    _event("user_annotation", "shark::warmup_batch", 150, 40),
    _event("user_annotation", "shark::h2d", 160, 10),
    _event("user_annotation", "shark::ring_wait", 300, 5),
    _event("user_annotation", "shark::fetch_wait", 118, 2, tid=2),
    _event("user_annotation", "shark::emit", 120, 30, tid=2),
    _event("user_annotation", "ProfilerStep#1", 0, 400),
]


def test_trace_summary_gives_the_written_totals(tmp_path, capsys):
    d = tmp_path / "prof" / "inner"
    d.mkdir(parents=True)
    (d / "host_1.1.pt.trace.json").write_text(
        json.dumps({"traceEvents": TRACE}))
    path = trace.newest_trace(str(tmp_path / "prof"))
    s = trace.summarize(path)
    assert s["kernels"] == 3
    assert s["kernel_busy_ms"] == pytest.approx(0.035)  # 100-115, 200-220
    assert s["window_ms"] == pytest.approx(0.120)  # 100 to 220
    # 40-42, 50-80, 90-115, 200-220, 230-235
    assert s["device_busy_ms"] == pytest.approx(0.082)
    assert s["by_kernel"] == {
        "front_kernel": {"ms": pytest.approx(0.030), "count": 2},
        "probe_kernel<8>": {"ms": pytest.approx(0.010), "count": 1}}
    assert s["memcpy"] == {
        "HtoD (Pageable -> Device)": {"ms": pytest.approx(0.050), "count": 2,
                                      "bytes": 1500},
        "DtoH (Device -> Pinned)": {"ms": pytest.approx(0.005), "count": 1,
                                    "bytes": 64}}
    assert s["memset"] == {"ms": pytest.approx(0.002), "count": 1}
    main, drain = s["host"]["1"], s["host"]["2"]
    assert main["ops_ms"] == pytest.approx(0.060)  # 0-50, 300-310
    assert main["runtime_ms"] == pytest.approx(0.045)
    assert main["runtime_calls_ms"] == {
        "cudaMemcpyAsync": pytest.approx(0.040),
        "cudaLaunchKernel": pytest.approx(0.005)}
    assert main["window_ms"] == pytest.approx(0.310)
    # outside 0-85, 95-100 and 300-310
    assert main["outside_ms"] == pytest.approx(0.210)
    assert drain == {"ops_ms": 0.0, "runtime_ms": pytest.approx(0.030),
                     "runtime_calls_ms": {
                         "cudaEventSynchronize": pytest.approx(0.030)},
                     "top_runtime_ms": {
                         "cudaEventSynchronize": pytest.approx(0.030)},
                     "window_ms": pytest.approx(0.030),
                     "outside_ms": pytest.approx(0.0)}
    assert s["trace"] == "host_1.1.pt.trace.json"
    assert s["spans"] == {
        "1": {"ring_wait": {"n": 2, "ms": pytest.approx(0.045)},
              "warmup_batch": {"n": 1, "ms": pytest.approx(0.040)},
              "h2d": {"n": 1, "ms": pytest.approx(0.010)}},
        "2": {"fetch_wait": {"n": 1, "ms": pytest.approx(0.002)},
              "emit": {"n": 1, "ms": pytest.approx(0.030)}}}
    assert s["dispatch_thread"] == "1"
    # the gap 115-200 by the dispatch thread's innermost span: ring_wait
    # to 150, warmup_batch 150-160 and 170-190 around h2d, then none
    assert s["idle_by_span_ms"] == {
        "ring_wait": pytest.approx(0.035),
        "warmup_batch": pytest.approx(0.030),
        "h2d": pytest.approx(0.010),
        "outside any span": pytest.approx(0.010)}
    rep = _script("trace_report_torch")
    assert rep.main([str(tmp_path / "prof")]) == 0
    text = capsys.readouterr().out
    assert "3 kernel records" in text and "HtoD (Pageable -> Device)" in text
    assert "host thread 2:" in text
    assert "spans of thread 1 (dispatch): ring_wait 2x 0.045 ms" in text
    assert "by the dispatch thread's span: ring_wait 0.035 ms" in text
    assert rep.main([str(tmp_path / "prof"), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["kernels"] == 3
    assert rep.main([str(tmp_path / "none")]) == 1


def _fastq(path, n, qual=b"I"):
    import numpy as np

    rng = np.random.default_rng(3)
    acgt = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "wb") as f:
        for i in range(n):
            seq = acgt[rng.integers(0, 5, size=100)].tobytes()
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, qual * 100))


def test_native_stage_bench_times_every_read(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed")
    exe = str(tmp_path / "stage_bench")
    subprocess.run(["g++", "-O1", "-std=c++17", "-pthread", "-o", exe,
                    os.path.join(ROOT, "scripts",
                                 "native_stage_bench_torch.cpp"), "-lz"],
                   check=True, timeout=240)
    fq1, fq2 = str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")
    _fastq(fq1, 200)
    _fastq(fq2, 200, qual=b"#")
    for argv in ([fq1, "64", "104"], [fq1, "64", "208", fq2, "10"]):
        out = subprocess.run([exe, *argv], check=True, capture_output=True,
                             text=True, timeout=60).stdout
        passes = [json.loads(line) for line in out.splitlines()]
        assert [p["pass"] for p in passes] == [0, 1, 2]
        for p in passes:
            assert p["reads"] == 200
            assert min(p["parse_s"], p["encode_s"], p["pack_s"]) >= 0
    bad = subprocess.run([exe, fq1, "64", "100"], capture_output=True,
                         timeout=60)
    assert bad.returncode == 2  # L must be a multiple of 8


def test_dispatch_bench_runs_on_the_cpu(tiny, capsys):
    rc = _script("dispatch_bench_torch").main(["2", "--cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert line["batches"] == 2 and line["device"] == "cpu"
    assert line["batch_bytes"] == TINY["BATCH"] * (bench_gpu.MAX_LEN // 4
                                                   + bench_gpu.MAX_LEN // 8)
    for key in ("call_device_resident_fetch_last_ms", "call_numpy_fetch_last_ms",
                "call_device_resident_fetch_all_ms", "call_numpy_fetch_all_ms",
                "h2d_pageable_host_ms", "launch_floor_ms"):
        assert line[key] > 0, key
    assert "h2d_pinned_host_ms" not in line  # a pinned copy needs a card


def test_parser_bench_runs_on_the_cpu(tiny, capsys):
    rc = _script("parser_bench_torch").main([])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert line["reads"] == TINY["N_READS"]
    assert line["batch_size"] == TINY["BATCH"]
    assert sorted(line["reads_per_sec"]) == sorted(
        f"{mode}_enc_threads_{t}" for mode in ("bytes", "packed")
        for t in (1, 2, 3))
    assert all(v > 0 for v in line["reads_per_sec"].values())


@pytest.mark.parametrize("row_bytes", [8, 16, 32])
def test_floor_gathers_fold_rows_on_the_cpu(row_bytes):
    """shark_tpu_torch/floors.py on CPU tensors (what bench_gpu.py's gather
    ceiling holds the card's gather to): each row of a u32 table folded by
    xor, and the two-level gather's pay row only where pidx >= 0; against
    a numpy fold."""
    import numpy as np

    from shark_tpu_torch import floors

    rng = np.random.default_rng(row_bytes)
    words = rng.integers(0, 1 << 32, size=(64, row_bytes // 4),
                         dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, 64, size=100).astype(np.int32)
    got = floors.rows(torch.from_numpy(words.view(np.int32)),
                      torch.from_numpy(idx), row_bytes)
    want = np.bitwise_xor.reduce(words[idx], axis=1)
    assert got.dtype == torch.uint32
    assert np.array_equal(got.view(torch.int32).numpy().view(np.uint32), want)
    pay = rng.integers(0, 1 << 32, size=(32, 2), dtype=np.uint64).astype(
        np.uint32)
    w8 = words.reshape(-1, 2)
    widx = rng.integers(0, w8.shape[0], size=100).astype(np.int32)
    pidx = rng.integers(-1, 32, size=100).astype(np.int32)
    got = floors.two_level(torch.from_numpy(w8.view(np.int32)),
                           torch.from_numpy(widx),
                           torch.from_numpy(pay.view(np.int32)),
                           torch.from_numpy(pidx))
    want = np.bitwise_xor.reduce(w8[widx], axis=1) ^ np.where(
        pidx >= 0, np.bitwise_xor.reduce(pay[np.maximum(pidx, 0)], axis=1), 0)
    assert np.array_equal(got.view(torch.int32).numpy().view(np.uint32),
                          want.astype(np.uint32))
    with pytest.raises(ValueError, match="not 4, 8, 16, 32, 64 or 128"):
        floors.rows(torch.zeros(8, dtype=torch.int32), torch.from_numpy(idx),
                    12)
