#!/usr/bin/env python3
"""Where classify_s goes: shark_tpu_torch's main path split by stage.

The port's counterpart of bench/profile_homolog_e2e.py and
bench/profile_txome_e2e.py in one script, on bench_gpu.py's workloads
(its generators, its cache under build/bench_gpu/ and its warm
classifiers, so the inputs are byte for byte those of the port's bench):

    python3 scripts/profile_e2e_torch.py [--workload panel|paired|q10|homolog|txome|all]
        [--reads N] [--cpu] [--engine-stages] [--cache DIR]

For each workload, after set-up (the index and probe tables built or
loaded back) and one real batch through every path:
1. one SERIAL pass over the whole sample, the loop of
   shark_tpu_torch/pipeline.py:_run_native with no drain thread, so that
   each stage is timed on its own (seconds on the host's clock):
   parse         NativeStream.next_batch: the wait for the C++ engine's
                 ring (its parse and encode threads run ahead), and the
                 fresh pageable arrays it fills;
   h2d           the two .to(device, non_blocking=True) copies that
                 Classifier.tags makes, made here and the device tensors
                 passed on (tags' .to of a tensor already there is a
                 no-op);
   dispatch      the host time of the K1 -> probe -> K3 calls;
   device        the wait for the card after they return;
   fetch_packed  the packed verdicts' copy to pinned host memory and its
                 wait (pipeline._HostCopy);
   extract_pairs K4's dispatch and fetch, where the pipeline's
                 speculation is armed (pre-armed for indexes with tie
                 groups, then as _winner_pairs sets it);
   winner_pairs  pipeline._winner_pairs (numpy; the exact pair stream
                 when the speculated one does not fit);
   emit          NativeStream.emit, and the close that flushes the files.
   On the card the serial pass synchronises at the end of h2d and of
   dispatch (and the copies wait on their events); no other pass does.
   CUDA events also give the card's time of the copies (h2d_events_s)
   and of the calls (device_events_s), which overlap the host's stages.
2. the engine's ring alone (ring_s: every batch pulled and released, no
   device, no output), beside the serial pass's drain_s (winner_pairs +
   emit, the drain thread's work): the two ends of the overlapped loop;
3. run_pipeline(cfg, classifier=clf) twice, the real overlapped loop,
   for its classify_s;
4. run_pipeline once more under --profile-dir, its trace summed by
   shark_tpu_torch/utils/trace.py (the card's busy time, kernels and
   copies, each host thread's torch, CUDA-call and other time).
The serial pass writes the ssv and FASTQ as the pipeline does; every
pass's bytes must equal its bytes. --engine-stages also compiles
scripts/native_stage_bench_torch.cpp with g++ into build/shark_tpu_torch/
and times the engine's parse, encode and pack on the workload's FASTQ.

Prints one JSON line per workload: stages_s, stages_ms_per_batch,
stages_sum_s, serial_total_s, ring_s, drain_s, gc_s,
overlapped_classify_s (both passes),
profiled_classify_s, trace, launches (per kernel, over the serial pass
and over one overlapped pass), bytes_equal and device (nvidia-smi's name
and power limit). Runs on cuda:0 unless --cpu is given (the plain
versions); without a card and without --cpu it exits 1. Exits 1 when any
pass's bytes differ; any other failure raises.

--reads N (default bench_gpu.py's 500000) sets the panel, q10, homolog
and txome read counts and the paired workload's N/2 pairs; a count other
than the default keeps its files in build/bench_gpu_reads<N>/ (--cache
names another directory), so that bench_gpu.py's own cache is left as it
is.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import bench_gpu  # noqa: E402
from shark_tpu_torch import kernels  # noqa: E402
from shark_tpu_torch.classify.step import extract_pairs  # noqa: E402
from shark_tpu_torch.io.native import NativeStream  # noqa: E402
from shark_tpu_torch.pipeline import (  # noqa: E402
    _HostCopy,
    _winner_pairs,
    run_pipeline,
)
from shark_tpu_torch.utils import trace  # noqa: E402

STAGES = ("parse", "h2d", "dispatch", "device", "fetch_packed",
          "extract_pairs", "winner_pairs", "emit")
STAGE_SRC = os.path.join(ROOT, "scripts", "native_stage_bench_torch.cpp")
STAGE_EXE = os.path.join(ROOT, "build", "shark_tpu_torch",
                         "native_stage_bench")


def log(msg: str) -> None:
    print(f"[profile_e2e] {msg}", file=sys.stderr, flush=True)


def spec_cap0(cfg, clf) -> int:
    """The speculation's capacity before the first batch: pre-armed for
    indexes that carry tie groups (pipeline.py:619-626)."""
    return ((1 << 14) if clf.groups is not None and not cfg.single
            and cfg.batch_size <= 65536 else 0)


def open_stream(cfg) -> NativeStream:
    """The C++ engine's stream as _run_native opens it."""
    return NativeStream(
        cfg.sample1_path, cfg.sample2_path, cfg.batch_size,
        cfg.max_read_len, cfg.min_quality, packed=True,
        encode_threads=max(1, min(cfg.threads - 1, 8)))


def warm(cfg, clf) -> None:
    """One real batch through every path the passes take
    (bench/profile_homolog_e2e.py:55-62)."""
    ns = open_stream(cfg)
    try:
        packed, vmask, slot, n = ns.next_batch()
        r = clf.call_packed(packed, vmask)
        cap = spec_cap0(cfg, clf)
        spec = (_HostCopy(extract_pairs(r[0], r[1], cap)), cap) if cap \
            else None
        _winner_pairs(cfg, clf.index, r, n, (packed, vmask),
                      cfg.max_winners, packed_np=_HostCopy(r[0]).numpy(),
                      spec=spec, spec_state={"cap": cap},
                      groups=clf.groups)
        ns.release(slot)
    finally:
        ns.close()


def serial_pass(cfg, clf, ssv: str, out1: str, out2: str) -> dict:
    """One pass over the whole sample, stage by stage (the module's
    docstring). Writes `ssv`, `out1` (and `out2` for pairs). Returns
    {"stages_s", "per_batch_s", "serial_total_s", "batches", "reads",
    "group_rows", "synced", "gc_s" and "gc_collections" (the interpreter's
    garbage collections within the pass, in whichever stage they fell),
    "cuda_mallocs" (new segments the caching allocator took from the card)
    and on the card "h2d_events_s", "device_events_s"}."""
    dev = clf.device
    on_card = dev.type == "cuda"
    index = clf.index
    clock = time.perf_counter
    t = dict.fromkeys(STAGES, 0.0)
    per_batch = []  # each batch's stage seconds
    ev_s = {"h2d": 0.0, "device": 0.0}
    spec_state = {"cap": spec_cap0(cfg, clf)}
    counters = {"group_rows": 0}
    n_batches = n_reads = 0

    def events():
        return [torch.cuda.Event(enable_timing=True) for _ in range(3)]

    gc_s = [0.0, 0, 0.0]  # seconds, collections, the running one's start

    def on_gc(phase, info):
        if phase == "start":
            gc_s[2] = clock()
        else:
            gc_s[0] += clock() - gc_s[2]
            gc_s[1] += 1

    def mallocs():
        return torch.cuda.memory_stats(dev).get(
            "segment.all.allocated", 0) if on_card else 0

    mallocs0 = mallocs()
    gc.callbacks.append(on_gc)
    ns = open_stream(cfg)
    try:
        ns.set_output(1, ssv, out1, out2)
        ns.register_genes(index.gene_names)
        t_all = clock()
        while True:
            before = dict(t)
            t0 = clock()
            nb = ns.next_batch()
            t1 = clock()
            t["parse"] += t1 - t0
            if nb is None:
                break
            packed, vmask, slot, n = nb
            ev = events() if on_card else None
            if ev:
                ev[0].record()
            pk = torch.as_tensor(packed).to(dev, non_blocking=True)
            vm = torch.as_tensor(vmask).to(dev, non_blocking=True)
            if ev:
                ev[1].record()
                torch.cuda.synchronize(dev)
            t2 = clock()
            t["h2d"] += t2 - t1
            result = clf.call_packed(pk, vm)
            if ev:
                ev[2].record()
            t3 = clock()
            t["dispatch"] += t3 - t2
            if ev:
                torch.cuda.synchronize(dev)
                ev_s["h2d"] += ev[0].elapsed_time(ev[1]) / 1e3
                ev_s["device"] += ev[1].elapsed_time(ev[2]) / 1e3
            t4 = clock()
            t["device"] += t4 - t3
            packed_np = _HostCopy(result[0]).numpy()
            t5 = clock()
            t["fetch_packed"] += t5 - t4
            spec = None
            cap = spec_state["cap"]
            if cap and not cfg.single:
                spec = (_HostCopy(extract_pairs(result[0], result[1], cap)),
                        cap)
                spec[0].numpy()
            t6 = clock()
            t["extract_pairs"] += t6 - t5
            ri, gi = _winner_pairs(
                cfg, index, result, n, (packed, vmask), cfg.max_winners,
                packed_np=packed_np, reprobe=getattr(clf, "reprobe", None),
                spec=spec, spec_state=spec_state, groups=clf.groups,
                counters=counters)
            t7 = clock()
            t["winner_pairs"] += t7 - t6
            ns.emit(slot, ri, gi)
            t["emit"] += clock() - t7
            per_batch.append({k: t[k] - before[k] for k in STAGES})
            n_batches += 1
            n_reads += n
    finally:
        t0 = clock()
        ns.close()
        t["emit"] += clock() - t0
        gc.callbacks.remove(on_gc)
    total = clock() - t_all
    out = {"stages_s": t, "per_batch_s": per_batch,
           "serial_total_s": total, "batches": n_batches,
           "reads": n_reads, "group_rows": counters["group_rows"],
           "synced": on_card, "gc_s": gc_s[0], "gc_collections": gc_s[1],
           "cuda_mallocs": mallocs() - mallocs0}
    if on_card:
        out["h2d_events_s"] = ev_s["h2d"]
        out["device_events_s"] = ev_s["device"]
    return out


def ring_pass(cfg) -> dict:
    """The C++ engine's stream alone: every batch pulled through its ring
    and released, no device and no output, clocked from the open's return
    as the pipeline's classify_s is clocked after it. What the dispatch
    thread could take at most: {"ring_s", "ring_first_batch_s"}."""
    ns = open_stream(cfg)
    try:
        t0 = time.perf_counter()
        first = None
        while True:
            nb = ns.next_batch()
            if first is None:
                first = time.perf_counter() - t0
            if nb is None:
                break
            ns.release(nb[-2])
        return {"ring_s": time.perf_counter() - t0,
                "ring_first_batch_s": first}
    finally:
        ns.close()


def same_bytes(paths_a, paths_b) -> bool:
    for a, b in zip(paths_a, paths_b):
        if not a:
            continue
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                return False
    return True


def engine_stages(cfg) -> dict:
    """scripts/native_stage_bench_torch.cpp compiled with g++ and run on
    the workload's FASTQ: each pass's parse, encode and pack seconds, and
    the best pass (least of their sum)."""
    os.makedirs(os.path.dirname(STAGE_EXE), exist_ok=True)
    subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-pthread",
                    "-o", STAGE_EXE, STAGE_SRC, "-lz"], check=True)
    out = subprocess.run(
        [STAGE_EXE, cfg.sample1_path, str(cfg.batch_size),
         str(cfg.max_read_len), cfg.sample2_path or "-",
         str(cfg.min_quality)],
        check=True, capture_output=True, text=True).stdout
    passes = [json.loads(line) for line in out.splitlines()
              if line.startswith("{")]
    best = min(passes, key=lambda p: p["parse_s"] + p["encode_s"]
               + p["pack_s"])
    return {"passes": passes, "best": best}


def profile(b: "bench_gpu.Bench", wl: str, cfg, clf, engine: bool) -> dict:
    """Every pass of one workload (the module's docstring); its line."""
    d = os.path.dirname(cfg.ssv_path)
    serial_paths = [os.path.join(d, f"{wl}.serial{ext}")
                    for ext in (".ssv", ".out1.fq", ".out2.fq")]
    if not cfg.sample2_path:
        serial_paths[2] = ""
    pass_paths = (cfg.ssv_path, cfg.out1_path, cfg.out2_path)
    t0 = time.perf_counter()
    warm(cfg, clf)
    warm_s = time.perf_counter() - t0
    kernels.LAUNCHES.reset()
    s = serial_pass(cfg, clf, *serial_paths)
    launches = {"serial": kernels.LAUNCHES.snapshot()}
    nb = max(1, s["batches"])
    stages = s.pop("stages_s")
    line = {
        "workload": wl, "reads": s["reads"], "batches": s["batches"],
        "batch_size": cfg.batch_size, "max_read_len": cfg.max_read_len,
        "probe": clf.probe,
        "stages_s": {k: round(v, 6) for k, v in stages.items()},
        "stages_ms_per_batch": {k: round(1e3 * v / nb, 4)
                                for k, v in stages.items()},
        # each batch's ms a stage (the first one pays any first-use cost)
        "stages_ms_by_batch": {k: [round(1e3 * b_[k], 3)
                                   for b_ in s["per_batch_s"]]
                               for k in STAGES},
        "stages_sum_s": round(sum(stages.values()), 6),
        "serial_total_s": round(s["serial_total_s"], 6),
        "serial_reads_per_sec": round(s["reads"] / s["serial_total_s"], 1),
        "synced_at_stage_boundaries": s["synced"],
        "group_rows": s["group_rows"], "warm_s": round(warm_s, 3),
    }
    for key in ("h2d_events_s", "device_events_s", "gc_s"):
        if key in s:
            line[key] = round(s[key], 6)
    line["gc_collections"] = s["gc_collections"]
    line["cuda_mallocs"] = s["cuda_mallocs"]
    # the two ends of the overlapped loop, each alone: the engine's ring
    # (what the dispatch thread waits on) and the drain thread's work
    line.update({k: round(v, 6) for k, v in ring_pass(cfg).items()})
    line["drain_s"] = round(stages["winner_pairs"] + stages["emit"], 6)
    same = True
    line["overlapped_classify_s"] = []
    for p in range(2):
        kernels.LAUNCHES.reset()
        stats = run_pipeline(cfg, classifier=clf)
        launches.setdefault("overlapped", kernels.LAUNCHES.snapshot())
        line["overlapped_classify_s"].append(round(stats["classify_s"], 6))
        same &= same_bytes(serial_paths, pass_paths)
    line["overlapped_reads_per_sec"] = [
        round(s["reads"] / c, 1) for c in line["overlapped_classify_s"]]
    tdir = os.path.join(d, f"{wl}.trace")
    shutil.rmtree(tdir, ignore_errors=True)
    stats = run_pipeline(dataclasses.replace(cfg, profile_dir=tdir),
                         classifier=clf)
    same &= same_bytes(serial_paths, pass_paths)
    line["profiled_classify_s"] = round(stats["classify_s"], 6)
    summ = trace.summarize(trace.newest_trace(tdir))
    for row in trace.report(summ):
        log(f"{wl} trace: {row}")
    summ["host"] = {tid: {k: v for k, v in h.items()
                          if k != "top_runtime_ms"}
                    for tid, h in summ["host"].items()}
    line["trace"] = summ
    shutil.rmtree(tdir, ignore_errors=True)
    line["launches"] = {k: {n: c for n, c in v.items() if c}
                        for k, v in launches.items()}
    if engine:
        line["engine_stages"] = engine_stages(cfg)
    line["bytes_equal"] = same
    line["device"] = b.out["device"]
    for path in serial_paths:
        if path and os.path.exists(path):
            os.remove(path)
    return line


def workload_config(b: "bench_gpu.Bench", wl: str):
    """(cfg, clf) of `wl` as bench_gpu.py sets them up (set-up seconds
    land in b.stage_s)."""
    if wl in ("panel", "paired", "q10"):
        m = bench_gpu.Main(b)
        inp = m.inputs(wl)
        cfg = b.config(wl, m.fasta, **inp)
        return cfg, b.classifier(wl, cfg, m.idx_dir)[1]
    if wl == "homolog":
        fasta, fastq = bench_gpu.gen_homolog(bench_gpu.HOMOLOG_READS)
        cfg = b.config("homolog", fasta, fastq, max_winners=16)
        return cfg, b.classifier("homolog", cfg)[1]
    fasta, fastq = bench_gpu.gen_txome(bench_gpu.TXOME_GENES,
                                      bench_gpu.TXOME_READS)
    cfg = b.config("txome", fasta, fastq)
    idx_dir = os.path.join(os.path.dirname(fasta),
                           f"index{bench_gpu.TXOME_GENES}.d")
    return cfg, b.classifier("txome", cfg, idx_dir)[1]


def size_workloads(reads: int, cache: str = "") -> None:
    """Set bench_gpu.py's panel, q10, homolog and txome read counts to
    `reads` (paired: reads / 2 pairs) and its cache to `cache`; by default
    a count other than bench_gpu.py's keeps its files in
    build/bench_gpu_reads<N>/, so that bench_gpu.py's own cache is left as
    it is."""
    if cache:
        bench_gpu.CACHE = cache
    elif reads != bench_gpu.N_READS:
        bench_gpu.CACHE = os.path.join(ROOT, "build",
                                       f"bench_gpu_reads{reads}")
    if reads != bench_gpu.N_READS:
        bench_gpu.N_READS = reads
        bench_gpu.N_PAIRS = reads // 2
        bench_gpu.HOMOLOG_READS = bench_gpu.TXOME_READS = reads


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="all",
                    choices=bench_gpu.WORKLOADS + ("all",))
    ap.add_argument("--reads", type=int, default=bench_gpu.N_READS,
                    help="reads a workload (pairs: half as many)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    ap.add_argument("--engine-stages", action="store_true",
                    help="also time the C++ engine's parse, encode, pack")
    ap.add_argument("--cache", default="",
                    help="the workloads' directory (default: bench_gpu.py's"
                         " for the default read count)")
    args = ap.parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        print("profile_e2e_torch: no CUDA card; the split is measured on "
              "the card (--cpu runs the plain versions)", file=sys.stderr)
        return 1
    size_workloads(args.reads, args.cache)
    chosen = [w for w in bench_gpu.WORKLOADS
              if args.workload in ("all", w)]
    b = bench_gpu.Bench(device, float("inf"))
    b.out["device"] = bench_gpu.card_name() if device.type == "cuda" \
        else "cpu"
    rc = 0
    for wl in chosen:
        if wl == "txome":
            b.release()  # the txome's tables need the room
        b.stage_s.clear()
        cfg, clf = workload_config(b, wl)
        log(f"{wl}: set-up {b.stage_s}, probe {clf.probe}")
        line = profile(b, wl, cfg, clf, args.engine_stages)
        line["setup_s"] = dict(b.stage_s)
        print(json.dumps(line), flush=True)
        st = line["stages_s"]
        log(f"{wl}: serial {line['serial_total_s']:.3f} s (stages "
            f"{line['stages_sum_s']:.3f} s: " + ", ".join(
                f"{k} {v:.3f}" for k, v in st.items())
            + f"); overlapped classify_s {line['overlapped_classify_s']}")
        if not line["bytes_equal"]:
            log(f"FAILED: {wl}: a pass's bytes differ from the serial "
                "pass's")
            rc = 1
        del clf
    b.release()
    return rc


if __name__ == "__main__":
    sys.exit(main())
