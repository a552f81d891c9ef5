#!/usr/bin/env python3
"""Does a workload run slower after another one ran in the same process?
The port's counterpart of bench/repro_homolog_slow.py and
bench/repro_homolog_slow2.py.

    python3 scripts/repro_contamination_torch.py [--workload homolog|panel]
        [--reads N] [--with-comparator] [--cpu] [--cache DIR]

The reference found bench.py's homolog about 3.5x slower after the
single-end, paired and q10 stages had run in the same process, and a
clean process fine. bench_gpu.py runs its five workloads in one process
too, after its C++ comparator, and its reads/s spread far more than its
device_ms. On bench_gpu.py's homolog workload (the victim; --workload
panel makes the panel the victim and the homolog the stage before), at
its sizes (500k reads, B = 65536, L = 104, k = 17), with one warm
classifier (one real batch through every path first,
bench/repro_homolog_slow.py:88-98), the steps are:
  before     the serial pass (scripts/profile_e2e_torch.py serial_pass:
             parse, h2d, dispatch, device, fetch_packed, extract_pairs,
             winner_pairs, emit, each batch), twice ("before", "before2"),
             then run_pipeline three times (the overlapped loop);
  stage      bench_gpu.py's panel stage in this process: the panel's
             index and warm classifier, kept alive after it as
             bench_gpu.py keeps them, and its three passes;
             --with-comparator first runs bench/baseline.cpp on every
             host core as bench_gpu.py does (its count then checks the
             passes);
  after      the serial pass and the overlapped passes again;
  after-gc   gc.collect(), then the same (bench/repro_homolog_slow.py:80);
  after-sync os.sync() (dirty output pages written back), then the same:
             a measurement only.
At each step it records the diagnostics of bench/repro_homolog_slow2.py's
diag(): Python's threads and the process's native thread count
(/proc/self/status), torch.cuda's allocated and reserved bytes and the
caching allocator's segments, gc.get_count(), the process's resident
memory, Dirty and Writeback from /proc/meminfo and os.getloadavg(); and
names the diagnostics that moved between "before" and "after" (moved).
Every pass's ssv and FASTQ bytes are held to the first serial pass's
(sha256). Prints one JSON line; exits 1 when bytes differ or a step
fails. Runs on cuda:0 unless --cpu is given (the plain versions); without
a card and without --cpu it exits 1. --reads N and --cache DIR as in
scripts/profile_e2e_torch.py (--cache build/bench_gpu shares
bench_gpu.py's files).
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]

import torch  # noqa: E402

import bench_gpu  # noqa: E402
import profile_e2e_torch as pe  # noqa: E402
from shark_tpu_torch.pipeline import run_pipeline  # noqa: E402


PASSES = 3


def log(msg: str) -> None:
    print(f"[repro_contamination] {msg}", file=sys.stderr, flush=True)


def _proc_fields(path, names) -> dict:
    """{name: int} of the "Name: value [kB]" lines of a /proc file."""
    out = {}
    try:
        with open(path) as f:
            for line in f:
                key, _, rest = line.partition(":")
                if key in names:
                    out[key] = int(rest.split()[0])
    except OSError:
        pass
    return out


def diag(device) -> dict:
    """The process's state (the module's docstring)."""
    status = _proc_fields("/proc/self/status", ("Threads", "VmRSS"))
    mem = _proc_fields("/proc/meminfo", ("Dirty", "Writeback"))
    out = {
        "python_threads": sorted(t.name for t in threading.enumerate()),
        "native_threads": status.get("Threads"),
        "rss_mb": round(status.get("VmRSS", 0) / 1024, 1),
        "gc_count": list(gc.get_count()),
        "dirty_mb": round(mem.get("Dirty", 0) / 1024, 1),
        "writeback_mb": round(mem.get("Writeback", 0) / 1024, 1),
        "loadavg": [round(x, 2) for x in os.getloadavg()],
    }
    if device.type == "cuda":
        stats = torch.cuda.memory_stats(device)
        out.update(
            cuda_allocated_mb=round(torch.cuda.memory_allocated(device)
                                    / 2**20, 1),
            cuda_reserved_mb=round(torch.cuda.memory_reserved(device)
                                   / 2**20, 1),
            cuda_segments=stats.get("segment.all.current", 0))
    return out


def digest(paths) -> list:
    out = []
    for path in paths:
        if path:
            with open(path, "rb") as f:
                out.append(hashlib.sha256(f.read()).hexdigest())
    return out


class Victim:
    """The victim workload's config, warm classifier, and its passes."""

    def __init__(self, cfg, clf, wl):
        self.cfg, self.clf, self.wl = cfg, clf, wl
        d = os.path.dirname(cfg.ssv_path)
        self.serial = [os.path.join(d, f"{wl}.repro{ext}")
                       for ext in (".ssv", ".out1.fq", ".out2.fq")]
        if not cfg.sample2_path:
            self.serial[2] = ""
        self.want = None  # the first serial pass's bytes
        self.bytes_equal = True

    def check(self, got) -> None:
        if self.want is None:
            self.want = got
        elif got != self.want:
            self.bytes_equal = False
            log(f"FAILED: {self.wl}: a pass's bytes differ from the first "
                "serial pass's")

    def serial_pass(self) -> dict:
        s = pe.serial_pass(self.cfg, self.clf, *self.serial)
        self.check(digest(self.serial))
        nb = max(1, s["batches"])
        return {
            "serial_total_s": round(s["serial_total_s"], 6),
            "stages_ms_per_batch": {k: round(1e3 * v / nb, 4)
                                    for k, v in s["stages_s"].items()},
            "stages_ms_by_batch": {k: [round(1e3 * b[k], 3)
                                       for b in s["per_batch_s"]]
                                   for k in pe.STAGES},
            "gc_s": round(s["gc_s"], 6), "cuda_mallocs": s["cuda_mallocs"],
        }

    def overlapped(self) -> dict:
        cls = []
        for _ in range(PASSES):
            stats = run_pipeline(self.cfg, classifier=self.clf)
            cls.append(stats["classify_s"])
            self.check(digest((self.cfg.ssv_path, self.cfg.out1_path,
                               self.cfg.out2_path)))
        n = stats["n_reads"]
        return {"overlapped_classify_s": [round(c, 6) for c in cls],
                "overlapped_reads_per_sec": [round(n / c, 1) for c in cls]}

    def step(self, name: str, serial_passes: int = 1) -> dict:
        out = {"diag": diag(self.clf.device)}
        for i in range(serial_passes):
            key = name if i == 0 else f"{name}{i + 1}"
            out[f"serial_{key}"] = self.serial_pass()
        out.update(self.overlapped())
        out["diag_after"] = diag(self.clf.device)
        serial = [v["serial_total_s"] for k, v in out.items()
                  if k.startswith("serial_")]
        log(f"{name}: serial {serial} s, overlapped "
            f"{out['overlapped_reads_per_sec']} reads/s")
        return out


def stage_before(b, wl: str, with_comparator: bool):
    """bench_gpu.py's stage of `wl` in this process (the module's
    docstring); returns (its line, what it keeps alive)."""
    if wl == "panel":
        m = bench_gpu.Main(b)
        inp = m.inputs("panel")
        fasta, fastq, idx_dir = m.fasta, inp["fastq"], m.idx_dir
    else:
        fasta, fastq = bench_gpu.gen_homolog(bench_gpu.HOMOLOG_READS)
        idx_dir = ""
    want = None
    if with_comparator:
        want = b.comparator(wl, fasta, fastq)["n_associations"]
    cfg = b.config(wl, fasta, fastq,
                   **({"max_winners": 16} if wl == "homolog" else {}))
    kept = b.classifier(wl, cfg, idx_dir)
    if want is None:
        want = run_pipeline(cfg, classifier=kept[1])["n_associations"]
    best = b.passes(wl, cfg, kept[1], want)
    return {"workload": wl, "reads_per_sec": round(
        best["n_reads"] / best["classify_s"], 1),
        "n_associations": best["n_associations"],
        "comparator": with_comparator}, kept


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="homolog",
                    choices=("homolog", "panel"),
                    help="the victim (the other is the stage before)")
    ap.add_argument("--reads", type=int, default=bench_gpu.N_READS)
    ap.add_argument("--with-comparator", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    ap.add_argument("--cache", default="")
    args = ap.parse_args(argv)
    if device is None:
        if args.cpu:
            device = "cpu"
        elif torch.cuda.is_available():
            device = "cuda:0"
        else:
            print("repro_contamination_torch: no CUDA card; the steps are "
                  "measured on the card (--cpu runs the plain versions)",
                  file=sys.stderr)
            return 1
    device = torch.device(device)
    pe.size_workloads(args.reads, args.cache)
    b = bench_gpu.Bench(device, float("inf"))
    cfg, clf = pe.workload_config(b, args.workload)
    victim = Victim(cfg, clf, args.workload)
    pe.warm(cfg, clf)
    steps = {}
    t0 = time.perf_counter()
    steps["before"] = victim.step("before", serial_passes=2)
    other = "panel" if args.workload == "homolog" else "homolog"
    stage, kept = stage_before(b, other, args.with_comparator)
    steps["stage"] = {**stage, "diag": diag(device)}
    log(f"stage: {stage}")
    steps["after"] = victim.step("after")
    gc.collect()
    steps["after-gc"] = victim.step("after-gc")
    os.sync()
    steps["after-sync"] = victim.step("after-sync")
    del kept
    for path in victim.serial:
        if path and os.path.exists(path):
            os.remove(path)
    before, after = steps["before"]["diag"], steps["after"]["diag"]
    line = {
        "workload": args.workload, "stage_before": other,
        "reads": args.reads, "batch_size": cfg.batch_size,
        "steps": steps,
        "moved": {k: [before[k], after[k]] for k in before
                  if before[k] != after[k]},
        "reads_per_sec_best": {
            k: max(v["overlapped_reads_per_sec"]) for k, v in steps.items()
            if "overlapped_reads_per_sec" in v},
        "serial_total_s": {
            k: v[f"serial_{k}"]["serial_total_s"] for k, v in steps.items()
            if f"serial_{k}" in v},
        "bytes_equal": victim.bytes_equal, "failures": b.failures,
        "seconds": round(time.perf_counter() - t0, 3),
        "device": bench_gpu.card_name() if device.type == "cuda" else "cpu"}
    print(json.dumps(line), flush=True)
    return 0 if victim.bytes_equal and not b.failures else 1


if __name__ == "__main__":
    sys.exit(main())
