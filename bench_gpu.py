#!/usr/bin/env python3
"""Benchmark: shark_tpu_torch on one CUDA card against a CPU comparator of
the reference algorithm.

The port's counterpart of bench.py together with the run() of
bench/homolog_bench.py and bench/transcriptome_bench.py: their five
workloads at their sizes, generated from their seeds byte for byte; the
full shark_tpu_torch pipeline on cuda:0 (the C++ engine's FASTQ parse and
planar pack, the card's classify kernels, the drain, the ssv and FASTQ
write) timed over its classify phase, best of 3 passes against one warm
classifier; and bench/baseline.cpp, an independent C++ implementation of
the reference's algorithm, compiled from its place in the repo and run on
every host core (best of 3).

    python3 bench_gpu.py [--workload panel|paired|q10|homolog|txome|all]

Workloads (k 17, c 0.6, -b 1 = 2^33 Bloom bits, batch 65536 reads):
  panel    500 genes x 1500 bp, 500k 100 bp reads (2% errors and Ns);
           also --backend native (the host's CPUs, no card) and the card's
           gather ceiling
  paired   the panel's genes, 250k innie pairs (mate 2 reverse-complemented)
  q10      the panel's reads with an Illumina-like quality profile, -q 10
  homolog  500 genes in families of 8 sharing a 300 bp core, 500k reads
  txome    50,000 genes x 1500 bp (every 80th gene starts a family of 8),
           500k reads, --save-index, auto layout; its second pass runs on
           the index and probe tables loaded back from disk; every read's
           associations are held against the comparator's full dump, and
           about 2000 against the oracle
The panel, paired and q10 workloads are visited a second time at the end
(the comparator too), on their classifier loaded back from the saved
index and its probe-table cache, and the better window counts.

Prints ONE JSON line with bench.py's keys:
  {"metric": "reads_per_sec", "value": N, "unit": "reads/s",
   "vs_baseline": R, "probes_per_sec": P, "pct_gather_ceiling": C,
   "paired_reads_per_sec": N2, "paired_vs_baseline": R2,
   "q10_reads_per_sec": N3, "q10_vs_baseline": R3,
   "homolog_reads_per_sec": N4, "homolog_vs_baseline": R4,
   "txome_reads_per_sec": N5, "txome_n_genes": 50000,
   "txome_oracle_checked": 2000ish, "txome_full_reads_checked": 500000,
   "<wl>_device_ms": ..., "<wl>_device_reads_per_sec": ...,
   "<wl>_baseline_spread": [min, max], ...}
(the panel's keys carry no prefix), and beside them "<wl>_exact" for each
workload run ("native_cpu_exact" for --backend native), the
native_cpu_*, gather_ceiling_* and per-stage "stage_s" keys, and "device":
the card's name and power limit as nvidia-smi prints them. A workload is
exact when every pass writes the comparator's association count, and the
txome also when its ssv equals the comparator's full dump and the oracle
sample agrees. An inexact or failed workload makes the run exit 1 after
the line; so does a run without a CUDA card, whose line holds "error".

<wl>_device_ms is one resident batch of 65536 reads through the warm
classifier (call_packed and the fetch of its packed verdicts to the host,
best of 5): the card's share without the host stream or the comparator.
pct_gather_ceiling holds the panel's probes/s against the card's
random-row rate on a u32[2^19, 8] table: the better of
torch.index_select with the sum of the rows (as bench.py's jnp.take;
gather_ceiling_ms gives each part's time) and the bare 32-byte row
gather of shark_tpu_torch/floors.py (gather_ceiling_bare_ms);
gather_ceiling_by names the one that set it.

Everything it writes goes under build/bench_gpu/, where the workloads, the
saved indexes and their probe-table caches (7.2 GB) stay for warm
re-runs; a stamp naming every constant guards each workload's directory.
BENCH_BUDGET_S (default 2700) skips later stages once spent,
BENCH_PRIMARY_ONLY=1 keeps the panel only, BENCH_SKIP_TXOME=1 drops the
txome, and SIGTERM prints the partial line (with "error").
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import shutil
import signal
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from shark_tpu_torch import config, floors
from shark_tpu_torch.classify import table_cache
from shark_tpu_torch.classify.oracle import classify_read
from shark_tpu_torch.classify.step import Classifier
from shark_tpu_torch.config import SharkConfig
from shark_tpu_torch.io.native import NativeStream
from shark_tpu_torch.ops.kmers import encode_bytes
from shark_tpu_torch.pipeline import (
    _join_index_save,
    _ShimIndex,
    load_or_build_index,
    run_pipeline,
)
from shark_tpu_torch.utils.timers import PhaseTimer

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, "build", "bench_gpu")
BASELINE_SRC = os.path.join(ROOT, "bench", "baseline.cpp")

K = 17
C = 0.6
BF_GB = 1  # the reference's default -b 1: config.BF_UNIT_BITS bits
N_GENES = 500
GENE_LEN = 1500
N_READS = 500_000
N_PAIRS = 250_000
READ_LEN = 100
MAX_LEN = 104  # 100 bp padded to a multiple of 8: 88 probe windows
PAIR_MAX_LEN = 208  # 100 + 1 + 100 fused, padded to a multiple of 8
BATCH = 65536
HOMOLOG_GENES = 500
HOMOLOG_READS = 500_000
CORE = 300
TXOME_GENES = 50_000
TXOME_READS = 500_000
N_ORACLE = 2000  # txome reads held against the oracle, on average
GATHER_ROWS = 1 << 19  # the hashed probe table's bucket rows (16 MB)
WORKLOADS = ("panel", "paired", "q10", "homolog", "txome")


def log(msg: str) -> None:
    print(f"[bench_gpu] {msg}", file=sys.stderr, flush=True)


def bf_bits() -> int:
    return BF_GB * config.BF_UNIT_BITS


# ---------------------------------------------------------------------------
# workloads: bench.py's and its two sub-benches' generators, draw for draw
# ---------------------------------------------------------------------------


def _fresh_dir(path: str, stamp: str) -> bool:
    """True when `path` holds a complete generation under `stamp` (written
    last, naming every constant). Otherwise empty the directory, including
    any index built from older files, and return False."""
    if os.path.exists(os.path.join(path, stamp)):
        return True
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return False


def gen_workload():
    """bench.py's gen_workload (bench.py:110-195): the panel's FASTA, its
    single-end reads plain and with qualities, and the read pairs."""
    d = os.path.join(CACHE, "main")
    fasta = os.path.join(d, "genes.fa")
    fastq = os.path.join(d, "reads.fq")
    fastq_q = os.path.join(d, "reads_q.fq")
    fq_p1 = os.path.join(d, "pairs_1.fq")
    fq_p2 = os.path.join(d, "pairs_2.fq")
    paths = (fasta, fastq, fastq_q, fq_p1, fq_p2)
    stamp = (f"stamp_{N_GENES}x{GENE_LEN}_{N_READS}x{READ_LEN}_{N_PAIRS}p"
             f"_k{K}_b{bf_bits()}")
    if _fresh_dir(d, stamp):
        return paths
    log("generating the panel workloads ...")
    rng = np.random.default_rng(12345)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    rc_map = np.array([3, 2, 1, 0], dtype=np.uint8)
    genes = []
    with open(fasta, "wb") as f:
        for g in range(N_GENES):
            seq = bases[rng.integers(0, 4, size=GENE_LEN)]
            genes.append(seq)
            f.write(b">GENE%05d\n" % g)
            f.write(seq.tobytes() + b"\n")
    code = np.full(256, 0, np.uint8)
    for i, b in enumerate(b"ACGT"):
        code[b] = i
    err_bases = np.frombuffer(b"ACGTN", dtype=np.uint8)

    def read_from(gi, start, rc=False):
        arr = genes[gi][start : start + READ_LEN].copy()
        mut = rng.random(READ_LEN) < 0.02
        nm = int(mut.sum())
        if nm:
            arr[mut] = err_bases[rng.integers(0, 5, size=nm)]
        if rc:
            arr = bases[rc_map[code[arr[::-1]]]]
        return arr

    qual_const = b"I" * READ_LEN
    with open(fastq, "wb") as f, open(fastq_q, "wb") as fq:
        gidx = rng.integers(0, N_GENES, size=N_READS)
        starts = rng.integers(0, GENE_LEN - READ_LEN, size=N_READS)
        for i in range(N_READS):
            arr = read_from(int(gidx[i]), int(starts[i]))
            rec_head = b"@r%07d\n" % i
            f.write(rec_head + arr.tobytes() + b"\n+\n" + qual_const + b"\n")
            # bench.py's quality profile: ~97% of bases q30..40, ~3% q2..19
            q = rng.integers(30, 41, size=READ_LEN)
            low = rng.random(READ_LEN) < 0.03
            q[low] = rng.integers(2, 20, size=int(low.sum()))
            q = (q + 33).astype(np.uint8)
            fq.write(rec_head + arr.tobytes() + b"\n+\n" + q.tobytes() + b"\n")
    with open(fq_p1, "wb") as f1, open(fq_p2, "wb") as f2:
        gidx = rng.integers(0, N_GENES, size=N_PAIRS)
        starts = rng.integers(0, GENE_LEN - READ_LEN - 220, size=N_PAIRS)
        for i in range(N_PAIRS):
            gi, s1 = int(gidx[i]), int(starts[i])
            m1 = read_from(gi, s1)
            m2 = read_from(gi, s1 + 180, rc=True)  # innie pair, mate 2 RC'd
            f1.write(b"@p%07d\n" % i + m1.tobytes() + b"\n+\n" + qual_const
                     + b"\n")
            f2.write(b"@p%07d\n" % i + m2.tobytes() + b"\n+\n" + qual_const
                     + b"\n")
    open(os.path.join(d, stamp), "w").close()
    return paths


def gen_homolog(n_reads: int):
    """bench/homolog_bench.py's workload (:32-70): families of 8 genes
    sharing a 300 bp core; even reads from the core (ties across the
    family), odd ones from the left flank."""
    d = os.path.join(CACHE, "homolog")
    fasta = os.path.join(d, "genes.fa")
    fastq = os.path.join(d, f"reads{n_reads}.fq")
    stamp = (f"stamp_{HOMOLOG_GENES}x{GENE_LEN}_core{CORE}"
             f"_{n_reads}x{READ_LEN}")
    if _fresh_dir(d, stamp):
        return fasta, fastq
    log("generating the homolog workload ...")
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    rng = np.random.default_rng(4242)
    genes = []
    core_start = (GENE_LEN - CORE) // 2
    with open(fasta, "wb") as f:
        for g in range(HOMOLOG_GENES):
            if g % 8 == 0:
                core = bases[rng.integers(0, 4, size=CORE)]
            left = bases[rng.integers(0, 4, size=core_start)]
            right = bases[rng.integers(0, 4, size=GENE_LEN - core_start - CORE)]
            seq = np.concatenate([left, core, right])
            genes.append(seq)
            f.write(b">G%04d\n" % g + seq.tobytes() + b"\n")
    qual = b"I" * READ_LEN
    with open(fastq, "wb") as f:
        for i in range(n_reads):
            gi = int(rng.integers(0, HOMOLOG_GENES))
            if i % 2 == 0:  # core-only read: ties across the family
                start = int(rng.integers(core_start,
                                         core_start + CORE - READ_LEN))
            else:
                start = int(rng.integers(0, core_start - READ_LEN))
            arr = genes[gi][start : start + READ_LEN]
            f.write(b"@r%07d\n" % i + arr.tobytes() + b"\n+\n" + qual + b"\n")
    open(os.path.join(d, stamp), "w").close()
    return fasta, fastq


def gen_txome(n_genes: int, n_reads: int):
    """bench/transcriptome_bench.py's workload (:37-84): every 80th gene
    starts a family of 8 sharing a 300 bp core between random 600 bp
    flanks; the rest are random; reads are exact 100 bp substrings."""
    d = os.path.join(CACHE, "txome")
    fasta = os.path.join(d, f"genes{n_genes}.fa")
    fastq = os.path.join(d, f"reads{n_genes}_{n_reads}.fq")
    stamp = (f"stamp_{n_genes}x{GENE_LEN}_{n_reads}x{READ_LEN}_k{K}"
             f"_b{bf_bits()}")
    if _fresh_dir(d, stamp):
        return fasta, fastq
    log(f"generating {n_genes} genes x {GENE_LEN} bp + {n_reads} reads ...")
    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genes = []
    with open(fasta, "wb") as f:
        fam_core = None
        for g in range(n_genes):
            if g % 80 == 0:
                fam_core = bases[rng.integers(0, 4, size=300)]
            if g % 80 < 8:
                left = bases[rng.integers(0, 4, size=600)]
                right = bases[rng.integers(0, 4, size=600)]
                seq = np.concatenate([left, fam_core, right])
            else:
                seq = bases[rng.integers(0, 4, size=GENE_LEN)]
            genes.append(seq)
            f.write(b">G%05d\n" % g + seq.tobytes() + b"\n")
    qual = b"I" * READ_LEN
    with open(fastq, "wb") as f:
        gidx = rng.integers(0, n_genes, size=n_reads)
        starts = rng.integers(0, GENE_LEN - READ_LEN, size=n_reads)
        for i in range(n_reads):
            arr = genes[int(gidx[i])][int(starts[i]) : int(starts[i])
                                      + READ_LEN]
            f.write(b"@r%07d\n" % i + arr.tobytes() + b"\n+\n" + qual + b"\n")
    open(os.path.join(d, stamp), "w").close()
    return fasta, fastq


# ---------------------------------------------------------------------------
# the comparator, the card's measurements
# ---------------------------------------------------------------------------


def build_baseline() -> str:
    """Compile bench/baseline.cpp for this host (bench.py:197-209). Built
    anew by every run, so no binary made for another CPU is ever run."""
    os.makedirs(CACHE, exist_ok=True)
    exe = os.path.join(CACHE, "baseline")
    log("compiling the CPU comparator ...")
    subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-pthread",
                    "-o", exe, BASELINE_SRC], check=True)
    return exe


def settle(index=None) -> None:
    """Keep background disk work out of the timed passes (bench.py:212-230):
    join a pending index save and the probe-table cache writes, and flush
    dirty pages."""
    if index is not None:
        _join_index_save(index, PhaseTimer())
    table_cache.join_pending()
    subprocess.run(["sync"], check=False)


def measure_gather_ceiling(device: torch.device):
    """Rows/s of the hashed probe table's gather shape on `device`
    (bench.py:70-103): u32[2^19, 8] bucket rows and one batch of probe
    windows' random row indices (seed 7), gathered two ways, best of 3
    each (CUDA events on the card): torch.index_select and a sum of the
    rows, less the time of summing the indices alone, as bench.py's
    jnp.take; and the bare 32-byte row gather of
    shark_tpu_torch/floors.py, each row folded to one word, held equal to
    its plain version first: the card's random-row rate without the
    library's overhead. The ceiling is the better of the two rates, as
    bench.py:679-681 keeps the best of its measurements. Measurements, not
    kernels of the port. Returns (rows/s, index_select's best ms by part:
    the gather and sum, the index sum, index_select alone and the sum of
    its rows alone; the bare gather's best ms; "bare_gather32" or
    "index_select", whichever set the ceiling)."""
    n_idx = BATCH * (MAX_LEN - K + 1)
    rng = np.random.default_rng(7)
    idx = torch.from_numpy(
        rng.integers(0, GATHER_ROWS, size=n_idx, dtype=np.int64)
        .astype(np.int32)).to(device)
    # the table's u32 words as int32 (the same bytes): index_select and
    # sum take no uint32 on every device
    table = torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, size=(GATHER_ROWS, 8), dtype=np.int32)).to(
            device)
    if not torch.equal(floors.rows(table, idx, 32),
                       floors.rows_plain(table, idx, 32)):
        raise RuntimeError("the bare 32-byte gather disagrees with its "
                           "plain version")

    def gather():
        return torch.index_select(table, 0, idx).sum(0)

    def floor():
        return idx.sum()

    def seconds(fn) -> float:
        if device.type != "cuda":
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3

    rows = torch.index_select(table, 0, idx)
    parts = {"index_select_sum": gather, "idx_sum": floor,
             "index_select": lambda: torch.index_select(table, 0, idx),
             "rows_sum": lambda: rows.sum(0)}

    def bare():
        return floors.rows(table, idx, 32)

    for fn in (*parts.values(), bare):  # warm
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    best = {name: min(seconds(fn) for _ in range(3))
            for name, fn in parts.items()}
    bare_s = min(seconds(bare) for _ in range(3))
    dt = max(best["index_select_sum"] - best["idx_sum"], 1e-9)
    rates = {"index_select": n_idx / dt,
             "bare_gather32": n_idx / max(bare_s, 1e-9)}
    by = max(rates, key=rates.get)
    return (rates[by], {k: round(1e3 * v, 4) for k, v in best.items()},
            round(1e3 * bare_s, 4), by)


def card_name() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return f"{torch.cuda.get_device_name(0)} (power limit not read)"


class Bench:
    """One run's state: the device, the comparator and its rates, the warm
    classifiers, the stage clocks and the line being built."""

    def __init__(self, device: torch.device, budget_s: float):
        self.device = device
        self.t_start = time.time()
        self.budget_s = budget_s
        self.exe = None
        self.base_rps: dict = {}  # workload -> every comparator pass's reads/s
        self.warm: dict = {}  # index dir -> (index, Classifier)
        self.exact: dict = {}  # workload -> every check held
        self.failures: list = []
        self.stage_s: dict = {}
        self.out: dict = {
            "metric": "reads_per_sec", "unit": "reads/s",
            "error": "partial: the run was stopped before it ended",
        }

    def over_budget(self, stage: str) -> bool:
        spent = time.time() - self.t_start
        if spent > self.budget_s:
            log(f"budget {self.budget_s:.0f}s spent ({spent:.0f}s); "
                f"skipping {stage}")
            return True
        return False

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stage_s[name] = round(
                self.stage_s.get(name, 0.0) + time.perf_counter() - t0, 3)

    def fail(self, msg: str) -> None:
        self.failures.append(msg)
        log(f"FAILED: {msg}")

    def check(self, wl: str, ok: bool, msg: str) -> None:
        self.exact.setdefault(wl, True)
        if not ok:
            self.exact[wl] = False
            self.fail(msg)

    def check_count(self, wl: str, got: int, want: int) -> None:
        self.check(wl, got == want,
                   f"{wl}: association count {got} differs from the "
                   f"comparator's {want}")

    def comparator(self, wl: str, fasta, fastq, fastq2="", minq=0,
                   best_of=3, dump="") -> dict:
        """bench/baseline.cpp best of `best_of` (bench.py:239-263); `dump`:
        its full (read index, gene id) association list (argv[9])."""
        if self.exe is None:
            with self.stage("comparator_build"):
                self.exe = build_baseline()
        settle()
        threads = os.cpu_count() or 1
        best = None
        with self.stage(f"{wl}_comparator"):
            for _ in range(best_of):
                out = subprocess.run(
                    [self.exe, fasta, fastq, str(K), str(C), str(bf_bits()),
                     str(threads), fastq2, str(minq), dump],
                    check=True, capture_output=True, text=True,
                ).stdout
                res = json.loads(out.strip().splitlines()[-1])
                self.base_rps.setdefault(wl, []).append(
                    res["reads_per_sec"])
                if best is None or res["reads_per_sec"] > best["reads_per_sec"]:
                    best = res
        log(f"comparator ({wl}): {best}")
        return best

    def spread(self, wl: str):
        """[min, max] comparator reads/s over every pass of `wl`."""
        rates = self.base_rps.get(wl)
        if not rates:
            return None
        return [round(min(rates), 1), round(max(rates), 1)]

    def config(self, wl, fasta, fastq, fastq2="", minq=0, max_len=MAX_LEN,
               **kw) -> SharkConfig:
        d = os.path.dirname(fasta)
        return SharkConfig(
            fasta_path=fasta, sample1_path=fastq, sample2_path=fastq2,
            out1_path=os.path.join(d, f"{wl}.out1.fq"),
            out2_path=os.path.join(d, f"{wl}.out2.fq") if fastq2 else "",
            ssv_path=os.path.join(d, f"{wl}.ssv"),
            k=K, c=C, bf_gb=BF_GB, min_quality=minq, batch_size=BATCH,
            max_read_len=max_len, **kw)

    def classifier(self, tag: str, cfg: SharkConfig, idx_dir: str = "",
                   reload: bool = False):
        """The warm (index, Classifier) of `idx_dir` (bench.py:345-368): on
        first use the index is loaded from the directory or built and
        saved there, and the probe tables come from its "<dir>.tables"
        cache or are built and cached; `reload` loads both back from disk
        even when a warm pair exists. Without `idx_dir` the index is built
        and kept nowhere (bench/homolog_bench.py:93-94)."""
        warm = self.warm.get(idx_dir) if idx_dir else None
        if warm is not None and not reload:
            settle()
            return warm
        self.warm.pop(idx_dir, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        opts = {}
        if idx_dir:
            saved = os.path.isdir(idx_dir)
            cfg = dataclasses.replace(
                cfg, load_index=idx_dir if saved else "",
                save_index="" if saved else idx_dir)
            opts["cache_dir"] = idx_dir.rstrip("/") + ".tables"
        with self.stage(f"{tag}_index"):
            index = load_or_build_index(cfg, PhaseTimer())
            settle(index)  # the index save must not overlap the passes
        with self.stage(f"{tag}_tables"):
            clf = Classifier(index, max_winners=cfg.max_winners, c=cfg.c,
                             device=self.device, probe_opts=opts)
            settle()  # nor the probe-table cache write
        log(f"{tag}: probe path {clf.probe}, {index.n_genes} genes, "
            f"{index.n_set_bits} set bits")
        if idx_dir:
            self.warm[idx_dir] = (index, clf)
        return index, clf

    def passes(self, wl: str, cfg: SharkConfig, clf, want: int,
               n: int = 3, tag: str = "") -> dict:
        """run_pipeline(cfg, classifier=clf) `n` times (bench.py:373-379);
        every pass must write the comparator's association count. Returns
        the pass of least classify_s. `tag` names the stage (default
        `wl`)."""
        best = None
        with self.stage(f"{tag or wl}_passes"):
            for p in range(n):
                stats = run_pipeline(cfg, classifier=clf)
                log(f"{wl} pass {p}: {stats}")
                self.check_count(wl, stats["n_associations"], want)
                if best is None or stats["classify_s"] < best["classify_s"]:
                    best = stats
        return best

    def device_only(self, wl: str, prefix: str, clf, fastq, fastq2="",
                    minq=0, max_len=MAX_LEN, reps=5) -> None:
        """One resident batch through the warm classifier, best of `reps`
        (bench.py:275-316): call_packed and the fetch of its packed
        verdicts to the host. The batch comes from the C++ engine's stream
        and is copied to the device once, before timing. Keeps the better
        of two windows in <prefix>device_ms / <prefix>device_reads_per_sec."""
        with self.stage(f"{wl}_device"):
            ns = NativeStream(fastq, fastq2, BATCH, max_len, minq,
                              packed=True)
            try:
                packed, vmask, _, n = ns.next_batch()
            finally:
                ns.close()
            pk = torch.from_numpy(packed).to(self.device)
            vm = torch.from_numpy(vmask).to(self.device)
            clf.call_packed(pk, vm)[0].cpu()  # warm
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                clf.call_packed(pk, vm)[0].cpu()
                best = min(best, time.perf_counter() - t0)
        ms = round(1000 * best, 3)
        key = f"{prefix}device_ms"
        if key not in self.out or ms < self.out[key]:
            self.out[key] = ms
            self.out[f"{prefix}device_reads_per_sec"] = round(n / best, 1)
        log(f"{wl} device-only: {ms} ms a batch of {n}")

    def release(self) -> None:
        self.warm.clear()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the workloads, in bench.py's order
# ---------------------------------------------------------------------------


def primary_out(best: dict, base: dict, ceiling: float) -> dict:
    value = best["n_reads"] / best["classify_s"]
    probes_s = value * (MAX_LEN - K + 1)
    res = {
        "value": round(value, 1),
        "vs_baseline": round(value / base["reads_per_sec"], 3),
        "probes_per_sec": round(probes_s, 0),
        "pct_gather_ceiling": round(100 * probes_s / ceiling, 2),
        "native": bool(best.get("native", False)),
    }
    if not res["native"]:
        res["warning"] = ("PYTHON HOST PATH: native engine unavailable — "
                          "throughput is not representative of the engine")
        log("WARNING: " + res["warning"])
    return res


class Main:
    """The panel, paired and q10 workloads on the panel's index
    (bench.py:408-608, 672-721), with their second visit."""

    def __init__(self, b: Bench):
        self.b = b
        (self.fasta, self.fastq, self.fastq_q, self.fq_p1,
         self.fq_p2) = gen_workload()
        self.idx_dir = os.path.join(CACHE, "main", "index.d")
        self.base = {}
        self.best = {}
        self.ceiling = 0.0
        self.ceiling_ms = None
        self.ceiling_bare_ms = None
        self.ceiling_by = None

    def inputs(self, wl: str):
        return {
            "panel": dict(fastq=self.fastq),
            "paired": dict(fastq=self.fq_p1, fastq2=self.fq_p2,
                           max_len=PAIR_MAX_LEN),
            "q10": dict(fastq=self.fastq_q, minq=10),
        }[wl]

    def visit(self, wl: str, reload: bool = False) -> None:
        b = self.b
        inp = self.inputs(wl)
        tag = f"{wl}_revisit" if reload else wl
        base = b.comparator(
            wl, self.fasta, inp["fastq"], inp.get("fastq2", ""),
            inp.get("minq", 0),
            best_of=(3 if wl == "panel" else 2) if not reload else
            (2 if wl == "panel" else 1))
        if wl not in self.base:
            self.base[wl] = base
        else:
            # the comparator's count is its own: the windows must agree
            b.check_count(wl, base["n_associations"],
                          self.base[wl]["n_associations"])
            if base["reads_per_sec"] > self.base[wl]["reads_per_sec"]:
                log(f"re-visit improved the {wl} comparator; using it")
                self.base[wl] = base
        cfg = b.config(wl, self.fasta, **inp)
        _, clf = b.classifier(tag, cfg, self.idx_dir, reload=reload)
        best = b.passes(wl, cfg, clf, self.base[wl]["n_associations"],
                        tag=tag)
        prev = self.best.get(wl)
        if prev is None or best["classify_s"] < prev["classify_s"]:
            if prev is not None:
                log(f"re-visit improved the {wl} number; using it")
            self.best[wl] = best
        prefix = "" if wl == "panel" else f"{wl}_"
        if wl == "panel":
            with b.stage("gather_ceiling"):
                c, parts, bare_ms, by = measure_gather_ceiling(b.device)
            log(f"measured gather ceiling: {c / 1e6:.1f}M rows/s ({by}); "
                f"index_select {parts}, bare gather {bare_ms} ms")
            if c > self.ceiling:
                self.ceiling, self.ceiling_ms = c, parts
                self.ceiling_bare_ms, self.ceiling_by = bare_ms, by
            b.out.update(primary_out(self.best[wl], self.base[wl],
                                     self.ceiling))
        else:
            v = self.best[wl]["n_reads"] / self.best[wl]["classify_s"]
            b.out[f"{wl}_reads_per_sec"] = round(v, 1)
            b.out[f"{wl}_vs_baseline"] = round(
                v / self.base[wl]["reads_per_sec"], 3)
        b.device_only(wl, prefix, clf, **inp)

    def native_cpu(self) -> None:
        """--backend native on the panel (bench.py:524-553): the C++ host
        classify on every host core, from the saved index; no card."""
        b = self.b
        cfg = b.config("native_cpu", self.fasta, self.fastq,
                       backend="native", threads=os.cpu_count() or 1,
                       load_index=self.idx_dir)
        with b.stage("native_cpu"):
            stats = run_pipeline(cfg)
        log(f"--backend native: {stats}")
        b.check_count("native_cpu", stats["n_associations"],
                      self.base["panel"]["n_associations"])
        v = stats["n_reads"] / stats["classify_s"]
        b.out["native_cpu_reads_per_sec"] = round(v, 1)
        b.out["native_cpu_vs_baseline"] = round(
            v / self.base["panel"]["reads_per_sec"], 3)


def homolog(b: Bench) -> None:
    """bench/homolog_bench.py's run (:32-141): tie-heavy reads, the
    multi-winner output path; the index is built and kept nowhere."""
    with b.stage("generate_homolog"):
        fasta, fastq = gen_homolog(HOMOLOG_READS)
    base = b.comparator("homolog", fasta, fastq, best_of=2)
    cfg = b.config("homolog", fasta, fastq, max_winners=16)
    _, clf = b.classifier("homolog", cfg)
    best = b.passes("homolog", cfg, clf, base["n_associations"], n=2)
    v = best["n_reads"] / best["classify_s"]
    log(f"homolog: {best['n_associations'] / max(1, best['n_reads_out']):.2f}"
        " associations an emitted read")
    b.out["homolog_reads_per_sec"] = round(v, 1)
    b.out["homolog_vs_baseline"] = round(v / base["reads_per_sec"], 3)
    b.device_only("homolog", "homolog_", clf, fastq)


def oracle_sample(b: Bench, index, ssv, fastq: str, n_reads: int) -> int:
    """About N_ORACLE reads of `fastq`, each held against the oracle
    (bench/transcriptome_bench.py:140-178); returns how many."""
    shim = _ShimIndex(index)
    got_by_read: dict = {}
    for r, g in ssv:
        got_by_read.setdefault(r, []).append(g)
    rng = np.random.default_rng(1)
    checked = 0
    bad = []
    with open(fastq, "rb") as f:
        lines = []
        for line in f:
            lines.append(line)
            if len(lines) < 4:
                continue
            rid = lines[0][1:].strip().decode()
            seq = lines[1].strip()
            lines = []
            if rng.random() < N_ORACLE / n_reads:
                wins, _, _ = classify_read(shim, encode_bytes(seq), C, False)
                want = [index.gene_names[g] for g in wins]
                got = got_by_read.get(rid, [])
                if got != want:
                    bad.append(f"{rid} writes {got}, the oracle {want}")
                checked += 1
    b.check("txome", not bad,
            f"txome: {len(bad)} of {checked} reads differ from the oracle, "
            f"first {bad[:1]}")
    return checked


def txome(b: Bench) -> None:
    """bench/transcriptome_bench.py's run (:37-268): 50k genes, the index
    saved beside the workload (--save-index) and its probe tables cached;
    the first pass on what was built, the second on both loaded back from
    disk; every read against the comparator's full dump, a sample against
    the oracle."""
    with b.stage("generate_txome"):
        fasta, fastq = gen_txome(TXOME_GENES, TXOME_READS)
    d = os.path.dirname(fasta)
    dump = os.path.join(d, "base_assoc.txt")
    base = b.comparator("txome", fasta, fastq, best_of=1, dump=dump)
    cfg = b.config("txome", fasta, fastq)
    idx_dir = os.path.join(d, f"index{TXOME_GENES}.d")
    want = base["n_associations"]
    _, clf = b.classifier("txome", cfg, idx_dir)
    stats = b.passes("txome", cfg, clf, want, n=1)
    index, clf = b.classifier("txome_reload", cfg, idx_dir, reload=True)
    stats2 = b.passes("txome", cfg, clf, want, n=1, tag="txome_reload")
    if stats2["classify_s"] < stats["classify_s"]:
        stats = stats2
    with b.stage("txome_check"):
        with open(cfg.ssv_path) as f:  # the second pass's
            ours = [tuple(line.split()) for line in f]
        b.out["txome_oracle_checked"] = oracle_sample(
            b, index, ours, fastq, stats["n_reads"])
        # the comparator's pairs are (read index, gene id): reads are
        # written as r%07d in order and genes in FASTA order
        with open(dump) as f:
            theirs = sorted((f"r{int(ri):07d}", index.gene_names[int(gi)])
                            for ri, gi in (line.split() for line in f))
        # the port writes reads ascending, genes ascending within a read
        same = ours == theirs
        if not same:
            ours_s = sorted(ours)
            at = next((i for i, (x, y) in enumerate(zip(ours_s, theirs))
                       if x != y), min(len(ours_s), len(theirs)))
            b.check("txome", False,
                    f"txome: full dump differs from the comparator's at "
                    f"sorted position {at}: ours {ours_s[at:at + 3]}, "
                    f"theirs {theirs[at:at + 3]}")
        else:
            b.out["txome_full_reads_checked"] = stats["n_reads"]
            log(f"txome: {len(ours)} associations over {stats['n_reads']} "
                "reads equal the comparator's dump")
    v = stats["n_reads"] / stats["classify_s"]
    b.out["txome_reads_per_sec"] = round(v, 1)
    b.out["txome_n_genes"] = index.n_genes
    b.out["txome_probe"] = clf.probe
    b.out["txome_vs_baseline"] = round(v / base["reads_per_sec"], 3)
    b.device_only("txome", "txome_", clf, fastq)


# ---------------------------------------------------------------------------


def main(argv=None, device=None) -> int:
    """Run the selected workloads and print the line; returns the exit
    code. `device`: None = the CUDA card (without one the line holds
    "error" and the code is 1); the tests pass "cpu"."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="all",
                    choices=WORKLOADS + ("all",),
                    help="the workload to run (default: all five)")
    args = ap.parse_args(argv)
    if device is None:
        if not torch.cuda.is_available():
            print(json.dumps({
                "metric": "reads_per_sec", "unit": "reads/s",
                "error": "no CUDA card: bench_gpu.py measures "
                         "shark_tpu_torch on the card and does not fall "
                         "back to the CPU"}), flush=True)
            return 1
        device = torch.device("cuda", 0)
    device = torch.device(device)
    chosen = set(WORKLOADS) if args.workload == "all" else {args.workload}
    if os.environ.get("BENCH_PRIMARY_ONLY", "") == "1":
        chosen &= {"panel"}
    if os.environ.get("BENCH_SKIP_TXOME", "") == "1":
        chosen.discard("txome")
    b = Bench(device, float(os.environ.get("BENCH_BUDGET_S", "2700")))
    b.out["device"] = card_name() if device.type == "cuda" else "cpu"
    b.out["workloads"] = [w for w in WORKLOADS if w in chosen]

    def on_term(signum, frame):
        log(f"caught signal {signum}; printing the partial line")
        print(json.dumps(b.out), flush=True)
        os._exit(1)

    old_term = signal.signal(signal.SIGTERM, on_term)
    try:
        run_workloads(b, chosen)
    except Exception as e:  # noqa: BLE001 - the line is still printed
        traceback.print_exc()
        b.fail(f"run: failed: {e!r}")
    finally:
        signal.signal(signal.SIGTERM, old_term)
        b.release()
    out = b.out
    for wl in WORKLOADS:
        sp = b.spread(wl)
        if sp is not None:
            out["baseline_spread" if wl == "panel"
                else f"{wl}_baseline_spread"] = sp
    for wl, ok in b.exact.items():
        out[f"{wl}_exact"] = ok
    out["stage_s"] = b.stage_s
    out["total_s"] = round(time.time() - b.t_start, 1)
    out["cache_gb"] = cache_gb()
    del out["error"]
    if b.failures:
        out["failures"] = b.failures[:20]
    print(json.dumps(out), flush=True)
    return 1 if b.failures else 0


def run_workloads(b: Bench, chosen) -> None:
    def guarded(wl: str, fn, *a) -> None:
        """A workload that raises is a failed one: its keys stay out, its
        <wl>_exact is false, and the run goes on to the next."""
        try:
            fn(*a)
        except Exception as e:  # noqa: BLE001 - reported on the line
            traceback.print_exc()
            b.check(wl, False, f"{wl}: failed: {e!r}")

    main_wls = [w for w in ("panel", "paired", "q10") if w in chosen]
    m = None
    if main_wls:
        with b.stage("generate_main"):
            m = Main(b)
    if "panel" in main_wls:
        guarded("panel", m.visit, "panel")
        if "panel" in m.best:
            guarded("native_cpu", m.native_cpu)
    for wl in ("paired", "q10"):
        if wl in main_wls and not b.over_budget(f"{wl} workload"):
            guarded(wl, m.visit, wl)
    if "homolog" in chosen and not b.over_budget("homolog workload"):
        guarded("homolog", homolog, b)
    if "txome" in chosen and not b.over_budget("txome workload"):
        b.release()  # the txome's tables need the room
        guarded("txome", txome, b)
        b.release()
    # the second visit (bench.py:661-721), each on the panel's index and
    # probe tables loaded back from disk, the comparator too; the better
    # window counts on both sides
    for wl in main_wls:
        if wl in m.best and not b.over_budget(f"{wl} re-visit"):
            guarded(wl, m.visit, wl, True)
    if m is not None and "panel" in m.base:
        b.out["baseline_reads_per_sec"] = round(
            m.base["panel"]["reads_per_sec"], 1)
    if m is not None and m.ceiling:
        b.out["gather_ceiling_rows_s"] = round(m.ceiling, 0)
        b.out["gather_ceiling_measured"] = True
        b.out["gather_ceiling_ms"] = m.ceiling_ms
        b.out["gather_ceiling_bare_ms"] = m.ceiling_bare_ms
        b.out["gather_ceiling_by"] = m.ceiling_by


def cache_gb() -> float:
    """What the run keeps under CACHE, in GB."""
    n = 0
    for dirpath, _, files in os.walk(CACHE):
        for f in files:
            n += os.path.getsize(os.path.join(dirpath, f))
    return round(n / 1e9, 2)


if __name__ == "__main__":
    sys.exit(main())
