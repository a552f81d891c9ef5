#!/usr/bin/env python3
"""Smoke test of shark_tpu_torch on one CUDA card (written for an H100).

Run from the root of a checkout, on a machine with one card:

    python3 chip_smoke.py [--out DIR] [--quick]

Phases, each printing its lines; any failure exits non-zero:

1. card: the card's name and power limit (nvidia-smi);
2. build: nvcc for the four CUDA kernels (csrc/*.cu, one nvcc each, all
   started together) and g++ for the C++ host engine, timed;
3. kernels: each kernel against its plain PyTorch version on the card, on
   the same inputs, at the main path's shapes (B = 8192 and 65536 reads,
   L = 104 single-end and 208 paired): exact equality (integer code,
   zero tolerance), kernel and plain times (CUDA events, median of 7),
   the time of one PyTorch library call computing the same function
   where there is one, and the card's lower bound for the work;
4. end to end through the CLI entry point (shark_tpu_torch.cli.main, what
   `python -m shark_tpu_torch` runs) with the default flags
   -k 17 -c 0.6 -b 1, on workloads made with numpy from a seed at
   bench.py's shapes: (a) a 500-gene x 1500 bp panel with 500k single-end
   100 bp reads, (b) the homolog panel (62 families x 8 genes sharing a
   300 bp core) with 100k reads, (c) the panel with 50k read pairs. Each
   run's ssv and FASTQ bytes must equal a --backend cpu run of the port
   on its first 20k reads, and 2000 reads must agree with the port's
   oracle. Every kernel's launch counter, zeroed before (a), must be
   positive after (c).

The last lines are the kernels' JSON record, the nvidia-smi line, and
{"ok": true, "device": {...}}. --quick stops after phase 3 at one shape
(a first check of new kernels), and prints no result line. --out DIR also
writes the kernels' record and the end-to-end stats there.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

K, C, BF_GB = 17, 0.6, 1
READ_LEN = 100
N_PANEL_READS, N_HOMOLOG_READS, N_PAIRS = 500_000, 100_000, 50_000
N_CPU_CHECK, N_ORACLE_CHECK = 20_000, 2_000
SHAPES = [(8192, 104), (8192, 208), (65536, 104), (65536, 208)]
RECORD_SHAPE = (65536, 104)  # bench.py's batch: the shape the record holds
REPS = 7

# Published H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s of HBM. For the
# integer work of these kernels: 132 SMs x 64 INT32 lanes x 1.98 GHz.
PEAK_BYTES_S = 3.35e12
PEAK_INT_OPS_S = 132 * 64 * 1.98e9

KERNEL_INFO = {
    "front": ("front_end", "shark_tpu_torch/csrc/front.cu",
              "shark_tpu/classify/step.py:635"),
    "probe": ("probe_hashed", "shark_tpu_torch/csrc/probe.cu",
              "shark_tpu/classify/hashed.py:542"),
    "finish": ("finish_from_tags", "shark_tpu_torch/csrc/finish.cu",
               "shark_tpu/classify/step.py:869"),
    "pairs": ("extract_pairs", "shark_tpu_torch/csrc/pairs.cu",
              "shark_tpu/classify/step.py:378"),
}


class SmokeFailure(Exception):
    pass


def need(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# workloads (numpy, from seeds; bench.py's and bench/homolog_bench.py's
# shapes)
# ---------------------------------------------------------------------------

ACGT = np.frombuffer(b"ACGT", np.uint8)
ERR_BASES = np.frombuffer(b"ACGTN", np.uint8)
COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    COMP[_a] = _b


def panel_genes(rng, n_genes=500, length=1500):
    return [ACGT[rng.integers(0, 4, size=length)] for _ in range(n_genes)]


def homolog_genes(rng, n_genes=500, length=1500, core=300):
    """62 families of 8 genes (and a last family of 4) sharing a core."""
    start = (length - core) // 2
    genes = []
    for g in range(n_genes):
        if g % 8 == 0:
            shared = ACGT[rng.integers(0, 4, size=core)]
        genes.append(np.concatenate([
            ACGT[rng.integers(0, 4, size=start)], shared,
            ACGT[rng.integers(0, 4, size=length - start - core)],
        ]))
    return genes


def mutate(rng, reads):
    """2% substitution errors, some of them N (bench.py read_from)."""
    mut = rng.random(reads.shape) < 0.02
    reads[mut] = ERR_BASES[rng.integers(0, 5, size=int(mut.sum()))]
    return reads


def cut_reads(rng, genes, gidx, starts):
    return mutate(rng, np.stack([genes[g][s:s + READ_LEN]
                                 for g, s in zip(gidx, starts)]))


def panel_reads(rng, genes, n):
    gidx = rng.integers(0, len(genes), size=n)
    starts = rng.integers(0, len(genes[0]) - READ_LEN, size=n)
    return cut_reads(rng, genes, gidx, starts)


def homolog_reads(rng, genes, n, length=1500, core=300):
    """Even reads inside a family core (ties across the family), odd
    reads in a member's own flank (bench/homolog_bench.py)."""
    start = (length - core) // 2
    gidx = rng.integers(0, len(genes), size=n)
    core_starts = rng.integers(start, start + core - READ_LEN, size=n)
    flank_starts = rng.integers(0, start - READ_LEN, size=n)
    starts = np.where(np.arange(n) % 2 == 0, core_starts, flank_starts)
    return cut_reads(rng, genes, gidx, starts)


def pair_reads(rng, genes, n):
    """Innie pairs: mate 2 is the reverse complement 180 bp downstream."""
    gidx = rng.integers(0, len(genes), size=n)
    s1 = rng.integers(0, len(genes[0]) - READ_LEN - 220, size=n)
    m1 = cut_reads(rng, genes, gidx, s1)
    m2 = cut_reads(rng, genes, gidx, s1 + 180)
    return m1, COMP[m2[:, ::-1]]


def write_fasta(path, genes, prefix):
    with open(path, "wb") as f:
        for g, seq in enumerate(genes):
            f.write(b">%s%05d\n%s\n" % (prefix, g, seq.tobytes()))


def write_fastq(path, reads, prefix: bytes):
    """Fixed-width records @<prefix><7 digits>, quality 'I' throughout."""
    n, rl = reads.shape
    head = np.frombuffer(
        b"".join(b"@%s%07d\n" % (prefix, i) for i in range(n)), np.uint8
    ).reshape(n, -1)
    rec = np.concatenate([
        head, reads, np.full((n, 1), ord("\n"), np.uint8),
        np.frombuffer(b"+\n", np.uint8)[None, :].repeat(n, 0),
        np.full((n, rl), ord("I"), np.uint8),
        np.full((n, 1), ord("\n"), np.uint8),
    ], axis=1)
    with open(path, "wb") as f:
        f.write(rec.tobytes())


def codes_for_shape(rng, genes, B, L):
    """Byte codes [B, L] of homolog reads: single 100 bp reads at L = 104,
    fused pairs (mate 1, N, mate 2) at L = 208; invalid padding."""
    from shark_tpu_torch.ops.kmers import BYTE_TO_CODE

    codes = np.full((B, L), 4, np.uint8)
    if L >= 2 * READ_LEN + 1:
        m1, m2 = pair_reads(rng, genes, B)
        codes[:, :READ_LEN] = BYTE_TO_CODE[m1]
        codes[:, READ_LEN + 1:2 * READ_LEN + 1] = BYTE_TO_CODE[m2]
    else:
        codes[:, :READ_LEN] = BYTE_TO_CODE[homolog_reads(rng, genes, B)]
    return codes


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


class Timer:
    """Median of REPS runs of fn(), each timed with CUDA events after a
    warm-up, with the 50 MB L2 flushed before every run."""

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        fn()
        times = []
        for _ in range(REPS):
            self.flush.fill_(1)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def bound(nbytes: float, ops: float):
    """(bound ms, what bounds it, bytes ms, operations ms)."""
    tb = nbytes / PEAK_BYTES_S * 1e3
    to = ops / PEAK_INT_OPS_S * 1e3
    return (tb, "bytes", tb, to) if tb >= to else (to, "operations", tb, to)


def same(name, got, want):
    """Exact equality of integer outputs; returns max |got - want| (0)."""
    err = 0
    for i, (g, w) in enumerate(zip(got, want)):
        need(g.shape == w.shape and g.dtype == w.dtype,
             f"{name}[{i}]: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        e = int(d.max()) if d.numel() else 0
        err = max(err, e)
        need(e == 0, f"{name}[{i}] differs from its plain version "
                     f"({int((d != 0).sum())} elements, max |err| {e})")
    return err


def pair_cap(packed, B, W):
    """The pipeline's quantized capacity for this batch's pair stream."""
    p = packed.to(torch.int64)
    nw = (p >> 16) & 31
    need_ = ((p >> 21) & 1).bool() & (nw >= 1) & (nw <= W) & (nw < 31) \
        & ~((p >> 22) & 1).bool() & ~((p >> 23) & 1).bool()
    total = int(nw[need_].sum())
    return next((min(lv, B * W) for lv in (1 << 14, 1 << 17, 1 << 19)
                 if min(lv, B * W) >= total + 2), B * W), total


def check_kernels(clf, genes, shapes, record_shape, timer):
    """Phase 3. Returns the per-kernel record at record_shape."""
    from shark_tpu_torch.classify import hashed, step

    dix, hmeta = clf.dix, clf._hmeta
    dev = clf.device
    rng = np.random.default_rng(2024)
    W = clf.max_winners
    record = {}
    for B, L in shapes:
        meta, thresh = clf._geometry(L)
        codes = torch.from_numpy(codes_for_shape(rng, genes, B, L)).to(dev)
        packed, vmask = step.pack_codes(codes)
        Ls = L - (K - 1)
        n = B * Ls
        rows = {}

        # K1 -------------------------------------------------------------
        k1 = step.front_end(packed, vmask, meta)
        e1 = same("front_end", k1, step.front_end_plain(packed, vmask, meta))
        nbytes = packed.numel() + vmask.numel() + n * 9 + B * 4
        rows["front"] = dict(
            err=e1,
            ms=timer(lambda: step.front_end(packed, vmask, meta)),
            plain_ms=timer(lambda: step.front_end_plain(packed, vmask, meta)),
            library_ms=None,
            bound=bound(nbytes, n * 50),
        )
        idx_hi, idx_lo, win_valid, length = k1

        # K2 -------------------------------------------------------------
        args2 = (idx_hi, idx_lo, win_valid, dix.table, dix.stash, hmeta)
        k2 = hashed.probe_hashed(*args2)
        e2 = same("probe_hashed", k2, hashed.probe_hashed_plain(*args2))
        mask = (1 << hmeta.lgB) - 1
        bucket = idx_lo.view(torch.int32).to(torch.int64) & mask
        row_bytes = dix.table[0].numel() * 4
        touched = int(torch.unique(bucket[win_valid]).numel())
        nbytes = n * 9 + touched * row_bytes + dix.stash.numel() * 4 + n * 8
        tbl = dix.table.view(torch.int32).reshape(dix.table.shape[0], -1)
        rows["probe"] = dict(
            err=e2,
            ms=timer(lambda: hashed.probe_hashed(*args2)),
            plain_ms=timer(lambda: hashed.probe_hashed_plain(*args2)),
            library_ms=timer(lambda: tbl[bucket]),
            bound=bound(nbytes, n * (4 * tbl.shape[1] + 10)),
        )
        tagv, payv = k2

        # K3 -------------------------------------------------------------
        kw3 = dict(rows3=dix.rows3, ext_mat=dix.ext_mat, meta=meta,
                   max_winners=W, L=L, has_rows=hmeta.has_rows)
        args3 = (tagv, payv, length, thresh)
        k3 = step.finish_from_tags(*args3, **kw3)
        e3 = same("finish_from_tags", k3[:3],
                  step.finish_from_tags_plain(*args3, **kw3)[:3])
        t = tagv.to(torch.int64)
        nk = ((t == 1) | (t == 2)).sum(1) + (t == 2).sum(1)
        if hmeta.has_rows:
            rb = meta.rows_bits
            p64 = payv.to(torch.int64)
            ridx = (p64 & ((1 << rb) - 1)) if rb else p64
            is_row = t == 3
            deg = dix.rows3.to(torch.int64)[ridx[is_row], 0] & 0xFFFF
            nk = nk.clone()
            nk.index_add_(
                0, is_row.nonzero()[:, 0],
                torch.clamp(deg, max=meta.degree3))
            touched_rows = int(torch.unique(ridx[is_row]).numel())
        else:
            touched_rows = 0
        nkf = nk.to(torch.float64)
        ops = float((nkf * torch.log2(torch.clamp(nkf, min=2)) + 10 * nkf).sum())
        nbytes = (n * 8 + B * 4 + thresh.numel() * 4
                  + touched_rows * dix.rows3.shape[1] * 4 + B * (8 + 4 * W))
        rows["finish"] = dict(
            err=e3,
            ms=timer(lambda: step.finish_from_tags(*args3, **kw3)),
            plain_ms=timer(lambda: step.finish_from_tags_plain(*args3, **kw3)),
            library_ms=None,
            bound=bound(nbytes, ops),
        )
        grp = int(((k3[0] >> 23) & 1).sum())

        # K4 -------------------------------------------------------------
        cap, total = pair_cap(k3[0], B, W)
        k4 = step.extract_pairs(k3[0], k3[1], cap)
        e4 = same("extract_pairs", [k4],
                  [step.extract_pairs_plain(k3[0], k3[1], cap)])
        p = k3[0].to(torch.int64)
        nw = (p >> 16) & 31
        valid = (torch.arange(W, device=dev)[None, :] < nw[:, None]) \
            & ((p >> 21) & 1).bool()[:, None]
        keys = torch.where(
            valid,
            (torch.arange(B, device=dev)[:, None] << 16)
            | k3[1].to(torch.int64),
            torch.full((B, W), 0xFFFFFFFF, dtype=torch.int64, device=dev),
        ).reshape(-1)
        rows["pairs"] = dict(
            err=e4,
            ms=timer(lambda: step.extract_pairs(k3[0], k3[1], cap)),
            plain_ms=timer(lambda: step.extract_pairs_plain(k3[0], k3[1], cap)),
            library_ms=timer(lambda: torch.sort(keys)),
            bound=bound(B * 4 + B * W * 4 + min(cap, B * W) * 4, B * W * 3),
        )
        for name, r in rows.items():
            lib = ("-" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
            say(f"kernel {KERNEL_INFO[name][0]:<17} B={B:<6} L={L:<4} "
                f"exact (max|err| {r['err']})  kernel_ms={r['ms']:.4f}  "
                f"plain_ms={r['plain_ms']:.4f}  library_ms={lib}  "
                f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]}; bytes "
                f"{r['bound'][2]:.4f}, operations {r['bound'][3]:.4f})")
        say(f"kernel batch B={B} L={L}: group verdicts {grp}, "
            f"winner pairs {total} (cap {cap})")
        if (B, L) == record_shape:
            record = rows
    return record


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


def parse_ssv(path, n_first):
    """{read index: [gene names]} for reads below n_first, and the byte
    length of that prefix of the ssv."""
    out = {}
    size = 0
    with open(path, "rb") as f:
        for line in f:
            rid, gene = line.split()
            i = int(rid[1:])
            if i >= n_first:
                break
            out.setdefault(i, []).append(gene.decode())
            size += len(line)
    return out, size


def fastq_prefix(path, n_first):
    """Bytes of the leading records whose read index is below n_first."""
    size = 0
    with open(path, "rb") as f:
        while True:
            rec = [f.readline() for _ in range(4)]
            if not rec[0] or int(rec[0][2:]) >= n_first:
                break
            size += sum(map(len, rec))
    with open(path, "rb") as f:
        return f.read(size)


def run_cli(argv):
    from shark_tpu_torch import cli

    rc = cli.main(argv)
    need(rc == 0, f"shark_tpu_torch {' '.join(argv)} exited {rc}")


def e2e(work, name, genes, prefix, reads1, reads2=None):
    """One end-to-end phase: GPU run, --backend cpu run on the first
    N_CPU_CHECK reads, oracle agreement on the first N_ORACLE_CHECK."""
    from shark_tpu_torch.classify.oracle import (
        build_oracle_index,
        classify_read,
        fuse_pair,
    )

    d = os.path.join(work, name)
    os.makedirs(d)
    fa = os.path.join(d, "genes.fa")
    write_fasta(fa, genes, prefix)
    rp = b"p" if reads2 is not None else b"r"
    files = {}
    for tag, sub in (("all", None), ("head", N_CPU_CHECK)):
        for mate, reads in (("1", reads1), ("2", reads2)):
            if reads is None:
                continue
            path = os.path.join(d, f"{tag}_{mate}.fq")
            write_fastq(path, reads if sub is None else reads[:sub], rp)
            files[tag, mate] = path

    def argv(tag, backend):
        a = ["-r", fa, "-1", files[tag, "1"],
             "-o", os.path.join(d, f"{tag}_{backend}.1.fq"),
             "--ssv", os.path.join(d, f"{tag}_{backend}.ssv"),
             "-k", str(K), "-c", str(C), "-b", str(BF_GB),
             "--stats-json", os.path.join(d, f"{tag}_{backend}.json")]
        if reads2 is not None:
            a += ["-2", files[tag, "2"],
                  "-p", os.path.join(d, f"{tag}_{backend}.2.fq")]
        if backend == "cpu":
            a += ["--backend", "cpu"]
        return a

    t0 = time.perf_counter()
    run_cli(argv("all", "gpu"))
    wall = time.perf_counter() - t0
    with open(os.path.join(d, "all_gpu.json")) as f:
        stats = json.load(f)
    need(stats["n_reads"] == len(reads1), f"{name}: read count {stats}")
    need(stats["probe"] == "hashed", f"{name}: probe {stats['probe']}")
    run_cli(argv("head", "cpu"))
    gpu_ssv = os.path.join(d, "all_gpu.ssv")
    got, size = parse_ssv(gpu_ssv, N_CPU_CHECK)
    with open(gpu_ssv, "rb") as f:
        gpu_head = f.read(size)
    with open(os.path.join(d, "head_cpu.ssv"), "rb") as f:
        need(gpu_head == f.read(), f"{name}: GPU ssv != --backend cpu ssv")
    for mate in ("1", "2") if reads2 is not None else ("1",):
        with open(os.path.join(d, f"head_cpu.{mate}.fq"), "rb") as f:
            need(fastq_prefix(os.path.join(d, f"all_gpu.{mate}.fq"),
                              N_CPU_CHECK) == f.read(),
                 f"{name}: GPU FASTQ {mate} != --backend cpu FASTQ")
    need(len(got) > N_CPU_CHECK // 4, f"{name}: only {len(got)} reads emitted")

    oracle = build_oracle_index(
        [(f"{prefix.decode()}{g:05d}", s.tobytes()) for g, s in enumerate(genes)],
        K, BF_GB << 33)
    agree = 0
    for i in range(N_ORACLE_CHECK):
        r1 = (f"{i}", reads1[i].tobytes(), b"I" * READ_LEN)
        r2 = None if reads2 is None else (f"{i}", reads2[i].tobytes(),
                                          b"I" * READ_LEN)
        wins, _, _ = classify_read(oracle, fuse_pair(r1, r2, 0), C, False)
        want = [oracle.gene_names[g] for g in wins]
        need(got.get(i, []) == want,
             f"{name}: read {i}: GPU {got.get(i, [])} != oracle {want}")
        agree += 1
    rps = stats["n_reads"] / stats["classify_s"]
    say(f"e2e {name}: reads={stats['n_reads']} "
        f"associations={stats['n_associations']} "
        f"reads_out={stats['n_reads_out']} group_rows={stats['group_rows']} "
        f"classify_s={stats['classify_s']:.3f} reads_per_s={rps:.0f} "
        f"warmup_s={stats['warmup_s']:.2f} index_s={stats['index_s']:.2f} "
        f"wall_s={wall:.2f}; GPU == --backend cpu on {N_CPU_CHECK} reads "
        f"(ssv, FASTQ); {agree} reads agree with the oracle")
    stats["wall_s"] = wall
    return stats


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="",
                    help="also write the kernels' record and e2e stats here")
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels at one shape only")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(HERE, "shark_tpu_torch", "csrc")):
        raise SmokeFailure("run chip_smoke.py from a checkout of the repo "
                           "(shark_tpu_torch/ is not beside it)")
    sys.path.insert(0, HERE)
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke test runs on the card")
    from shark_tpu_torch import kernels
    from shark_tpu_torch.classify.step import Classifier
    from shark_tpu_torch.index.build import build_index
    from shark_tpu_torch.io import native

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"card: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s))")

    # 2. build: g++ in a thread while the nvcc processes run
    gpp = {}

    def build_native():
        try:
            gpp["s"] = native.rebuild()
        except RuntimeError as e:
            gpp["err"] = e

    th = threading.Thread(target=build_native)
    th.start()
    nvcc_s, log = kernels.build(ptxas_info=True, force=True)
    th.join()
    if "err" in gpp:
        raise SmokeFailure(str(gpp["err"]))
    kernels.lib()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    say(f"build: nvcc {nvcc_s:.1f} s (4 sources in parallel), g++ native "
        f"engine {gpp['s']:.1f} s")
    for ln in ptxas:
        say(f"  ptxas: {ln}")

    # 3. kernels, on the homolog panel's index (rows, groups, ties)
    rng = np.random.default_rng(7)
    hgenes = homolog_genes(rng)
    t0 = time.perf_counter()
    hindex = build_index(
        [(f"H{g:05d}", s.tobytes()) for g, s in enumerate(hgenes)],
        K, BF_GB << 33)
    clf = Classifier(hindex, max_winners=16, c=C)
    say(f"kernels: homolog index {hindex.n_set_bits} set bits, probe "
        f"{clf.probe} (entry16={clf._hmeta.entry16}, lgB={clf._hmeta.lgB}, "
        f"stash {clf.dix.stash.shape[0]}), rows3 {tuple(clf.dix.rows3.shape)}"
        f", built in {time.perf_counter() - t0:.1f} s")
    shapes = [(8192, 104)] if args.quick else SHAPES
    record = check_kernels(clf, hgenes, shapes,
                           shapes[0] if args.quick else RECORD_SHAPE, Timer())
    if args.quick:
        say(f"quick check done in {time.perf_counter() - t_start:.0f} s")
        return 3  # no result line: --quick is not the smoke test

    # 4. end to end through the CLI
    work = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        rng = np.random.default_rng(12345)
        pgenes = panel_genes(rng)
        e2e_stats = {}
        kernels.LAUNCHES.reset()
        e2e_stats["panel"] = e2e(work, "panel", pgenes, b"GENE",
                                 panel_reads(rng, pgenes, N_PANEL_READS))
        a = kernels.LAUNCHES.snapshot()
        e2e_stats["homolog"] = e2e(work, "homolog", hgenes, b"H",
                                   homolog_reads(rng, hgenes, N_HOMOLOG_READS))
        b = kernels.LAUNCHES.snapshot()
        e2e_stats["paired"] = e2e(work, "paired", pgenes, b"GENE",
                                  *pair_reads(rng, pgenes, N_PAIRS))
        launches = kernels.LAUNCHES.snapshot()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    need(e2e_stats["homolog"]["group_rows"] > 0, "homolog: no group verdicts")
    need(b["pairs"] > a["pairs"], "homolog: extract_pairs never launched")
    say(f"launches over (a)-(c): {json.dumps(launches)} "
        f"(after (a): {json.dumps(a)}, after (b): {json.dumps(b)})")
    for name, count in launches.items():
        need(count > 0, f"kernel {name} was not launched on the main path")

    kernels_line = {"kernels": []}
    for name, (fn, src, replaces) in KERNEL_INFO.items():
        r = record[name]
        kernels_line["kernels"].append({
            "name": fn, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
        })
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"card": smi, "kernels": kernels_line["kernels"],
                       "bounds_bytes_ops_ms": {
                           KERNEL_INFO[n][0]: record[n]["bound"][2:]
                           for n in KERNEL_INFO},
                       "record_shape": RECORD_SHAPE, "e2e": e2e_stats}, f,
                      indent=1)
    say(f"done in {time.perf_counter() - t_start:.0f} s")
    print(json.dumps(kernels_line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
