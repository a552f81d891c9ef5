#!/usr/bin/env python3
"""Smoke test of shark_tpu_torch on one CUDA card (written for an H100).

Run from the root of a checkout, on a machine with one card:

    python3 chip_smoke.py [--out DIR] [--quick]

Phases, each printing its lines; any failure exits non-zero:

1. card: the card's name and power limit (nvidia-smi);
2. build: nvcc for the eleven CUDA kernels (the nine csrc/*.cu, one nvcc
   each, all started together) and g++ for the C++ host engine, timed;
3. kernels: each kernel against its plain PyTorch version on the card, on
   the same inputs, at the main paths' shapes (B = 8192 and 65536 reads,
   L = 104 single-end and 208 paired): exact equality (integer code,
   zero tolerance), kernel and plain times (CUDA events, median of 7),
   the time of one PyTorch library call computing the same function
   where there is one, and the card's lower bound for the work. The
   front end, hashed probe, finish and pair stream run on the homolog
   panel's index; the xl and classic probes on a transcriptome index at
   bench/transcriptome_bench.py's widths (50,000 genes x 1500 bp, every
   80th gene starting a family of 8 that shares a 300 bp core), which
   takes the xl layout with a side table; and the sharded Bloom filter's
   routing kernels (route, owner probe, return) on that index split into
   8 shards on the one card, at the four shapes (B split 8 ways), at one
   shard, with the wide (64-bit word) router, with a routing cap so small
   that every source overflows, and the router alone at a > 2^36-bit
   filter on synthetic addresses (its owners against a numpy uint64
   oracle); the 8-shard classifier's verdicts on a 65536-read batch must
   equal the classic classifier's;
4. end to end through the CLI entry point (shark_tpu_torch.cli.main, what
   `python -m shark_tpu_torch` runs) with the default flags
   -k 17 -c 0.6 -b 1, on workloads made with numpy from a seed at
   bench.py's shapes: (a) a 500-gene x 1500 bp panel with 500k single-end
   100 bp reads, (b) the homolog panel (62 families x 8 genes sharing a
   300 bp core) with 100k reads, (c) the panel with 50k read pairs, (d)
   the transcriptome with 500k reads and --save-index (auto selection
   takes xl), (e) --probe classic --load-index on that index and the
   first 100k reads of (d), (f) --sharded-bf --load-index (one shard, the
   CLI on one card) on the same reads, (g) run_pipeline through the
   native engine with the index split into 8 shards on the card and a
   routing cap small enough that reprobe must fire, on the same reads.
   Runs (a)-(d) must write the bytes of a --backend cpu run of the port
   on their first 20k reads ((d)'s through --load-index, so through the
   xl probe-table cache), and 2000 reads of each must agree with the
   port's oracle; (e), (f) and (g) must write the prefix of (d)'s bytes.
   The launch counters are zeroed before each run and read after it:
   (a)-(c) launch the hashed path's kernels, (d) the xl path's, (e) the
   classic path's, (f) and (g) the sharded path's;
5. the port's counterparts of the two Pallas experiments, through their
   entry points at their default sizes (shark_tpu_torch.experiments:
   gather_tiles.main, 2^20 random 512-byte tiles of a 1 GiB table;
   resident_match.main, one 5,767,168-probe batch against a 16 MB table),
   each run with the counters zeroed before it and read after; then each
   kernel against its plain version on the same inputs at that size, and
   against its library form (table[idx] rows; the gather+match of the
   hashed probe), exact, with kernel, plain and library times and the
   bound. No classify run (a)-(g) may launch these two kernels.

The last lines are the kernels' JSON record, the nvidia-smi line, and
{"ok": true, "device": {...}}. --quick stops after phase 3 at one shape
(a first check of new kernels), and prints no result line. --out DIR also
writes the kernels' record and the end-to-end stats there.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import os
import shutil
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
N_TXOME_READS, N_CLASSIC_READS = 500_000, 100_000
TXOME_GENES = 50_000
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
    "probe_xl": ("probe_xl", "shark_tpu_torch/csrc/xl.cu",
                 "shark_tpu/classify/hashed.py:568"),
    "classic": ("probe_tags", "shark_tpu_torch/csrc/classic.cu",
                "shark_tpu/classify/step.py:687"),
    "shard_route": ("shard_route", "shark_tpu_torch/csrc/route.cu",
                    "shark_tpu/parallel/sharded_bf.py:138"),
    "shard_probe": ("shard_probe", "shark_tpu_torch/csrc/route.cu",
                    "shark_tpu/parallel/sharded_bf.py:245"),
    "shard_return": ("shard_return", "shark_tpu_torch/csrc/route.cu",
                     "shark_tpu/parallel/sharded_bf.py:256"),
    "gather_tiles": ("gather_tiles", "shark_tpu_torch/csrc/gather_tiles.cu",
                     "bench/pallas_probe.py:34"),
    "resident_match": ("resident_match",
                       "shark_tpu_torch/csrc/resident_match.cu",
                       "bench/pallas_vmem_match.py:55"),
}
# the kernels each run must launch; a run launches no probe, routing or
# experiment kernel of another path
PATH_KERNELS = {
    "hashed": ("front", "probe", "finish", "pairs"),
    "xl": ("front", "probe_xl", "finish"),
    "classic": ("front", "classic", "finish"),
    "sharded": ("front", "shard_route", "shard_probe", "shard_return",
                "finish"),
    "gather_tiles": ("gather_tiles",),
    "resident_match": ("resident_match",),
}
PATH_ONLY = ("probe", "probe_xl", "classic", "shard_route", "shard_probe",
             "shard_return", "gather_tiles", "resident_match")
SHARDS = 8


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


def txome_genes(rng, n_genes=TXOME_GENES, length=1500, core=300, every=80,
                members=8):
    """bench/transcriptome_bench.py's genes: every `every`-th gene starts a
    family of `members` that share a `core` bp middle; uint8[n, length]."""
    genes = ACGT[rng.integers(0, 4, size=(n_genes, length), dtype=np.uint8)]
    fam = np.flatnonzero(np.arange(n_genes) % every < members)
    cores = ACGT[rng.integers(0, 4, size=(n_genes // every + 1, core),
                              dtype=np.uint8)]
    start = (length - core) // 2
    genes[fam, start:start + core] = cores[fam // every]
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


def codes_for_shape(rng, genes, B, L, single=homolog_reads):
    """Byte codes [B, L]: single 100 bp reads (`single`, homolog reads by
    default) at L = 104, fused pairs (mate 1, N, mate 2) at L = 208;
    invalid padding."""
    from shark_tpu_torch.ops.kmers import BYTE_TO_CODE

    codes = np.full((B, L), 4, np.uint8)
    if L >= 2 * READ_LEN + 1:
        m1, m2 = pair_reads(rng, genes, B)
        codes[:, :READ_LEN] = BYTE_TO_CODE[m1]
        codes[:, READ_LEN + 1:2 * READ_LEN + 1] = BYTE_TO_CODE[m2]
    else:
        codes[:, :READ_LEN] = BYTE_TO_CODE[single(rng, genes, B)]
    return codes


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


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
        say_rows(rows, B, L)
        say(f"kernel batch B={B} L={L}: group verdicts {grp}, "
            f"winner pairs {total} (cap {cap})")
        if (B, L) == record_shape:
            record = rows
    return record


def say_rows(rows, B, L):
    for name, r in rows.items():
        say_row(name, r, f"B={B:<6} L={L:<4}")


def say_row(name, r, where):
    lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
    say(f"kernel {KERNEL_INFO[name][0]:<17} {where} "
        f"exact (max|err| {r['err']})  kernel_ms={r['ms']:.4f}  "
        f"plain_ms={r['plain_ms']:.4f}  library_ms={lib}  "
        f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]}; bytes "
        f"{r['bound'][2]:.4f}, operations {r['bound'][3]:.4f})")


def xl_geometry(clf):
    """The xl layout's geometry: lgB, side_lgB, side-stash rows and the
    share of buckets flagged as overflowed."""
    from shark_tpu_torch.classify.hashed import XL_FLAG_BIT

    h = clf._hmeta
    w0 = clf.dix.table[:, 0].view(torch.int32)
    flagged = int(((w0 >> XL_FLAG_BIT) & 1).sum())
    stash = clf.dix.side_stash.view(torch.int32)
    return dict(lgB=h.lgB, side_lgB=h.side_lgB, has_side=h.has_side,
                side_stash_rows=int((stash[:, 1] != -1).sum()),
                flagged_share=flagged / clf.dix.table.shape[0])


def check_txome_kernels(xclf, cclf, genes, shapes, record_shape, timer):
    """Phase 3 on the transcriptome index: K6 (xl, through xclf's tables)
    and K5 (classic, through cclf's) on the same windows. Returns their
    record at record_shape."""
    from shark_tpu_torch.classify import hashed, step

    xdix, hmeta = xclf.dix, xclf._hmeta
    cdix = cclf.dix
    dev = xclf.device
    rng = np.random.default_rng(2025)
    record = {}
    for B, L in shapes:
        meta, _ = xclf._geometry(L)
        codes = torch.from_numpy(
            codes_for_shape(rng, genes, B, L, single=panel_reads)).to(dev)
        idx_hi, idx_lo, win_valid, _ = step.front_end(
            *step.pack_codes(codes), meta)
        n = idx_lo.numel()
        lo = idx_lo.to(torch.int64)
        hi = idx_hi.to(torch.int64)
        rows = {}

        # K6 -------------------------------------------------------------
        args6 = (idx_hi, idx_lo, win_valid, xdix.table, xdix.side,
                 xdix.side_stash, hmeta)
        k6 = hashed.probe_xl(*args6)
        e6 = same("probe_xl", k6, hashed.probe_xl_plain(*args6))
        bucket = lo & ((1 << hmeta.lgB) - 1)
        tbl = xdix.table.view(torch.int32)
        flagged = ((tbl[bucket, 0] >> hashed.XL_FLAG_BIT) & 1) == 1
        no_side = dataclasses.replace(hmeta, has_side=False)
        tag0, _ = hashed.probe_xl_plain(*args6[:-1], no_side)
        need_side = win_valid & flagged & (tag0 == 0)
        n_side = int(need_side.sum())
        touched = int(torch.unique(bucket[win_valid]).numel())
        side_b = lo[need_side] & ((1 << hmeta.side_lgB) - 1)
        side_touched = int(torch.unique(side_b).numel())
        S = xdix.side_stash.shape[0]
        nbytes = (n * 9 + touched * 16 + side_touched * 64
                  + (S * 16 if n_side else 0) + n * 8)
        rows["probe_xl"] = dict(
            err=e6,
            ms=timer(lambda: hashed.probe_xl(*args6)),
            plain_ms=timer(lambda: hashed.probe_xl_plain(*args6)),
            library_ms=timer(lambda: tbl[bucket]),
            bound=bound(nbytes, n * (4 * 4 + 10) + n_side * (4 * 8 + 4 * S
                                                               + 10)),
        )

        # K5 -------------------------------------------------------------
        args5 = (idx_hi, idx_lo, win_valid, cdix.bf_rank, cdix.pay)
        k5 = step.probe_tags(*args5)
        e5 = same("probe_tags", k5, step.probe_tags_plain(*args5))
        word = (hi << 27) | (lo >> 5)
        rank, hit = step.probe_rank_plain(cdix.bf_rank, word, lo & 31,
                                          win_valid)
        touched_words = int(torch.unique(word[win_valid]).numel())
        hit_ranks = int(torch.unique(rank[hit]).numel())
        nbytes = n * 9 + touched_words * 8 + hit_ranks * 8 + n * 8
        bfr = cdix.bf_rank.view(torch.int32)
        payr = cdix.pay.view(torch.int32)
        rows["classic"] = dict(
            err=e5,
            ms=timer(lambda: step.probe_tags(*args5)),
            plain_ms=timer(lambda: step.probe_tags_plain(*args5)),
            library_ms=timer(lambda: (bfr[word], payr[rank])),
            bound=bound(nbytes, n * 12),
        )
        say_rows(rows, B, L)
        say(f"kernel batch B={B} L={L} (transcriptome): windows {n}, "
            f"side windows {n_side} ({n_side / n:.4%}), touched xl buckets "
            f"{touched}, bf_rank words {touched_words}, hit ranks "
            f"{hit_ranks}")
        if (B, L) == record_shape:
            record = rows
    return record


def _transposed(buf):
    """The exchange of shards that share the card: [src, dst] -> [dst,
    src]."""
    return buf.view(torch.int32).transpose(0, 1).contiguous().view(
        torch.uint32)


def route_rows(windows, dix, n, wps, wide, cap, timer):
    """K7a, K7b and K7c on [n, b, Ls] windows against the shard tables
    `dix`, each against its plain version (exact), timed beside its plain
    version and one PyTorch library call, with its bound. Returns (rows,
    routing counts)."""
    from shark_tpu_torch.classify import step
    from shark_tpu_torch.parallel import sharded_bf as sb

    hi, lo, valid = windows
    S, b, Ls = lo.shape
    dev = lo.device
    nw = lo.numel()
    route = dict(n=n, wps=wps, wide=wide, cap=cap)
    rows = {}

    # K7a ------------------------------------------------------------------
    k7a = sb.shard_route(hi, lo, valid, **route)
    ea = same("shard_route", k7a, sb.shard_route_plain(hi, lo, valid, **route))
    send, slot, owner, ovf = k7a
    Pn = b * Ls
    pos = torch.arange(Pn, device=dev, dtype=torch.int64)
    o64 = owner.reshape(S, Pn).to(torch.int64)
    keys = torch.where(o64 >= 0, o64 * Pn + pos, n * Pn)
    rows["shard_route"] = dict(
        err=ea,
        ms=timer(lambda: sb.shard_route(hi, lo, valid, **route)),
        plain_ms=timer(lambda: sb.shard_route_plain(hi, lo, valid, **route)),
        library_ms=timer(lambda: torch.sort(keys, dim=1)),
        bound=bound(nw * 9 + send.numel() * 4 + nw * 8 + S * 4,
                    nw * (30 + (n if wide else 0))),
    )

    # K7b ------------------------------------------------------------------
    recv = _transposed(send)
    k7b = sb.shard_probe(recv, dix.bf_rank, dix.pay)
    eb = same("shard_probe", [k7b],
              [sb.shard_probe_plain(recv, dix.bf_rank, dix.pay)])
    q = recv.to(torch.int64)
    routed = q[..., 0] < wps
    h = torch.arange(recv.shape[0], device=dev).view(-1, 1, 1).expand_as(
        routed)
    widx = (h * wps + q[..., 0])[routed]
    wr = dix.bf_rank.view(torch.int32).reshape(-1, 2)[widx].to(
        torch.int64) & 0xFFFFFFFF
    bit = q[..., 1][routed] & 31
    hit = ((wr[:, 0] >> bit) & 1) == 1
    low = wr[:, 0] & ((torch.ones_like(bit) << bit) - 1)
    rows_max = dix.pay.shape[1]
    ridx = (h[routed] * rows_max + wr[:, 1] + step._popcount32(low))[hit]
    bfr = dix.bf_rank.view(torch.int32).reshape(-1, 2)
    payr = dix.pay.view(torch.int32).reshape(-1, 2)
    n_slots = recv.numel() // 2
    rows["shard_probe"] = dict(
        err=eb,
        ms=timer(lambda: sb.shard_probe(recv, dix.bf_rank, dix.pay)),
        plain_ms=timer(lambda: sb.shard_probe_plain(recv, dix.bf_rank,
                                                    dix.pay)),
        library_ms=timer(lambda: (bfr[widx], payr[ridx])),
        bound=bound(n_slots * 16 + int(torch.unique(widx).numel()) * 8
                    + int(torch.unique(ridx).numel()) * 8,
                    int(routed.sum()) * 12),
    )

    # K7c ------------------------------------------------------------------
    back = _transposed(k7b)
    k7c = sb.shard_return(back, owner, slot)
    ec = same("shard_return", k7c, sb.shard_return_plain(back, owner, slot))
    ok = slot >= 0
    src = torch.arange(S, device=dev).view(S, 1, 1).expand_as(slot)
    flat = ((src * n + owner.to(torch.int64)) * cap + slot)[ok]
    backr = back.view(torch.int32).reshape(-1, 2)
    n_routed = int(ok.sum())
    rows["shard_return"] = dict(
        err=ec,
        ms=timer(lambda: sb.shard_return(back, owner, slot)),
        plain_ms=timer(lambda: sb.shard_return_plain(back, owner, slot)),
        library_ms=timer(lambda: backr[flat]),
        bound=bound(nw * 8 + n_routed * 8 + nw * 8, nw * 6),
    )
    stats = dict(windows=nw, routed=n_routed, cap=cap,
                 overflow=[int(x) for x in ovf.cpu()],
                 slots=n_slots, hits=int(hit.sum()))
    return rows, stats


def check_sharded_kernels(tindex, cclf, genes, shapes, record_shape, timer):
    """Phase 3 on the transcriptome index split into SHARDS shards on the
    card: K7a-c at every shape, at one shard and with the wide router at
    the record shape, with overflow, the router alone at a > 2^36-bit
    filter, and the classifier's verdicts against cclf's. Returns the
    K7 record at record_shape."""
    from shark_tpu_torch.classify import step
    from shark_tpu_torch.parallel import sharded_bf as sb

    dev = cclf.device
    t0 = time.perf_counter()
    sclf = sb.ShardedBFClassifier(tindex, max_winners=16, c=C,
                                  devices=[dev] * SHARDS)
    dix = sclf.dix[dev]
    say(f"sharded: {SHARDS} shards on one card, {sclf.wps} words per shard, "
        f"pay rows per shard {dix.pay.shape[1]}, tables "
        f"{(dix.bf_rank.numel() + dix.pay.numel()) * 4 / 1e9:.2f} GB, built "
        f"in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(2028)
    record = {}

    def windows_of(B, L, n):
        meta = step.StaticMeta.for_index(tindex, L, allow_wide=True)
        codes = torch.from_numpy(
            codes_for_shape(rng, genes, B, L, single=panel_reads)).to(dev)
        hi, lo, valid, _ = step.front_end(*step.pack_codes(codes), meta)
        shp = (n, B // n, hi.shape[1])
        return codes, (hi.view(shp), lo.view(shp), valid.view(shp))

    def run(tag, B, L, n, tables, wide, cap):
        codes, wins = windows_of(B, L, n)
        rows, st = route_rows(wins, tables, n, tables.bf_rank.shape[1],
                              wide, cap, timer)
        say_rows(rows, B, L)
        say(f"kernel batch B={B} L={L} ({tag}): {json.dumps(st)}")
        return codes, rows, st

    for B, L in shapes:
        _, rows, st = run(f"{SHARDS} shards", B, L, SHARDS, dix, False,
                          sclf._probe_cap(B // SHARDS, L))
        need(sum(st["overflow"]) == 0, f"sharded B={B} L={L}: overflow")
        if (B, L) == record_shape:
            record = rows
    B, L = record_shape
    # the wide (64-bit word) router on the same tables
    run(f"{SHARDS} shards, wide", B, L, SHARDS, dix, True,
        sclf._probe_cap(B // SHARDS, L))
    # a cap so small that every source overflows: slot order and counts
    sclf.slack = 0.05
    cap = sclf._probe_cap(B // SHARDS, L)
    sclf.slack = None
    _, _, st = run(f"{SHARDS} shards, slack 0.05", B, L, SHARDS, dix, False,
                   cap)
    need(all(o > 0 for o in st["overflow"]), "slack 0.05: no overflow")

    # the 8-shard classifier's verdicts equal the classic classifier's
    codes, _ = windows_of(B, L, SHARDS)
    got = sclf(codes)
    need(int(got[4].sum()) == 0, "sharded classifier: routing overflow")
    same("sharded classifier vs classic", got[:4], cclf(codes))
    say(f"sharded classifier: verdicts of {B} reads equal the classic "
        "classifier's")
    cap_big = sclf._probe_cap(B // SHARDS, L)
    del sclf, dix
    gc.collect()
    torch.cuda.empty_cache()

    # one shard: the CLI's --sharded-bf on one card
    s1 = sb.ShardedBFClassifier(tindex, max_winners=16, c=C, devices=[dev])
    run("1 shard", B, L, 1, s1.dix[dev], False, s1._probe_cap(B, L))
    del s1
    gc.collect()
    torch.cuda.empty_cache()

    # the router alone at a > 2^36-bit filter on synthetic addresses
    n = SHARDS
    size_bits = (1 << 37) + (5 << 33)
    wps = size_bits // 32 // n
    Ls = L - (K - 1)
    arng = np.random.default_rng(11)
    addr = (arng.integers(0, 1 << 62, size=B * Ls, dtype=np.int64)
            .astype(np.uint64) % np.uint64(size_bits))
    edges = [(s * wps + d) * 32 + 7 for s in range(1, n) for d in (-1, 0, 1)]
    addr[:len(edges)] = edges
    shp = (n, B // n, Ls)
    hi = torch.from_numpy((addr >> np.uint64(32)).astype(np.uint32)).to(dev)
    lo = torch.from_numpy((addr & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    valid = torch.ones(shp, dtype=torch.bool, device=dev)
    route = dict(n=n, wps=wps, wide=True, cap=cap_big)
    wins = (hi.view(shp), lo.to(dev).view(shp), valid)
    k7a = sb.shard_route(*wins, **route)
    same("shard_route (> 2^36 bits)", k7a, sb.shard_route_plain(*wins,
                                                                **route))
    want = ((addr >> np.uint64(5)) // np.uint64(wps)).astype(np.int32)
    need(np.array_equal(k7a[2].cpu().numpy().reshape(-1), want),
         "shard_route (> 2^36 bits): owners differ from the uint64 oracle")
    need(int(k7a[3].sum()) == 0, "shard_route (> 2^36 bits): overflow")
    say(f"kernel shard_route at {size_bits} bits ({n} shards of {wps} "
        f"words, {len(edges)} boundary words): exact, owners equal the "
        "uint64 oracle")
    return record


def check_experiments(timer, launches):
    """Phase 5: each experiment's entry point at its default size, with
    its launches in launches[name]; then each kernel against its plain
    version and its library form at that size. Returns their record."""
    from shark_tpu_torch import kernels
    from shark_tpu_torch.experiments import gather_tiles as G
    from shark_tpu_torch.experiments import resident_match as R

    t_phase = time.perf_counter()
    for name, mod in (("gather_tiles", G), ("resident_match", R)):
        kernels.LAUNCHES.reset()
        t0 = time.perf_counter()
        need(mod.main([]) == 0, f"{name}: main() failed")
        launches[name] = (name, kernels.LAUNCHES.snapshot())
        say(f"experiment {name}: main() at its defaults in "
            f"{time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    record = {}

    # P1: 2^20 probes of a 1 GiB table
    table_h, _, idx_h = G.make_inputs(20, 27)
    table = torch.from_numpy(table_h).to(dev)
    idx = torch.from_numpy(idx_h).to(dev)
    del table_h, idx_h
    tiles = table.view(-1, G.TILE)
    got = G.gather_tiles(tiles, idx)
    err = same("gather_tiles", [got], [G.gather_tiles_plain(tiles, idx)])
    idx64 = idx.to(torch.int64)
    t32 = table.view(torch.int32)
    same("gather_tiles rows vs table[idx]", [G.rows_of_tiles(got, idx)],
         [t32[idx64].view(torch.uint32)])
    del got
    tile = idx64 >> 6
    tiles32 = tiles.view(torch.int32)
    n = idx.numel()
    touched = int(torch.unique(tile).numel())
    rows_ms = timer(lambda: t32[idx64])
    r = record["gather_tiles"] = dict(
        err=err,
        ms=timer(lambda: G.gather_tiles(tiles, idx)),
        plain_ms=timer(lambda: G.gather_tiles_plain(tiles, idx)),
        library_ms=timer(lambda: tiles32[tile]),
        bound=bound(n * 4 + touched * 512 + n * 512, n * 4),
    )
    say_row("gather_tiles", r, f"n={n} rows=2^27")
    say(f"experiment gather_tiles: {touched} distinct tiles of "
        f"{tiles.shape[0]}; kernel {n / r['ms'] / 1e3:.1f} M tiles/s, "
        f"table[idx] 8-byte rows {rows_ms:.4f} ms "
        f"({n / rows_ms / 1e3:.1f} M rows/s)")
    del table, idx, idx64, t32, tile, tiles, tiles32
    gc.collect()
    torch.cuda.empty_cache()

    # P2: one production batch against a 16 MB table
    host = R.build_inputs(R.N_BATCH, R.LGB)
    table, bucket, rest, valid = (torch.from_numpy(a).to(dev) for a in host)
    rows, want, t128 = (torch.from_numpy(a).to(dev)
                        for a in R.probe_inputs(*host))
    del host
    got = R.resident_match(rows, want, t128)
    err = same("resident_match", [got],
               [R.resident_match_plain(rows, want, t128)])
    same("resident_match vs gather+match", [got],
         [R.match_gather(table, bucket, rest, valid)])
    hits = int((got[:, 0].view(torch.int32) != 0).sum())
    del got
    b64 = bucket.to(torch.int64)
    tbl = table.view(torch.int32)
    n = rows.numel()
    n_valid = int(valid.sum())
    touched = int(torch.unique(b64[valid]).numel())
    warm_ms = timer(lambda: R.resident_match(rows, want, t128), flush=False)
    gm_ms = timer(lambda: R.match_gather(table, bucket, rest, valid))
    sel_ms = timer(lambda: torch.index_select(tbl, 0, b64))
    r = record["resident_match"] = dict(
        err=err,
        ms=timer(lambda: R.resident_match(rows, want, t128)),
        plain_ms=timer(lambda: R.resident_match_plain(rows, want, t128)),
        library_ms=timer(lambda: tbl[b64]),
        bound=bound(n * 16 + touched * 32, n_valid * (4 * 8 + 10)),
    )
    say_row("resident_match", r, f"n={n} lgB={R.LGB}")
    say(f"experiment resident_match: {n_valid} valid probes, {hits} hits, "
        f"{touched} buckets of {table.shape[0]}; L2 flushed "
        f"{r['ms']:.4f} ms ({n / r['ms'] / 1e3:.1f} M probes/s), L2 warm "
        f"{warm_ms:.4f} ms ({n / warm_ms / 1e3:.1f} M probes/s); "
        f"match_gather {gm_ms:.4f} ms; the bucket rows by index_select "
        f"{sel_ms:.4f} ms")
    del table, bucket, rest, valid, rows, want, t128, b64, tbl
    gc.collect()
    torch.cuda.empty_cache()
    say(f"experiments: phase 5 in {time.perf_counter() - t_phase:.1f} s")
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


def write_workload(d, genes, prefix, reads1, reads2=None, fa=None,
                   subsets=(("head", N_CPU_CHECK),)):
    """The FASTA (unless given) and the FASTQ files of one workload: all
    reads, and the first n of each named subset. Returns (fa, files)."""
    os.makedirs(d, exist_ok=True)
    if fa is None:
        fa = os.path.join(d, "genes.fa")
        write_fasta(fa, genes, prefix)
    rp = b"p" if reads2 is not None else b"r"
    files = {}
    for tag, sub in (("all", None),) + tuple(subsets):
        for mate, reads in (("1", reads1), ("2", reads2)):
            if reads is None:
                continue
            path = os.path.join(d, f"{tag}_{mate}.fq")
            write_fastq(path, reads if sub is None else reads[:sub], rp)
            files[tag, mate] = path
    return fa, files


def run_tag(d, fa, files, tag, out, extra=()):
    """One CLI run on the `tag` reads, outputs named `out`; its stats."""
    a = ["-r", fa, "-1", files[tag, "1"],
         "-o", os.path.join(d, f"{out}.1.fq"),
         "--ssv", os.path.join(d, f"{out}.ssv"),
         "-k", str(K), "-c", str(C), "-b", str(BF_GB),
         "--stats-json", os.path.join(d, f"{out}.json"), *extra]
    if (tag, "2") in files:
        a += ["-2", files[tag, "2"], "-p", os.path.join(d, f"{out}.2.fq")]
    run_cli(a)
    with open(os.path.join(d, f"{out}.json")) as f:
        return json.load(f)


def same_prefix(d, name, run, ref, n_first, paired):
    """The ssv and FASTQ bytes of `run` on its reads below n_first equal
    the whole outputs of `ref`. Returns {read: genes} of that prefix."""
    got, size = parse_ssv(os.path.join(d, f"{run}.ssv"), n_first)
    with open(os.path.join(d, f"{run}.ssv"), "rb") as f:
        head = f.read(size)
    with open(os.path.join(d, f"{ref}.ssv"), "rb") as f:
        need(head == f.read(), f"{name}: {run} ssv != {ref} ssv")
    for mate in ("1", "2") if paired else ("1",):
        with open(os.path.join(d, f"{ref}.{mate}.fq"), "rb") as f:
            need(fastq_prefix(os.path.join(d, f"{run}.{mate}.fq"), n_first)
                 == f.read(), f"{name}: {run} FASTQ {mate} != {ref} FASTQ")
    return got


def oracle_agrees(name, oracle, got, reads1, reads2=None):
    """The first N_ORACLE_CHECK reads' genes equal the oracle's."""
    from shark_tpu_torch.classify.oracle import classify_read, fuse_pair

    for i in range(N_ORACLE_CHECK):
        r1 = (f"{i}", reads1[i].tobytes(), b"I" * READ_LEN)
        r2 = None if reads2 is None else (f"{i}", reads2[i].tobytes(),
                                          b"I" * READ_LEN)
        wins, _, _ = classify_read(oracle, fuse_pair(r1, r2, 0), C, False)
        want = [oracle.gene_names[g] for g in wins]
        need(got.get(i, []) == want,
             f"{name}: read {i}: GPU {got.get(i, [])} != oracle {want}")
    return N_ORACLE_CHECK


def say_e2e(name, stats, note):
    rps = stats["n_reads"] / stats["classify_s"]
    say(f"e2e {name}: probe={stats['probe']} reads={stats['n_reads']} "
        f"associations={stats['n_associations']} "
        f"reads_out={stats['n_reads_out']} group_rows={stats['group_rows']} "
        f"classify_s={stats['classify_s']:.3f} reads_per_s={rps:.0f} "
        f"warmup_s={stats['warmup_s']:.2f} index_s={stats['index_s']:.2f} "
        f"wall_s={stats['wall_s']:.2f}; {note}")


def e2e(work, name, genes, prefix, reads1, reads2=None):
    """One end-to-end phase on a panel: GPU run, --backend cpu run on the
    first N_CPU_CHECK reads, oracle agreement on the first
    N_ORACLE_CHECK."""
    from shark_tpu_torch.classify.oracle import build_oracle_index

    d = os.path.join(work, name)
    fa, files = write_workload(d, genes, prefix, reads1, reads2)
    t0 = time.perf_counter()
    stats = run_tag(d, fa, files, "all", "all_gpu")
    stats["wall_s"] = time.perf_counter() - t0
    need(stats["n_reads"] == len(reads1), f"{name}: read count {stats}")
    need(stats["probe"] == "hashed", f"{name}: probe {stats['probe']}")
    run_tag(d, fa, files, "head", "head_cpu", ["--backend", "cpu"])
    got = same_prefix(d, name, "all_gpu", "head_cpu", N_CPU_CHECK,
                      reads2 is not None)
    need(len(got) > N_CPU_CHECK // 4, f"{name}: only {len(got)} reads emitted")
    oracle = build_oracle_index(
        [(f"{prefix.decode()}{g:05d}", s.tobytes()) for g, s in enumerate(genes)],
        K, BF_GB << 33)
    agree = oracle_agrees(name, oracle, got, reads1, reads2)
    say_e2e(name, stats, f"GPU == --backend cpu on {N_CPU_CHECK} reads "
                         f"(ssv, FASTQ); {agree} reads agree with the oracle")
    return stats


def e2e_txome(d, fa, reads, launches):
    """(d) the transcriptome through the CLI's defaults (auto selection:
    xl) with --save-index, held against a --backend cpu --load-index run
    and the oracle; (e) --probe classic --load-index, (f) --sharded-bf
    --load-index and (g) run_pipeline with SHARDS shards on the card and an
    overflowing routing cap, each on the first N_CLASSIC_READS reads and
    held against (d)'s bytes. Each GPU run's launches go to
    launches[run] = (path, counts)."""
    from shark_tpu_torch import kernels
    from shark_tpu_torch.classify import table_cache
    from shark_tpu_torch.index.structure import SharkIndex
    from shark_tpu_torch.pipeline import _ShimIndex

    _, files = write_workload(
        d, None, None, reads, fa=fa,
        subsets=(("head", N_CPU_CHECK), ("classic", N_CLASSIC_READS)))
    idx = os.path.join(d, "index")
    out = {}
    kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    stats = run_tag(d, fa, files, "all", "all_gpu", ["--save-index", idx])
    stats["wall_s"] = time.perf_counter() - t0
    launches["d"] = ("xl", kernels.LAUNCHES.snapshot())
    need(stats["n_reads"] == len(reads), f"txome: read count {stats}")
    need(stats["probe"] == "xl", f"txome: probe {stats['probe']}")
    table_cache.join_pending()
    with open(idx + ".tables/meta.json") as f:
        cached = json.load(f)
    need(cached["kind"] == "xl", f"txome: cached table kind {cached['kind']}")
    stats["xl_hmeta"] = cached["hmeta"]
    cpu = run_tag(d, fa, files, "head", "head_cpu",
                  ["--backend", "cpu", "--load-index", idx])
    need(cpu["probe"] == "xl", f"txome --backend cpu: probe {cpu['probe']}")
    got = same_prefix(d, "txome", "all_gpu", "head_cpu", N_CPU_CHECK, False)
    need(len(got) > N_CPU_CHECK // 4, f"txome: only {len(got)} reads emitted")
    agree = oracle_agrees("txome", _ShimIndex(SharkIndex.load(idx)), got,
                          reads)
    say_e2e("txome", stats, f"xl tables {json.dumps(cached['hmeta'])}; GPU "
            f"== --backend cpu --load-index (xl table cache) on "
            f"{N_CPU_CHECK} reads (ssv, FASTQ); {agree} reads agree with "
            "the oracle")
    out["txome"] = stats
    gc.collect()

    kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    stats = run_tag(d, fa, files, "classic", "classic_gpu",
                    ["--probe", "classic", "--load-index", idx])
    stats["wall_s"] = time.perf_counter() - t0
    launches["e"] = ("classic", kernels.LAUNCHES.snapshot())
    need(stats["probe"] == "classic", f"classic: probe {stats['probe']}")
    need(stats["n_reads"] == N_CLASSIC_READS, f"classic: read count {stats}")
    same_prefix(d, "classic", "all_gpu", "classic_gpu", N_CLASSIC_READS,
                False)
    say_e2e("classic", stats, f"its bytes equal (d)'s on its "
                              f"{N_CLASSIC_READS} reads (ssv, FASTQ)")
    out["classic"] = stats
    gc.collect()

    kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    stats = run_tag(d, fa, files, "classic", "sharded_gpu",
                    ["--sharded-bf", "--load-index", idx])
    stats["wall_s"] = time.perf_counter() - t0
    launches["f"] = ("sharded", kernels.LAUNCHES.snapshot())
    need(stats["probe"] == "sharded", f"sharded: probe {stats['probe']}")
    need(stats["n_reads"] == N_CLASSIC_READS, f"sharded: read count {stats}")
    same_prefix(d, "sharded", "all_gpu", "sharded_gpu", N_CLASSIC_READS,
                False)
    say_e2e("sharded", stats, f"--sharded-bf, 1 shard; its bytes equal "
                              f"(d)'s on its {N_CLASSIC_READS} reads")
    out["sharded"] = stats
    gc.collect()
    torch.cuda.empty_cache()

    from shark_tpu_torch.config import SharkConfig
    from shark_tpu_torch.parallel.sharded_bf import ShardedBFClassifier
    from shark_tpu_torch.pipeline import run_pipeline

    t0 = time.perf_counter()
    clf = ShardedBFClassifier(
        SharkIndex.load(idx), max_winners=16, c=C,
        devices=[torch.device("cuda", 0)] * SHARDS, slack=0.05)
    build_s = time.perf_counter() - t0
    kernels.LAUNCHES.reset()
    cfg = SharkConfig(
        fasta_path=fa, sample1_path=files["classic", "1"],
        out1_path=os.path.join(d, "sharded8_gpu.1.fq"),
        ssv_path=os.path.join(d, "sharded8_gpu.ssv"), k=K, c=C, bf_gb=BF_GB)
    stats = run_pipeline(cfg, classifier=clf)
    stats["wall_s"] = time.perf_counter() - t0
    launches["g"] = ("sharded", kernels.LAUNCHES.snapshot())
    need(stats.get("native"), "sharded x8: not the native engine")
    need(stats["n_reads"] == N_CLASSIC_READS, f"sharded x8: read count {stats}")
    need(clf.cap_mult > 1, "sharded x8: reprobe never fired")
    same_prefix(d, "sharded x8", "all_gpu", "sharded8_gpu", N_CLASSIC_READS,
                False)
    stats["cap_mult"] = clf.cap_mult
    stats["classifier_build_s"] = build_s
    say_e2e("sharded8", stats, f"{SHARDS} shards on one card, slack 0.05 "
            f"(cap_mult grew to {clf.cap_mult:g}, classifier built in "
            f"{build_s:.1f} s); its bytes equal (d)'s on its "
            f"{N_CLASSIC_READS} reads")
    out["sharded8"] = stats
    return out


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
    from shark_tpu_torch.utils.timers import cuda_ms

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
    n_src = sum(src.endswith(".cu") for src in kernels.sources())
    say(f"build: nvcc {nvcc_s:.1f} s ({n_src} sources in parallel), g++ "
        f"native engine {gpp['s']:.1f} s")
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
    record_shape = shapes[0] if args.quick else RECORD_SHAPE
    timer = functools.partial(cuda_ms, reps=REPS)
    record = check_kernels(clf, hgenes, shapes, record_shape, timer)
    del clf

    # ... and K5/K6 on the transcriptome's index, which the C++ engine
    # builds from the FASTA that phase 4 (d) reads
    work = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        need(native.available(), "the transcriptome phases need the native "
                                 "engine")
        tx_dir = os.path.join(work, "txome")
        os.makedirs(tx_dir)
        t0 = time.perf_counter()
        tgenes = txome_genes(np.random.default_rng(2026))
        tx_fa = os.path.join(tx_dir, "genes.fa")
        write_fasta(tx_fa, tgenes, b"G")
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tindex = native.build_index_native(tx_fa, K, BF_GB << 33,
                                           threads=os.cpu_count())
        index_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        xclf = Classifier(tindex, max_winners=16, c=C)
        xl_s = time.perf_counter() - t0
        need(xclf.probe == "xl", f"transcriptome: probe {xclf.probe}")
        need(xclf._hmeta.has_side, "transcriptome: xl table without a side")
        geometry = xl_geometry(xclf)
        t0 = time.perf_counter()
        cclf = Classifier(tindex, max_winners=16, c=C, probe="classic")
        classic_s = time.perf_counter() - t0
        say(f"kernels: transcriptome {tindex.n_genes} genes, "
            f"{tindex.n_set_bits} set bits (generated {gen_s:.1f} s, index "
            f"{index_s:.1f} s); xl {json.dumps(geometry)} "
            f"({xl_s:.1f} s, table {xclf.dix.table.numel() * 4 / 1e9:.2f} "
            f"GB); classic tables {classic_s:.1f} s (bf_rank "
            f"{cclf.dix.bf_rank.numel() * 4 / 1e9:.2f} GB, pay "
            f"{cclf.dix.pay.numel() * 4 / 1e9:.2f} GB)")
        record.update(check_txome_kernels(xclf, cclf, tgenes, shapes,
                                          record_shape, timer))
        del xclf
        gc.collect()
        torch.cuda.empty_cache()
        record.update(check_sharded_kernels(tindex, cclf, tgenes, shapes,
                                            record_shape, timer))
        del cclf, tindex
        gc.collect()
        torch.cuda.empty_cache()
        if args.quick:
            say(f"quick check done in {time.perf_counter() - t_start:.0f} s")
            return 3  # no result line: --quick is not the smoke test

        # 4. end to end through the CLI; the counters are zeroed before
        # each path and read after it
        rng = np.random.default_rng(12345)
        pgenes = panel_genes(rng)
        e2e_stats = {}
        launches = {}
        kernels.LAUNCHES.reset()
        e2e_stats["panel"] = e2e(work, "panel", pgenes, b"GENE",
                                 panel_reads(rng, pgenes, N_PANEL_READS))
        a = kernels.LAUNCHES.snapshot()
        e2e_stats["homolog"] = e2e(work, "homolog", hgenes, b"H",
                                   homolog_reads(rng, hgenes, N_HOMOLOG_READS))
        b = kernels.LAUNCHES.snapshot()
        e2e_stats["paired"] = e2e(work, "paired", pgenes, b"GENE",
                                  *pair_reads(rng, pgenes, N_PAIRS))
        launches["a-c"] = ("hashed", kernels.LAUNCHES.snapshot())
        e2e_stats.update(e2e_txome(
            tx_dir, tx_fa, panel_reads(np.random.default_rng(2027), tgenes,
                                       N_TXOME_READS), launches))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    e2e_stats["txome"]["geometry_phase3"] = geometry

    # 5. the two Pallas experiments' counterparts at their default sizes
    gc.collect()
    torch.cuda.empty_cache()
    record.update(check_experiments(timer, launches))
    need(e2e_stats["homolog"]["group_rows"] > 0, "homolog: no group verdicts")
    need(b["pairs"] > a["pairs"], "homolog: extract_pairs never launched")
    for run, (path, counts) in launches.items():
        say(f"launches of ({run}), the {path} path: {json.dumps(counts)}")
        for name in PATH_KERNELS[path]:
            need(counts[name] > 0,
                 f"kernel {name} was not launched on the {path} path")
        for name in PATH_ONLY:
            if name not in PATH_KERNELS[path]:
                need(counts[name] == 0,
                     f"the {path} path launched the {name} kernel")
    total = {name: sum(c[name] for _, c in launches.values())
             for name in KERNEL_INFO}
    say(f"launches over (a)-(g) and phase 5: {json.dumps(total)} (hashed "
        f"path after (a): {json.dumps(a)}, after (b): {json.dumps(b)})")

    kernels_line = {"kernels": []}
    for name, (fn, src, replaces) in KERNEL_INFO.items():
        r = record[name]
        kernels_line["kernels"].append({
            "name": fn, "route": "cuda", "source": src, "replaces": replaces,
            "launches": total[name], "max_abs_err": r["err"],
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
                       "record_shape": RECORD_SHAPE, "launches": launches,
                       "e2e": e2e_stats}, f, indent=1)
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
