#!/usr/bin/env python3
"""Smoke test of shark_tpu_torch on one CUDA card (written for an H100).

Run from the root of a checkout, on a machine with one card:

    python3 chip_smoke.py [--out DIR] [--quick]

Phases, each printing its lines; any failure exits non-zero:

1. card: the card's name and power limit (nvidia-smi);
2. build: nvcc for the eleven CUDA kernels (the nine csrc/*.cu, one nvcc
   each, all started together), nvcc for the bare gathers that the
   probes are held to (csrc/floors/gathers.cu through
   shark_tpu_torch/floors.py, not kernels of the port) and g++ for the
   C++ host engine, timed;
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
   equal the classic classifier's. The record holds each kernel at
   B = 65536, L = 104, and the homolog index's kernels (K1-K4) also at
   the CLI's batch B = 8192; for every classify kernel it adds the device
   time from torch.profiler (and the router's split into its memset and
   kernel) beside the CUDA-event time, which also holds the wrapper's
   host work. Each device reading is held against the back-to-back event
   time of the same call: where the calls queue faster than the card runs
   them, a profiler session under 0.8x of it is dropped and more are
   taken, and a row none of whose sessions agrees is marked
   device_ms_suspect, with every reading.
   Each batch prints how many reads took the finish's block path, held to
   finish_heavy_reads_plain; where the index has group ids, the finish's
   group pass alone (finish_group_count, what a part of a replicated batch
   runs) and the finish given a count that flips its group choice are held
   to their plain versions too. A batch of 64 reads at L = 32768 holds the
   front end's long-read kernel to its plain version. At the record shape
   the xl probe's footprint line times it with every bucket masked into
   the table's first 32 MB and 256 MB, on the whole table, and without
   its side table (those three are wrong, timing only), beside the bare
   16-byte gather at the same bucket indices. At the record shape and at
   the CLI's batch the hashed probe's floor line gives its stash (real and
   padded rows, windows matching a row) and times it beside itself with
   a stash of 32 padding rows (wrong results, timing only), P2's kernel
   (resident_match) on the hashed probe's own windows and table (equal to
   it on every window outside the stash) and the bare 32-byte gather of
   the same buckets. At the record shape the owner probe's floor line
   gives its sector-counted bound (16 bytes a slot, 32 a distinct word
   row and a distinct pay row) and times it beside the bare two-level
   gather of the same rows (one kernel of dependent loads, and each
   level alone), beside itself with the routed words masked into each
   shard's first 4 MB, 32 MB and 256 MB of rows (wrong results, timing
   only), and beside the classic probe on the same windows and the bare
   two-level gather of the classic probe's own rows. Those lines
   give event ms, device ms and back-to-back ms (20 launches between two
   events, L2 warm). The library forms of the owner probe and the return
   compute their whole function (indices, every slot or window, zeros on
   a miss). The return reads the owner probe's replies in place (a
   transposed view, as the classifier passes them on one card) and is
   held equal on their contiguous copy too; its row gives that copy's
   event and device time (exchange_back_ms, exchange_back_device_ms),
   the copy the one-card path no longer makes;
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
   Then the entry points of the replicated index, the host backend, the
   profiler and the multi-host launch: (h) run_pipeline on (b)'s sample
   with the index replicated over [cuda:0, cuda:0]
   (DataParallelClassifier), (b)'s bytes; (i) the same with --load-index
   on (e)'s reads (the xl table cache), (d)'s prefix; (j) --backend
   native through the CLI on (a)'s first 20k reads with -t the host's CPU
   count, (a)'s --backend cpu bytes on them and no kernel launch, its
   reads/s beside the CPU count; (k) (a) again with --profile-dir, (a)'s
   bytes and launch counts, and the card's busy share read from the
   trace's kernel records over the span from the first kernel to the
   last (and against classify_s), through shark_tpu_torch/utils/trace.py;
   (l) (c)'s pairs split in two at a pair
   boundary, two CLI processes at once on the card (--coordinator
   localhost:<free port> --num-hosts 2 --host-id 0|1, each with a
   timeout), whose parts merged in host order are (c)'s bytes; (n)
   bench.py's quality-masked workload: (a)'s reads with bench.py's
   quality profile (~3% of bases under q20) and -q 10, against a
   --backend cpu -q 10 run on the first 20k reads and the oracle, with
   the reads' qualities and the mask, on 2000. Then (m) the soak's fixed
   seeds (SOAK_SEEDS) of tests/test_torch_fuzz.py's run_seed on the card:
   each seed's random workload (k 11-17, paired or not, gzip, CRLF,
   lowercase, Ns, reads shorter than k, -q 0 or 10) through the native
   engine and the Python I/O on the seed's layout (auto, classic or xl),
   --backend native, --backend cpu and its extra path (8 shards on the
   card with a small routing cap, or the index replicated over [cuda:0,
   cuda:0]), every output equal to the oracle's ssv and to the other
   runs' FASTQs, each device run's layout kernels launched, and the ties
   pass (every gene written two or three times: K4 and GROUP verdicts);
   the seeds together cover every layout, both extra paths, reprobe,
   pairs, gzip, -q 10, K4 and GROUP verdicts. Last, (o) bench_gpu.py
   --workload panel in a process of its own at 50k reads (its comparator,
   passes, --backend native, device-only batch, gather ceiling and the
   re-visit on the saved index and its probe-table cache), whose line
   must hold panel_exact true; its launches are its own process's. Then
   (p) scripts/profile_e2e_torch.py --workload panel at 50k reads in a
   process of its own: the serial pass's stages (parse, h2d, dispatch,
   device, fetch_packed, extract_pairs, winner_pairs, emit) must add up
   to within 5% of its total, its bytes must equal the overlapped
   passes' and its profiled pass's, and it must launch the panel path's
   kernels; one line prints the split. Then (q) the A/B harnesses, each
   in a process of its own on one cache at 50k reads:
   scripts/repro_contamination_torch.py (the homolog, then bench_gpu.py's
   panel stage in the same process, then the homolog again; every pass's
   bytes equal, one line of the before and after reads/s with the
   diagnostics that moved) and scripts/ab_layout_torch.py at the natural
   bucket count and one below, 8 and 4 slots (every variant's probe equal
   to its plain version and its verdicts to the production layout's);
   and the bare gathers' 4-, 64- and 128-byte rows against their plain
   versions. Then (r) the K1 and K3 stage profilers and the FIX_CAP2
   A/B, one after another in one process of their own at one batch
   (65536 reads) under a time limit, L2 warm only:
   scripts/profile_front_torch.py on the panel's batch (K1 cut into
   timing-only variants of csrc/front.cu; the whole kernel's variant
   equal to the front end and its plain version, at a power-of-two Bloom
   size and at a multiple of 2^32),
   scripts/profile_finish_torch.py on the panel's and the homolog's
   (variants of csrc/finish.cu's warp pass; the whole one, the
   sort-always one and the 84-column one equal to the finish and its
   plain version) and scripts/ab_fixcap_torch.py on the homolog's (every
   FIX_CAP2 cap's verdicts equal to the plain finish at that cap, and to
   production's on its side of the batch's demand); every check of each
   line must hold, and each ladder's rung ms prints on one line. Then
   (s) the probe stage profilers the same way: scripts/profile_probe_torch.py
   on the panel's batch with its classic/hashed A/B (--ab: classic at
   L = 128 and 104, hashed at 104, verdicts equal) and on the homolog's
   (K2 cut into timing-only variants of csrc/probe.cu; the whole one equal
   to the probe and its plain version), profile_txome_torch.py --quick
   (K6 and K5 cut into variants of csrc/xl.cu and csrc/classic.cu, the
   whole ones equal to their kernels and plain versions) and
   sort_bench_torch.py (the dedup's pieces; its result equal to the full
   gather). The variants are not kernels of the port and stay off the
   kernels line.
   Last, (t) the inputs the soak never draws: K1 -> K2 -> K3 -> K4 on the
   homolog index and K1 -> K6 and K1 -> K5 on the transcriptome's ((d)'s
   saved index and xl tables), each held to its plain version (exact) at
   L = 264, 1024, 2048, 16384 and 16392 (B = 64, 8 from 16384 on; K3 and
   K4 at max_winners 16, 2 and 1), one line an L with the reads a block
   of K1 takes there (csrc/front.cu's shared-memory halving); EDGE_SEEDS
   of tests/test_torch_fuzz.py's run_edges on the card (reads of 90 to
   20000 bases, mates from the gene, --max-read-len auto, rounded and not
   a multiple of 8, -s, max_winners 1, 2 and 16 against every gene written
   two or three times, batches of 32 and 8192, at -b 1), which together
   must cover EDGE_COVERS; and the probe-table cache of the hashed and xl
   layouts after --save-index, loaded back with one byte of the table
   flipped (the crc rejects it) and with another FASTA's tables in its
   slot (the digest rejects them): each run rebuilds and re-saves the
   tables and writes the fresh run's bytes.
   The launch counters are zeroed before each run and read after it:
   (a)-(c), (h) and (n) launch the hashed path's kernels, (d) and (i) the
   xl path's, (e) the classic path's, (f) and (g) the sharded path's, (k)
   (a)'s exactly, (j) none, (m) every classify kernel, (t)'s edge seeds
   every layout's probe, the finish and K4 (no sharded kernel), its cache
   runs the hashed and xl paths';
5. the port's counterparts of the two Pallas experiments, through their
   entry points at their default sizes (shark_tpu_torch.experiments:
   gather_tiles.main, 2^20 random 512-byte tiles of a 1 GiB table;
   resident_match.main, one 5,767,168-probe batch against a 16 MB table),
   each run with the counters zeroed before it and read after; then each
   kernel against its plain version on the same inputs at that size, and
   against its library form (table[idx] rows; the gather+match of the
   hashed probe), exact, with kernel, plain and library times and the
   bound; P2 also with its device time (L2 warm), its event time with
   the L2 warm (warm_ms), its bound in 64-byte sectors and its warm bound
   (the streams alone, the table in L2). No classify run (a)-(g) may
   launch these two kernels.

The last lines are the kernels' JSON record (launches summed over
(a)-(t) and phase 5), the nvidia-smi line, and
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
N_BENCH_READS = 50_000  # (o): bench_gpu.py's panel, trimmed
STAGE_READS = 65_536  # (r), (s): one batch of each workload
TXOME_GENES = 50_000
N_CPU_CHECK, N_ORACLE_CHECK = 20_000, 2_000
SHAPES = [(8192, 104), (8192, 208), (65536, 104), (65536, 208)]
RECORD_SHAPE = (65536, 104)  # bench.py's batch: the shape the record holds
CLI_SHAPE = (8192, 104)  # the CLI's batch: K1-K4 are recorded here too
LONG_SHAPE = (64, 32768)  # reads over 16384 bases: K1's long-read kernel
FRONT_MAX_SHORT_L = 16384  # csrc/front.cu kMaxShortL
# (t): K1-K6 past the soak's L = 256: each rule of pipeline._round_len, the
# staged front end's last length and the long-read kernel's first
LONG_LS = (264, 1024, 2048, 16384, 16392)
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
    "panel": ("front", "probe", "finish"),  # the hashed path, few ties
    "xl": ("front", "probe_xl", "finish"),
    "classic": ("front", "classic", "finish"),
    "sharded": ("front", "shard_route", "shard_probe", "shard_return",
                "finish"),
    # (m): every layout over its seeds (run_seed checks each run's own)
    "soak": ("front", "probe", "probe_xl", "classic", "shard_route",
             "shard_probe", "shard_return", "finish", "pairs"),
    # (t): the edge seeds, every replicated layout (run_edges checks each)
    "edges": ("front", "probe", "probe_xl", "classic", "finish", "pairs"),
    "gather_tiles": ("gather_tiles",),
    "resident_match": ("resident_match",),
}
PATH_ONLY = ("probe", "probe_xl", "classic", "shard_route", "shard_probe",
             "shard_return", "gather_tiles", "resident_match")
SHARDS = 8
# (m)'s seeds of tests/test_torch_fuzz.py: hashed (0, 21), xl (2, 5, 10,
# 11, 23) and classic (4, 7, 8) layouts; 8 shards (0, 2, 4, 7; reprobe
# fires on 2 and 4), replicated (8, 10, 21, 23); paired, gzip, minq 10
# and k = 11, 15, 17 among them; the ties pass's GROUP verdicts on 4, 5
# and 21 (on the CPU)
SOAK_SEEDS = (0, 2, 4, 5, 7, 8, 10, 11, 21, 23)
SOAK_COVERS = ("hashed", "xl", "classic", "sharded", "replicated", "reprobe",
               "paired", "gz", "minq10", "tie_pairs", "groups")
# (t)'s seeds of tests/test_torch_fuzz.py's run_edges: 4 (band 0, an
# emitting innie pair, max_winners 1: the host recompute), 9 (band 1, auto,
# B = 8192), 33 (a read of 19849 bases, auto: the engine packs its batch
# at L = 32768), 53 (--max-read-len 193: the unpacked engine path, B = 8192,
# max_winners 16) and 54 (band 2 at L = 4096, -s, max_winners 2), on the
# classic, hashed and xl layouts; and what they must cover together
# (edge_covers)
EDGE_SEEDS = (4, 9, 33, 53, 54)
EDGE_COVERS = ("band0", "band1", "band2", "band3", "auto", "rounded",
               "unpacked", "unpacked_engine", "auto_long", "pair_emits",
               "single", "host_rows", "W1", "W2", "W16", "B32", "B8192",
               "hashed", "xl", "classic")
CARD = torch.device("cuda", 0)  # the replicated runs' device, twice


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


def q10_quals(rng, n):
    """bench.py's quality profile (:176-183), Phred+33 uint8 [n, READ_LEN]:
    ~97% of bases q30..40, ~3% q2..19."""
    q = rng.integers(30, 41, size=(n, READ_LEN))
    low = rng.random((n, READ_LEN)) < 0.03
    q[low] = rng.integers(2, 20, size=int(low.sum()))
    return (q + 33).astype(np.uint8)


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


def write_fastq(path, reads, prefix: bytes, quals=None):
    """Fixed-width records @<prefix><7 digits>, with the given quality
    bytes (uint8 [n, READ_LEN]) or 'I' throughout."""
    n, rl = reads.shape
    if quals is None:
        quals = np.full((n, rl), ord("I"), np.uint8)
    head = np.frombuffer(
        b"".join(b"@%s%07d\n" % (prefix, i) for i in range(n)), np.uint8
    ).reshape(n, -1)
    rec = np.concatenate([
        head, reads, np.full((n, 1), ord("\n"), np.uint8),
        np.frombuffer(b"+\n", np.uint8)[None, :].repeat(n, 0),
        quals,
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


def device_fields(fn):
    """A kernel row's device fields: device_ms, device_ops and, where the
    reading disagrees with the back-to-back time, device_ms_suspect."""
    p = device_profile(fn)
    return {k: p[k] for k in ("device_ms", "device_ops", "device_ms_suspect")
            if k in p}


def own_module(name, *path):
    """A module of this checkout's shark_tpu_torch/ loaded by path, so
    that a script timing another checkout's package still finds it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "shark_tpu_torch", *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def own_timers():
    """This checkout's shark_tpu_torch/utils/timers.py (profiler sessions,
    back-to-back event times, the L2 flush)."""
    return own_module("shark_timers", "utils", "timers.py")


def device_profile(fn):
    """timers.device_profile at REPS, L2 warm, its warnings printed."""
    return own_timers().device_profile(fn, REPS, warn=say)


def Gathers():
    """The bare row gathers the probes are held to (as P1 holds K5 and
    K7b): shark_tpu_torch/floors.py of this checkout and its source
    csrc/floors/gathers.cu (4- to 128-byte rows, a dependent two-level
    gather; not kernels of the port), built, loaded by path."""
    mod = own_module("shark_floors", "floors.py")
    mod.lib()
    return mod


def xor_rows(rows32):
    """Each row of an int32 [n, w] tensor folded to one word by xor, as
    the bare gathers fold it; u32[n]."""
    x = rows32[:, 0]
    for c in range(1, rows32.shape[1]):
        x = x ^ rows32[:, c]
    return x.view(torch.uint32)


def timings(fn):
    """(event ms, device ms, back-to-back ms) of fn(), and a fourth entry
    "device_ms_suspect" where the device reading disagrees with the
    back-to-back time (device_profile)."""
    from shark_tpu_torch.utils.timers import cuda_ms

    p = device_profile(fn)
    out = (cuda_ms(fn, reps=REPS), p["device_ms"], p["back_to_back_ms"])
    return out + (("device_ms_suspect",) if "device_ms_suspect" in p else ())


def xl_footprint(args6, hmeta, gathers):
    """K6 on the same windows with idx_lo's bucket bits masked so that every
    bucket falls in the table's first 32 MB (L2-resident) or 256 MB, on the
    whole table, and with has_side false (these three give wrong results:
    timing only), beside the bare 16-byte gather at the same bucket
    indices. {run: (event ms, device ms, back-to-back ms)}: compare runs
    within one process, which holds one allocation of the table."""
    from shark_tpu_torch.classify import hashed

    idx_hi, idx_lo, win_valid = args6[:3]
    lo = idx_lo.to(torch.int64)
    bmask = (1 << hmeta.lgB) - 1
    out = {}
    for tag, rows_log2 in (("32MB", 21), ("256MB", 24)):
        keep = min((1 << rows_log2) - 1, bmask)
        masked = ((lo & ~bmask) | (lo & keep)).to(torch.uint32)

        def run(m=masked):
            return hashed.probe_xl(idx_hi, m, win_valid, *args6[3:])
        out[tag] = timings(run)

    def full():
        return hashed.probe_xl(*args6)

    def no_side():
        return hashed.probe_xl(*args6[:-1],
                               dataclasses.replace(hmeta, has_side=False))
    for tag, fn in (("full", full), ("no_side", no_side)):
        out[tag] = timings(fn)
    bidx = (lo & bmask)[win_valid].to(torch.int32)
    rows = args6[3].view(torch.int32)[bidx.long()]
    same("gather16", [gathers.rows(args6[3], bidx, 16)], [xor_rows(rows)])
    del rows
    def floor():
        return gathers.rows(args6[3], bidx, 16)
    out["gather16"] = timings(floor)
    out["gather16_rows"] = int(bidx.numel())
    return out


def stash_counts(stash):
    """(rows of the stash that are not padding, all rows): a padding row
    is 0xFFFFFFFF in all four words."""
    pad = (stash.view(torch.int32) == -1).all(1)
    return int((~pad).sum()), stash.shape[0]


def stash_hits(idx_hi, idx_lo, win_valid, stash):
    """The valid windows whose position (lo, hi) is a stash row's that is
    not padding."""
    lo = idx_lo.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    hi = idx_hi.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    st = stash.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    hit = torch.zeros_like(win_valid)
    for r in range(st.shape[0]):
        if not bool((st[r] == 0xFFFFFFFF).all()):
            hit |= (lo == st[r, 0]) & (hi == st[r, 1])
    return hit & win_valid


def resident_operands(idx_hi, idx_lo, win_valid, lgB):
    """P2's operands for the hashed probe's windows on an entry16 8-slot
    table of 2^lgB buckets: rows = bucket >> 4 (i32) and want = rest |
    (bucket & 15) << 14, 0xFFFFFFFF for an invalid window (u32), flat."""
    lo = idx_lo.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    hi = idx_hi.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bucket = lo & ((1 << lgB) - 1)
    rest = ((lo >> lgB) | (hi << (32 - lgB))) & 0xFFFFFFFF
    want = torch.where(win_valid, rest | ((bucket & 15) << 14), 0xFFFFFFFF)
    return ((bucket >> 4).to(torch.int32).reshape(-1),
            want.reshape(-1).to(torch.uint32))


def probe_floor(args2, stash_rows, gathers):
    """K2 on its own windows and table beside what it is held to, as
    {run: (event ms, device ms, back-to-back ms)} and counts: K2 itself;
    K2 with its stash replaced by 32 padding rows (wrong results where a
    window matches a stash row: timing only); P2's kernel (resident_match)
    on the same buckets and keys of an entry16 8-slot table, which is K2's
    bucket work without the stash, held equal to K2 on every window that
    matches no stash row; and the bare 32-byte gather of the same buckets
    (an entry16 8-slot bucket; an entry8 bucket is 64 bytes, gathered as
    two 32-byte rows)."""
    from shark_tpu_torch.classify import hashed
    from shark_tpu_torch.experiments import resident_match as R

    idx_hi, idx_lo, win_valid, table, stash, hmeta = args2
    lo = idx_lo.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    real, padded = stash_counts(stash)
    in_stash = stash_hits(idx_hi, idx_lo, win_valid, stash)
    out = {"stash_rows": real, "stash_rows_padded": padded,
           "stash_windows": int(in_stash.sum())}
    out["probe"] = timings(lambda: hashed.probe_hashed(*args2, stash_rows))
    pad32 = torch.full((32, 4), -1, dtype=torch.int32,
                       device=stash.device).view(torch.uint32)
    out["padding_stash"] = timings(
        lambda: hashed.probe_hashed(*args2[:4], pad32, hmeta, 0))
    mask = (1 << hmeta.lgB) - 1
    bucket = lo & mask
    tagv, payv = hashed.probe_hashed(*args2, stash_rows)
    if hmeta.entry16 and hmeta.slots == 8:
        rows, want = resident_operands(idx_hi, idx_lo, win_valid, hmeta.lgB)
        t128 = table.view(-1, 128)
        got = R.resident_match(rows, want, t128)
        keep = ~in_stash.reshape(-1)
        g32 = got.view(torch.int32)
        same("resident_match on the hashed probe's windows",
             [g32[keep, 0], g32[keep, 1]],
             [tagv.view(torch.int32).reshape(-1)[keep],
              payv.view(torch.int32).reshape(-1)[keep]])
        out["resident_match"] = timings(
            lambda: R.resident_match(rows, want, t128))
    bidx = bucket[win_valid].to(torch.int32)
    row_bytes = table[0].numel() * 4
    per = row_bytes // 32
    gidx = (bidx[:, None] * per + torch.arange(
        per, device=bidx.device, dtype=torch.int32)).reshape(-1)
    t32 = table.view(torch.int32).reshape(-1, 8)
    same("gather32", [gathers.rows(table, gidx, 32)],
         [xor_rows(t32[gidx.long()])])
    out["gather32"] = timings(lambda: gathers.rows(table, gidx, 32))
    out["gather32_rows"] = int(gidx.numel())
    return out


def owner_probe_rows(recv, tables, wps):
    """(widx, pidx, hit) of the slots H owners received, int64: the global
    (word, rank) row of every routed slot, the global pay row it leads to
    (-1 where it misses or its rank is past the pay rows) and whether it
    hits."""
    from shark_tpu_torch.classify import step

    H = recv.shape[0]
    rows_max = tables.pay.shape[1]
    q = recv.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    routed = q[..., 0] < wps
    h = torch.arange(H, device=recv.device).view(-1, 1, 1).expand_as(routed)
    widx = (h * wps + q[..., 0])[routed]
    wr = tables.bf_rank.view(torch.int32).reshape(-1, 2)[widx].to(
        torch.int64) & 0xFFFFFFFF
    bit = q[..., 1][routed] & 31
    rank = wr[:, 1] + step._popcount32(
        wr[:, 0] & ((torch.ones_like(bit) << bit) - 1))
    hit = (((wr[:, 0] >> bit) & 1) == 1) & (rank < rows_max)
    return widx, torch.where(hit, h[routed] * rows_max + rank, -1), hit


def masked_words(recv, wps, rows_log2):
    """recv with every routed word masked into its shard's first
    2^rows_log2 (word, rank) rows (wrong results: timing only)."""
    q = recv.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    keep = min((1 << rows_log2) - 1, wps - 1)
    q[..., 0] = torch.where(q[..., 0] < wps, q[..., 0] & keep, q[..., 0])
    return torch.where(q >= 1 << 31, q - (1 << 32), q).to(
        torch.int32).view(torch.uint32)


def shard_probe_floor(recv, tables, wps, gathers):
    """K7b on the slots the owners received beside what it is held to, as
    {run: (event ms, device ms, back-to-back ms)} and counts: K7b; the
    bare two-level gather of the same rows (word rows, then the pay rows
    of the hits) in one kernel with dependent loads, and each level alone
    (two kernels of independent loads, gather_words and gather_pays); K7b
    with every routed word masked into each shard's first 4 MB, 32 MB and
    256 MB of (word, rank) rows (wrong results, timing only); and the
    sector-counted bound: 16 bytes a slot, 32 a distinct word row and 32
    a distinct pay row."""
    from shark_tpu_torch.parallel import sharded_bf as sb

    bf_rank, pay = tables.bf_rank, tables.pay
    widx, pidx, hit = owner_probe_rows(recv, tables, wps)
    bfr = bf_rank.view(torch.int32).reshape(-1, 2)
    payr = pay.view(torch.int32).reshape(-1, 2)
    n_slots = recv.numel() // 2
    words = int(torch.unique(widx).numel())
    pays = int(torch.unique(pidx[hit]).numel())
    out = {"slots": n_slots, "routed": int(widx.numel()),
           "hits": int(hit.sum()), "word_rows": words, "pay_rows": pays,
           "sector_bound_ms": (n_slots * 16 + 32 * words + 32 * pays)
           / PEAK_BYTES_S * 1e3}
    out["shard_probe"] = timings(lambda: sb.shard_probe(recv, bf_rank, pay))
    widx32 = widx.to(torch.int32)
    pidx32 = pidx.to(torch.int32)
    ridx32 = pidx32[hit]
    pw = torch.where(hit[:, None], payr[torch.clamp(pidx, min=0)], 0)
    same("two-level gather",
         [gathers.two_level(bf_rank, widx32, pay, pidx32)],
         [xor_rows(torch.cat([bfr[widx], pw], 1))])
    out["two_level"] = timings(
        lambda: gathers.two_level(bf_rank, widx32, pay, pidx32))
    out["gather_words"] = timings(
        lambda: gathers.rows(bf_rank, widx32, 8))
    out["gather_pays"] = timings(lambda: gathers.rows(pay, ridx32, 8))
    for tag, rows_log2 in (("4MB", 19), ("32MB", 22), ("256MB", 25)):
        m = masked_words(recv, wps, rows_log2)
        out[f"mask_{tag}"] = timings(
            lambda m=m: sb.shard_probe(m, bf_rank, pay))
    return out


def classic_floor(args5, gathers):
    """The bare two-level gather of K5's own rows on its windows (the
    (word, rank) row of every valid window, then the pay row of every
    hit), held to the rows it folds, as {"classic_two_level": (event ms,
    device ms, back-to-back ms), "classic_word_rows", "classic_pay_rows"}."""
    from shark_tpu_torch.classify import step

    idx_hi, idx_lo, win_valid, bf_rank, pay = args5
    lo = idx_lo.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    hi = idx_hi.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    word = (hi << 27) | (lo >> 5)
    rank, hit = step.probe_rank_plain(bf_rank, word, lo & 31, win_valid)
    widx = word[win_valid]
    pidx = torch.where(hit, rank, -1)[win_valid]
    bfr = bf_rank.view(torch.int32)
    payr = pay.view(torch.int32)
    pw = torch.where((pidx >= 0)[:, None], payr[torch.clamp(pidx, min=0)], 0)
    widx32, pidx32 = widx.to(torch.int32), pidx.to(torch.int32)
    same("classic two-level gather",
         [gathers.two_level(bf_rank, widx32, pay, pidx32)],
         [xor_rows(torch.cat([bfr[widx], pw], 1))])
    return {"classic_two_level": timings(
        lambda: gathers.two_level(bf_rank, widx32, pay, pidx32)),
        "classic_word_rows": int(widx.numel()),
        "classic_pay_rows": int(hit.sum())}


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


def check_kernels(clf, genes, shapes, record_shape, timer, gathers):
    """Phase 3. Returns the per-kernel records at record_shape and at
    CLI_SHAPE."""
    from shark_tpu_torch.classify import hashed, step

    dix, hmeta = clf.dix, clf._hmeta
    dev = clf.device
    rng = np.random.default_rng(2024)
    W = clf.max_winners
    record, cli_record = {}, {}
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
            **device_fields(lambda: step.front_end(packed, vmask, meta)),
        )
        idx_hi, idx_lo, win_valid, length = k1

        # K2 -------------------------------------------------------------
        args2 = (idx_hi, idx_lo, win_valid, dix.table, dix.stash, hmeta)
        probe = functools.partial(hashed.probe_hashed, *args2,
                                  dix.stash_rows)
        k2 = probe()
        e2 = same("probe_hashed", k2, hashed.probe_hashed_plain(*args2))
        mask = (1 << hmeta.lgB) - 1
        bucket = idx_lo.view(torch.int32).to(torch.int64) & mask
        row_bytes = dix.table[0].numel() * 4
        touched = int(torch.unique(bucket[win_valid]).numel())
        nbytes = n * 9 + touched * row_bytes + dix.stash.numel() * 4 + n * 8
        tbl = dix.table.view(torch.int32).reshape(dix.table.shape[0], -1)
        rows["probe"] = dict(
            err=e2,
            ms=timer(probe),
            plain_ms=timer(lambda: hashed.probe_hashed_plain(*args2)),
            library_ms=timer(lambda: tbl[bucket]),
            bound=bound(nbytes, n * (4 * tbl.shape[1] + 10)),
            **device_fields(probe),
        )
        if (B, L) in (record_shape, CLI_SHAPE):
            fl = probe_floor(args2, dix.stash_rows, gathers)
            say(f"kernel probe_hashed floor B={B} L={L} (event ms, device "
                f"ms, back-to-back ms; padding_stash gives wrong results, "
                f"timing only): {json.dumps(fl)}")
            rows["probe"]["floor"] = fl
        tagv, payv = k2

        # K3 -------------------------------------------------------------
        kw3 = dict(rows3=dix.rows3, ext_mat=dix.ext_mat, meta=meta,
                   max_winners=W, L=L, has_rows=hmeta.has_rows)
        args3 = (tagv, payv, length, thresh)
        k3 = step.finish_from_tags(*args3, **kw3)
        n_block = step.finish_heavy_count()
        e3 = same("finish_from_tags", k3[:3],
                  step.finish_from_tags_plain(*args3, **kw3)[:3])
        if hmeta.has_rows and meta.rows_bits:
            # K3's group pass alone and the finish given another count
            # (a part of a replicated batch): the plain versions' results
            n_fix = torch.zeros(1, dtype=torch.int32, device=tagv.device)
            step.finish_group_count(tagv, payv, n_fix, meta=meta,
                                    has_rows=True)
            n_plain = int(step._group_flags(
                tagv.to(torch.int64), payv.to(torch.int64),
                meta.rows_bits)[2].sum())
            need(int(n_fix) == n_plain, f"finish_group_count: {int(n_fix)} "
                 f"impure reads, the plain pass counts {n_plain}")
            cap = step.fix_caps(B)[1]
            flip = torch.full_like(n_fix, 0 if n_plain > cap else cap + 1)
            same("finish_from_tags (batch count)",
                 step.finish_from_tags(*args3, n_fix=flip, fix_cap2=cap,
                                       **kw3)[:3],
                 step.finish_from_tags_plain(*args3, n_fix=flip,
                                             fix_cap2=cap, **kw3)[:3])
        want_block = int(step.finish_heavy_reads_plain(
            tagv, payv, rows3=dix.rows3, ext_mat=dix.ext_mat, meta=meta, L=L,
            has_rows=hmeta.has_rows).sum())
        need(n_block == want_block,
             f"finish: {n_block} reads took the block path, the plain "
             f"classification says {want_block}")
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
            **device_fields(lambda: step.finish_from_tags(*args3, **kw3)),
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
            bound=bound(B * 4 + total * 4 + min(cap, B * W) * 4, B * W * 3),
            **device_fields(lambda: step.extract_pairs(k3[0], k3[1], cap)),
        )
        say_rows(rows, B, L)
        say(f"kernel batch B={B} L={L}: group verdicts {grp}, "
            f"winner pairs {total} (cap {cap}); the finish's block path "
            f"took {n_block} reads (warp path {B - n_block})")
        if (B, L) == record_shape:
            record = rows
        if (B, L) == CLI_SHAPE:
            cli_record = rows
    check_long_reads(clf, timer)
    return record, cli_record


def check_long_reads(clf, timer, B=LONG_SHAPE[0], L=LONG_SHAPE[1]):
    """K1's long-read kernel (L > 16384) against its plain version on
    random reads of random lengths with Ns, one of L bases and one all
    N."""
    from shark_tpu_torch.classify import step

    rng = np.random.default_rng(2029)
    meta, _ = clf._geometry(L)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4
    lens = rng.integers(L // 2, L + 1, size=B)
    lens[0] = L
    codes[np.arange(L)[None, :] >= lens[:, None]] = 4
    codes[1] = 4
    packed, vmask = step.pack_codes(torch.from_numpy(codes).to(clf.device))
    got = step.front_end(packed, vmask, meta)
    err = same("front_end (long reads)", got,
               step.front_end_plain(packed, vmask, meta))
    need(bool(got[2][0].any()) and not bool(got[2][1].any()),
         "front_end (long reads): window validity")
    say(f"kernel front_end long reads B={B} L={L}: exact (max|err| {err})  "
        f"kernel_ms={timer(lambda: step.front_end(packed, vmask, meta)):.4f}"
        f"  plain_ms="
        f"{timer(lambda: step.front_end_plain(packed, vmask, meta)):.4f}  "
        f"windows {got[0].numel()}, valid {int(got[2].sum())}")


def say_rows(rows, B, L):
    for name, r in rows.items():
        say_row(name, r, f"B={B:<6} L={L:<4}")


def say_row(name, r, where):
    lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
    dev = ""
    if "device_ms" in r:
        dev = "  device_ms=" + ("not measured" if r["device_ms"] is None
                                else f"{r['device_ms']:.4f}")
    if r.get("device_ops"):
        dev += "  device_ops=" + json.dumps(
            {k: round(v, 4) for k, v in r["device_ops"].items()})
    if "device_ms_suspect" in r:
        dev += f"  device_ms_suspect={json.dumps(r['device_ms_suspect'])}"
    say(f"kernel {KERNEL_INFO[name][0]:<17} {where} "
        f"exact (max|err| {r['err']})  kernel_ms={r['ms']:.4f}  "
        f"plain_ms={r['plain_ms']:.4f}  library_ms={lib}  "
        f"bound_ms={r['bound'][0]:.4f} ({r['bound'][1]}; bytes "
        f"{r['bound'][2]:.4f}, operations {r['bound'][3]:.4f}){dev}")


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


def check_txome_kernels(xclf, cclf, genes, shapes, record_shape, timer,
                        gathers):
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
            **device_fields(lambda: hashed.probe_xl(*args6)),
        )
        if (B, L) == record_shape:
            fp = xl_footprint(args6, hmeta, gathers)
            sectors = n * 17 + touched * 32 + side_touched * 64
            say("kernel probe_xl footprint B={} L={} (event ms, device ms, "
                "back-to-back ms; masked runs and no_side give wrong "
                "results, timing only): "
                "{}; gather16 of {} rows; sector-counted bound {:.4f} ms"
                .format(B, L, json.dumps({k: v for k, v in fp.items()
                                          if k != "gather16_rows"}),
                        fp["gather16_rows"], sectors / PEAK_BYTES_S * 1e3))
            rows["probe_xl"]["footprint"] = fp

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
            **device_fields(lambda: step.probe_tags(*args5)),
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


def route_rows(windows, dix, n, wps, wide, cap, timer, gathers=None):
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
        **device_fields(lambda: sb.shard_route(hi, lo, valid, **route)),
    )

    # K7b ------------------------------------------------------------------
    recv = _transposed(send)
    k7b = sb.shard_probe(recv, dix.bf_rank, dix.pay)
    eb = same("shard_probe", [k7b],
              [sb.shard_probe_plain(recv, dix.bf_rank, dix.pay)])
    widx, pidx, hit = owner_probe_rows(recv, dix, wps)
    rows_max = dix.pay.shape[1]
    bfr = dix.bf_rank.view(torch.int32).reshape(-1, 2)
    payr = dix.pay.view(torch.int32).reshape(-1, 2)
    n_slots = recv.numel() // 2
    recv32 = recv.view(torch.int32)
    hh = torch.arange(recv.shape[0], device=dev,
                      dtype=torch.int32).view(-1, 1, 1)

    def probe_library():
        """The whole of K7b in PyTorch's gathers: every slot's word row,
        its hit and rank, the pay row, zeros on a miss or an empty slot."""
        word, bit = recv32[..., 0], recv32[..., 1] & 31
        ok = (word >= 0) & (word < wps)
        w = bfr[(hh * wps + torch.where(ok, word, 0)).long()].long() \
            & 0xFFFFFFFF
        below = w[..., 0] & ((1 << bit.long()) - 1)
        rank = w[..., 1] + step._popcount32(below)
        hit = ok & (((w[..., 0] >> bit) & 1) == 1) & (rank < rows_max)
        prow = payr[(hh * rows_max + torch.where(hit, rank, 0)).long()]
        return torch.where(hit[..., None], prow, 0).view(torch.uint32)

    same("shard_probe library form", [probe_library()], [k7b])

    rows["shard_probe"] = dict(
        err=eb,
        ms=timer(lambda: sb.shard_probe(recv, dix.bf_rank, dix.pay)),
        plain_ms=timer(lambda: sb.shard_probe_plain(recv, dix.bf_rank,
                                                    dix.pay)),
        library_ms=timer(probe_library),
        bound=bound(n_slots * 16 + int(torch.unique(widx).numel()) * 8
                    + int(torch.unique(pidx[hit]).numel()) * 8,
                    int(widx.numel()) * 12),
        **device_fields(lambda: sb.shard_probe(recv, dix.bf_rank, dix.pay)),
    )
    if gathers is not None:
        fl = shard_probe_floor(recv, dix, wps, gathers)
        rows["shard_probe"]["floor"] = fl
        rows["shard_probe"]["sector_bound_ms"] = fl["sector_bound_ms"]

    # K7c ------------------------------------------------------------------
    # the replies in place, as the classifier passes them on one card; the
    # contiguous copy it used to make is timed beside (exchange_back_ms)
    back = k7b.transpose(0, 1)
    k7c = sb.shard_return(back, owner, slot)
    ec = same("shard_return", k7c, sb.shard_return_plain(back, owner, slot))
    same("shard_return on the contiguous replies",
         sb.shard_return(_transposed(k7b), owner, slot), k7c)
    ok = slot >= 0
    src = torch.arange(S, device=dev, dtype=torch.int32).view(S, 1, 1)
    replyr = k7b.view(torch.int32).reshape(-1, 2)
    n_routed = int(ok.sum())

    def return_library():
        """K7c's gather in PyTorch, over every window: the flat index of
        its reply in K7b's [owner, source] replies from (owner, slot),
        the reply row, zeros where the window has no slot (K7c also
        decodes the pay words)."""
        has = slot >= 0
        flat = (torch.where(has, owner, 0) * S + src) * cap \
            + torch.where(has, slot, 0)
        return torch.where(has[..., None], replyr[flat.long()], 0)

    rows["shard_return"] = dict(
        err=ec,
        ms=timer(lambda: sb.shard_return(back, owner, slot)),
        plain_ms=timer(lambda: sb.shard_return_plain(back, owner, slot)),
        library_ms=timer(return_library),
        bound=bound(nw * 8 + n_routed * 8 + nw * 8, nw * 6),
        exchange_back_ms=timer(lambda: _transposed(k7b)),
        exchange_back_device_ms=device_profile(
            lambda: _transposed(k7b))["device_ms"],
        **device_fields(lambda: sb.shard_return(back, owner, slot)),
    )
    stats = dict(windows=nw, routed=n_routed, cap=cap,
                 overflow=[int(x) for x in ovf.cpu()],
                 slots=n_slots, hits=int(hit.sum()))
    return rows, stats


def check_sharded_kernels(tindex, cclf, genes, shapes, record_shape, timer,
                          gathers):
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

    def run(tag, B, L, n, tables, wide, cap, floor=False):
        codes, wins = windows_of(B, L, n)
        rows, st = route_rows(wins, tables, n, tables.bf_rank.shape[1],
                              wide, cap, timer, gathers if floor else None)
        say_rows(rows, B, L)
        if floor:
            # K5 on the same windows, through the unsharded classic tables
            args5 = (*(t.reshape(B, -1) for t in wins), cclf.dix.bf_rank,
                     cclf.dix.pay)
            fl = rows["shard_probe"]["floor"]
            fl["classic"] = timings(lambda: step.probe_tags(*args5))
            fl.update(classic_floor(args5, gathers))
            say(f"kernel shard_probe floor B={B} L={L} ({tag}; event ms, "
                f"device ms, back-to-back ms; the masked runs give wrong "
                f"results, timing only; classic = probe_tags on the same "
                f"windows, classic_two_level = the bare two-level gather of "
                f"its own rows): {json.dumps(fl)}")
        say(f"kernel batch B={B} L={L} ({tag}): {json.dumps(st)}")
        return codes, rows, st

    for B, L in shapes:
        _, rows, st = run(f"{SHARDS} shards", B, L, SHARDS, dix, False,
                          sclf._probe_cap(B // SHARDS, L),
                          floor=(B, L) == record_shape)
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
    lines64 = int(torch.unique(b64[valid] >> 1).numel())
    r = record["resident_match"] = dict(
        err=err,
        ms=timer(lambda: R.resident_match(rows, want, t128)),
        plain_ms=timer(lambda: R.resident_match_plain(rows, want, t128)),
        library_ms=timer(lambda: tbl[b64]),
        # flushed: the table's buckets from device memory; also in the
        # 64-byte sectors the L2 may fetch; warm: the streams alone
        bound=bound(n * 16 + touched * 32, n_valid * (4 * 8 + 10)),
        sector_bound_ms=(n * 16 + lines64 * 64) / PEAK_BYTES_S * 1e3,
        warm_bound_ms=n * 16 / PEAK_BYTES_S * 1e3,
        warm_ms=warm_ms,
        **device_fields(lambda: R.resident_match(rows, want, t128)),
    )
    say_row("resident_match", r, f"n={n} lgB={R.LGB}")
    say(f"experiment resident_match: {n_valid} valid probes, {hits} hits, "
        f"{touched} buckets of {table.shape[0]} ({lines64} 64-byte lines); "
        f"L2 flushed {r['ms']:.4f} ms ({n / r['ms'] / 1e3:.1f} M "
        f"probes/s), L2 warm {warm_ms:.4f} ms "
        f"({n / warm_ms / 1e3:.1f} M probes/s); bounds: flushed "
        f"{r['bound'][0]:.4f}, in 64-byte sectors "
        f"{r['sector_bound_ms']:.4f}, warm {r['warm_bound_ms']:.4f} ms; "
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
                   subsets=(("head", N_CPU_CHECK),), quals1=None):
    """The FASTA (unless given) and the FASTQ files of one workload: all
    reads, and the first n of each named subset; mate 1 with `quals1`
    when given. Returns (fa, files)."""
    os.makedirs(d, exist_ok=True)
    if fa is None:
        fa = os.path.join(d, "genes.fa")
        write_fasta(fa, genes, prefix)
    rp = b"p" if reads2 is not None else b"r"
    files = {}
    for tag, sub in (("all", None),) + tuple(subsets):
        for mate, reads, quals in (("1", reads1, quals1),
                                   ("2", reads2, None)):
            if reads is None:
                continue
            path = os.path.join(d, f"{tag}_{mate}.fq")
            write_fastq(path, reads[:sub], rp,
                        None if quals is None else quals[:sub])
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


def oracle_agrees(name, oracle, got, reads1, reads2=None, quals1=None,
                  minq=0):
    """The first N_ORACLE_CHECK reads' genes equal the oracle's, with the
    reads' qualities (quals1, else 'I' throughout) masked at minq.
    Returns (reads checked, how many of their verdicts the mask
    changes)."""
    from shark_tpu_torch.classify.oracle import classify_read, fuse_pair

    changed = 0
    for i in range(N_ORACLE_CHECK):
        q1 = b"I" * READ_LEN if quals1 is None else quals1[i].tobytes()
        r1 = (f"{i}", reads1[i].tobytes(), q1)
        r2 = None if reads2 is None else (f"{i}", reads2[i].tobytes(),
                                          b"I" * READ_LEN)
        wins, _, _ = classify_read(oracle, fuse_pair(r1, r2, minq), C,
                                   False)
        want = [oracle.gene_names[g] for g in wins]
        need(got.get(i, []) == want,
             f"{name}: read {i}: GPU {got.get(i, [])} != oracle {want}")
        if minq:
            changed += classify_read(oracle, fuse_pair(r1, r2, 0), C,
                                     False)[0] != wins
    return N_ORACLE_CHECK, changed


def say_e2e(name, stats, note):
    rps = stats["n_reads"] / stats["classify_s"]
    say(f"e2e {name}: probe={stats['probe']} reads={stats['n_reads']} "
        f"associations={stats['n_associations']} "
        f"reads_out={stats['n_reads_out']} group_rows={stats['group_rows']} "
        f"classify_s={stats['classify_s']:.3f} reads_per_s={rps:.0f} "
        f"warmup_s={stats['warmup_s']:.2f} index_s={stats['index_s']:.2f} "
        f"wall_s={stats['wall_s']:.2f}; {note}")


def e2e(work, name, genes, prefix, reads1, reads2=None, quals1=None,
        minq=0, note=""):
    """One end-to-end phase on a panel: GPU run, --backend cpu run on the
    first N_CPU_CHECK reads, oracle agreement on the first
    N_ORACLE_CHECK; with -q minq on every run when minq > 0."""
    from shark_tpu_torch.classify.oracle import build_oracle_index

    d = os.path.join(work, name)
    fa, files = write_workload(d, genes, prefix, reads1, reads2,
                               quals1=quals1)
    q = ["-q", str(minq)] if minq else []
    t0 = time.perf_counter()
    stats = run_tag(d, fa, files, "all", "all_gpu", q)
    stats["wall_s"] = time.perf_counter() - t0
    need(stats["n_reads"] == len(reads1), f"{name}: read count {stats}")
    need(stats["probe"] == "hashed", f"{name}: probe {stats['probe']}")
    run_tag(d, fa, files, "head", "head_cpu", ["--backend", "cpu", *q])
    got = same_prefix(d, name, "all_gpu", "head_cpu", N_CPU_CHECK,
                      reads2 is not None)
    need(len(got) > N_CPU_CHECK // 4, f"{name}: only {len(got)} reads emitted")
    oracle = build_oracle_index(
        [(f"{prefix.decode()}{g:05d}", s.tobytes()) for g, s in enumerate(genes)],
        K, BF_GB << 33)
    agree, changed = oracle_agrees(name, oracle, got, reads1, reads2, quals1,
                                   minq)
    if minq:
        need(changed > 0, f"{name}: -q {minq} changes no oracle verdict")
        stats["mask_changed_oracle_verdicts"] = changed
        note = (f" (the mask changes {changed} of their verdicts)" + note)
    say_e2e(name, stats, f"GPU == --backend cpu on {N_CPU_CHECK} reads "
                         f"(ssv, FASTQ); {agree} reads agree with the oracle"
                         + note)
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
    agree, _ = oracle_agrees("txome", _ShimIndex(SharkIndex.load(idx)), got,
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
    del clf
    gc.collect()
    torch.cuda.empty_cache()

    # (i) the replicated index over [cuda:0, cuda:0], --load-index (the xl
    # table cache), on the same reads
    from shark_tpu_torch.parallel.data_parallel import DataParallelClassifier
    from shark_tpu_torch.pipeline import _probe_opts

    cfg = SharkConfig(
        fasta_path=fa, sample1_path=files["classic", "1"], load_index=idx,
        out1_path=os.path.join(d, "replicated_gpu.1.fq"),
        ssv_path=os.path.join(d, "replicated_gpu.ssv"), k=K, c=C, bf_gb=BF_GB)
    t0 = time.perf_counter()
    clf = DataParallelClassifier(
        SharkIndex.load(idx), max_winners=16, c=C,
        devices=[CARD] * 2, probe_opts=_probe_opts(cfg))
    build_s = time.perf_counter() - t0
    kernels.LAUNCHES.reset()
    stats = run_pipeline(cfg, classifier=clf)
    stats["wall_s"] = time.perf_counter() - t0
    launches["i"] = ("xl", kernels.LAUNCHES.snapshot())
    need(stats["probe"] == "xl", f"replicated txome: probe {stats['probe']}")
    need(stats["n_reads"] == N_CLASSIC_READS,
         f"replicated txome: read count {stats}")
    same_prefix(d, "replicated txome", "all_gpu", "replicated_gpu",
                N_CLASSIC_READS, False)
    stats["classifier_build_s"] = build_s
    say_e2e("replicated_txome", stats, "(i) the index replicated over "
            f"[cuda:0, cuda:0] (--load-index, xl table cache; classifier "
            f"built in {build_s:.1f} s); its bytes equal (d)'s on its "
            f"{N_CLASSIC_READS} reads")
    out["replicated_txome"] = stats
    del clf
    gc.collect()
    torch.cuda.empty_cache()
    return out


def e2e_replicated_homolog(work, n_reads, launches):
    """(h) run_pipeline on (b)'s sample with the index replicated over
    [cuda:0, cuda:0]: (b)'s bytes, the hashed path's launches."""
    from shark_tpu_torch import kernels
    from shark_tpu_torch.config import SharkConfig
    from shark_tpu_torch.parallel.data_parallel import DataParallelClassifier
    from shark_tpu_torch.pipeline import load_or_build_index, run_pipeline
    from shark_tpu_torch.utils.timers import PhaseTimer

    d = os.path.join(work, "homolog")
    cfg = SharkConfig(
        fasta_path=os.path.join(d, "genes.fa"),
        sample1_path=os.path.join(d, "all_1.fq"),
        out1_path=os.path.join(d, "replicated_gpu.1.fq"),
        ssv_path=os.path.join(d, "replicated_gpu.ssv"), k=K, c=C, bf_gb=BF_GB)
    t0 = time.perf_counter()
    clf = DataParallelClassifier(
        load_or_build_index(cfg, PhaseTimer()), max_winners=16, c=C,
        devices=[CARD] * 2)
    build_s = time.perf_counter() - t0
    kernels.LAUNCHES.reset()
    stats = run_pipeline(cfg, classifier=clf)
    stats["wall_s"] = time.perf_counter() - t0
    launches["h"] = ("hashed", kernels.LAUNCHES.snapshot())
    need(stats["probe"] == "hashed", f"replicated: probe {stats['probe']}")
    need(stats["n_reads"] == n_reads, f"replicated: read count {stats}")
    need(stats["group_rows"] > 0, "replicated: no group verdicts")
    same_prefix(d, "replicated homolog", "replicated_gpu", "all_gpu", n_reads,
                False)
    stats["classifier_build_s"] = build_s
    say_e2e("replicated_homolog", stats, "(h) the index replicated over "
            f"[cuda:0, cuda:0] (index and classifier built in {build_s:.1f} "
            "s); its bytes equal (b)'s")
    return stats


def e2e_native_backend(work):
    """(j) --backend native through the CLI on the panel's first
    N_CPU_CHECK reads, -t the host's CPU count: (a)'s --backend cpu bytes
    on those reads, and no kernel launch."""
    from shark_tpu_torch import kernels

    d = os.path.join(work, "panel")
    files = {("head", "1"): os.path.join(d, "head_1.fq")}
    n_cpu = os.cpu_count()
    kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    stats = run_tag(d, os.path.join(d, "genes.fa"), files, "head",
                    "head_native", ["--backend", "native", "-t", str(n_cpu)])
    stats["wall_s"] = time.perf_counter() - t0
    counts = kernels.LAUNCHES.snapshot()
    need(not any(counts.values()), f"--backend native launched {counts}")
    need(stats["probe"] == "host", f"native: probe {stats['probe']}")
    need(stats["n_reads"] == N_CPU_CHECK, f"native: read count {stats}")
    same_prefix(d, "native", "head_native", "head_cpu", N_CPU_CHECK, False)
    rps = stats["n_reads"] / stats["classify_s"]
    stats["host_cpus"] = n_cpu
    say(f"e2e native (j): probe=host reads={stats['n_reads']} "
        f"associations={stats['n_associations']} "
        f"classify_s={stats['classify_s']:.3f} reads_per_s={rps:.0f} on "
        f"{n_cpu} host CPUs (-t {n_cpu}) index_s={stats['index_s']:.2f} "
        f"wall_s={stats['wall_s']:.2f}; --backend native, no kernel "
        f"launched; its bytes equal (a)'s --backend cpu run on its "
        f"{N_CPU_CHECK} reads")
    return stats


@functools.lru_cache(maxsize=None)
def fuzz_module():
    """tests/test_torch_fuzz.py, loaded by path: run_seed for (m),
    run_edges for (t)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_fuzz", os.path.join(HERE, "tests", "test_torch_fuzz.py"))
    fuzz = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fuzz)
    return fuzz


def e2e_soak(work, launches):
    """(m) tests/test_torch_fuzz.py's run_seed on cuda:0 for SOAK_SEEDS:
    each seed's random workload through the device path (native engine,
    Python I/O), --backend native, --backend cpu, its extra path and the
    ties pass, every output equal to the oracle's ssv and to the other
    modes' FASTQs, each device run's layout kernels launched. The seeds
    together must cover SOAK_COVERS; their launches go to
    launches["m"]."""
    import traceback

    from shark_tpu_torch import kernels

    fuzz = fuzz_module()
    say("soak (m) seeds: " + " ".join(map(str, SOAK_SEEDS)))
    total = dict.fromkeys(kernels.KERNELS, 0)
    seen = set()
    t_phase = time.perf_counter()
    for seed in SOAK_SEEDS:
        d = os.path.join(work, "soak", str(seed))
        os.makedirs(d)
        t0 = time.perf_counter()
        try:
            r = fuzz.run_seed(d, seed, CARD)
        except Exception as e:
            traceback.print_exc()
            raise SmokeFailure(f"soak (m): seed {seed}: {type(e).__name__}: "
                               f"{e}") from e
        shutil.rmtree(d)
        for name, n in r["launches"].items():
            total[name] += n
        extra = "+".join(r["extras"]) or "none"
        seen |= {r["layout"], *r["extras"]}
        seen |= {tag for tag, on in (("reprobe", r["reprobe"]),
                                     ("paired", r["paired"]),
                                     ("gz", r["gz"]),
                                     ("minq10", r["minq"] == 10),
                                     ("tie_pairs", r["tie_pairs"]),
                                     ("groups", r["group_rows"])) if on}
        say(f"soak (m) seed {seed}: ok layout={r['layout']} extra={extra} "
            f"reprobe={'yes' if r['reprobe'] else 'no'} k={r['k']} "
            f"paired={int(r['paired'])} gz={int(r['gz'])} minq={r['minq']} "
            f"reads={r['n_reads']} assoc={r['associations']} "
            f"ties: K4 {r['tie_pairs']} group_rows {r['group_rows']} "
            f"({time.perf_counter() - t0:.1f} s)")
        gc.collect()
        torch.cuda.empty_cache()
    missing = [c for c in SOAK_COVERS if c not in seen]
    need(not missing, f"soak (m): the seeds cover none of {missing}")
    launches["m"] = ("soak", total)
    secs = time.perf_counter() - t_phase
    say(f"soak (m): {len(SOAK_SEEDS)} seeds, 0 differences, {secs:.1f} s; "
        f"each equals the oracle's ssv and the other modes' FASTQs through "
        f"the native engine, the Python I/O, --backend native, --backend "
        f"cpu, its extra path and the ties pass, each device run launching "
        f"its layout's kernels")
    return {"seeds": list(SOAK_SEEDS), "seconds": secs}


def e2e_bench_gpu(work, n_reads=N_BENCH_READS, timeout_s=180):
    """(o) bench_gpu.py --workload panel in a process of its own, its read
    count trimmed to `n_reads` (and its pairs, which the panel does not
    run, to 1000) and its files under `work`: a wiring check of the port's
    bench on the card (its comparator build and passes, --backend native,
    the device-only batch, the gather ceiling, the re-visit on the saved
    index and its probe-table cache). Its line must hold panel_exact
    true."""
    cache = os.path.join(work, "bench_gpu")
    code = ("import sys, bench_gpu as b; b.CACHE = sys.argv[1]; "
            "b.N_READS = int(sys.argv[2]); b.N_PAIRS = 1000; "
            "sys.exit(b.main(['--workload', 'panel']))")
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    t0 = time.perf_counter()
    try:
        p = subprocess.run([sys.executable, "-c", code, cache, str(n_reads)],
                           cwd=HERE, env=env, capture_output=True, text=True,
                           timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        raise SmokeFailure(f"bench_gpu (o): no line in {timeout_s} s") from e
    secs = time.perf_counter() - t0
    lines = p.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1])
    except (IndexError, ValueError):
        line = None
    if p.returncode != 0 or not line or line.get("panel_exact") is not True:
        sys.stderr.write(p.stderr[-4000:])
        raise SmokeFailure(f"bench_gpu (o): exit {p.returncode}, line "
                           f"{lines[-1] if lines else None}")
    need(line.get("native_cpu_exact") is True,
         f"bench_gpu (o): --backend native inexact: {line}")
    shutil.rmtree(cache, ignore_errors=True)
    say(f"bench_gpu (o): {n_reads} panel reads in {secs:.1f} s, exit 0, "
        f"panel_exact true; its line: {json.dumps(line)}")
    return {"seconds": secs, "line": line}


def e2e_profile_split(work, n_reads=N_BENCH_READS, timeout_s=240):
    """(p) scripts/profile_e2e_torch.py --workload panel at `n_reads` in a
    process of its own, its files under `work`: the serial pass's stages
    must add up to within 5% of its total, its bytes must equal the
    overlapped passes', and the serial pass must launch the panel path's
    kernels (its launches are its own process's). Prints the split."""
    cmd = [sys.executable, os.path.join(HERE, "scripts",
                                        "profile_e2e_torch.py"),
           "--workload", "panel", "--reads", str(n_reads), "--cache",
           os.path.join(work, "profile_e2e")]
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                           text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        raise SmokeFailure(f"profile split (p): no line in {timeout_s} s") \
            from e
    secs = time.perf_counter() - t0
    lines = p.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1])
    except (IndexError, ValueError):
        line = None
    if p.returncode != 0 or not line or line.get("bytes_equal") is not True:
        sys.stderr.write(p.stderr[-4000:])
        raise SmokeFailure(f"profile split (p): exit {p.returncode}, line "
                           f"{lines[-1] if lines else None}")
    total, stages = line["serial_total_s"], line["stages_s"]
    need(abs(sum(stages.values()) - total) <= 0.05 * total,
         f"profile split (p): stages {stages} do not add up to {total} s")
    launched = line["launches"]["serial"]
    need(all(launched.get(k, 0) > 0 for k in PATH_KERNELS["panel"]),
         f"profile split (p): the serial pass launched {launched}")
    shutil.rmtree(os.path.join(work, "profile_e2e"), ignore_errors=True)
    say(f"profile split (p): panel, {line['reads']} reads in "
        f"{line['batches']} batches, serial {total:.4f} s = " + " + ".join(
            f"{k} {v:.4f}" for k, v in stages.items())
        + f" s (synchronised at stage boundaries); overlapped classify_s "
        f"{line['overlapped_classify_s']}; card busy "
        f"{line['trace']['kernel_busy_ms']:.2f} ms of its profiled pass; "
        f"bytes equal; {secs:.1f} s")
    return {"seconds": secs, "line": line}


def e2e_ab_harnesses(work, gathers, n_reads=N_BENCH_READS, timeout_s=120):
    """(q) scripts/repro_contamination_torch.py and
    scripts/ab_layout_torch.py --below 1 --slots 8 4 --no-entry8 at
    `n_reads`, one process each, one cache under `work` (the phase's
    module docstring), and the bare gathers' new widths against their
    plain versions."""
    cache = os.path.join(work, "ab_q")
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    t0 = time.perf_counter()
    lines = {}
    for name, extra in (
            ("repro_contamination_torch", []),
            ("ab_layout_torch", ["--below", "1", "--slots", "8", "4",
                                 "--no-entry8", "--batches", "2", "--reps",
                                 "3"])):
        cmd = [sys.executable, os.path.join(HERE, "scripts", f"{name}.py"),
               "--reads", str(n_reads), "--cache", cache, *extra]
        try:
            p = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                               text=True, timeout=timeout_s)
        except subprocess.TimeoutExpired as e:
            raise SmokeFailure(f"(q) {name}: no line in {timeout_s} s") from e
        out = p.stdout.strip().splitlines()
        try:
            lines[name] = json.loads(out[-1])
        except (IndexError, ValueError):
            lines[name] = None
        if p.returncode != 0 or not lines[name]:
            sys.stderr.write(p.stderr[-4000:])
            raise SmokeFailure(f"(q) {name}: exit {p.returncode}, line "
                               f"{out[-1] if out else None}")
    repro, layout = (lines["repro_contamination_torch"],
                     lines["ab_layout_torch"])
    need(repro["bytes_equal"] is True, f"(q) repro: bytes differ: {repro}")
    rps = repro["reads_per_sec_best"]
    say(f"(q) repro_contamination: homolog {n_reads} reads, best reads/s "
        f"before {rps['before']:.1f}, after the panel stage "
        f"{rps['after']:.1f}, after gc {rps['after-gc']:.1f}, after sync "
        f"{rps['after-sync']:.1f}; serial s {repro['serial_total_s']}; "
        f"diagnostics that moved {json.dumps(repro['moved'])}; bytes equal")
    built = [r for r in layout["rows"] if r["buildable"]]
    need(layout["verdicts_equal"] and all(
        r["verdicts_equal"] and r["probe_equal_plain"] for r in built),
        f"(q) ab_layout: a probe or verdict differs: {layout['rows']}")
    need(len(built) >= 3, f"(q) ab_layout: {len(built)} layouts built")
    say("(q) ab_layout: natural lgB " + str(layout["natural_lgB"]) + "; "
        + "; ".join(
            f"{r['name']} {r['table_mb']:g} MB stash {r['stash_real']}"
            + (f" probe {r['probe_device_ms']:.4f} ms device ({r['route']})"
               if r.get("probe_device_ms") else "")
            if r["buildable"] else f"{r['name']}: {r['why']}"
            for r in layout["rows"]) + "; every verdict equal")
    g = torch.Generator(device="cuda")
    g.manual_seed(14)
    table = torch.empty(16 << 20, dtype=torch.int32,
                        device="cuda").random_(generator=g)
    for row_bytes in (4, 64, 128):
        idx = torch.randint(0, table.numel() * 4 // row_bytes, (1 << 20,),
                            generator=g, device="cuda", dtype=torch.int32)
        same(f"gather_rows{row_bytes}", [gathers.rows(table, idx, row_bytes)],
             [gathers.rows_plain(table, idx, row_bytes)])
    del table
    shutil.rmtree(cache, ignore_errors=True)
    secs = time.perf_counter() - t0
    say(f"(q) the A/B harnesses and the new gather widths: {secs:.1f} s")
    return {"seconds": secs, "repro": repro, "layout": layout}


def stage_ladder(rungs, order, key="device_ms"):
    """'name ms' of each rung of a ladder that has a reading."""
    return ", ".join(f"{r} {rungs[r][key]:.4f}" for r in order
                     if rungs.get(r, {}).get(key) is not None)


def script_lines(phase, runs, timeout_s):
    """The JSON lines of scripts/<name>.py's main(argv) for each (name,
    argv) of `runs`, run one after another in one process of their own
    (one CUDA start-up) with a time limit; raises SmokeFailure unless the
    process exits 0 with one line a run and every check of every line
    held."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    code = (
        "import importlib.util, sys\n"
        "rcs = []\n"
        f"for name, argv in {runs!r}:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, f'scripts/{name}.py')\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    rcs.append(mod.main(argv))\n"
        "    sys.stdout.flush()\n"
        "sys.exit(max(rcs))\n")
    try:
        p = subprocess.run([sys.executable, "-c", code], cwd=HERE, env=env,
                           capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        raise SmokeFailure(f"{phase}: no end in {timeout_s} s") from e
    lines = []
    for text in p.stdout.splitlines():
        try:
            lines.append(json.loads(text))
        except ValueError:
            continue
    bad = [[k for k, v in line.get("checks", {}).items() if v is not True]
           for line in lines]
    if (p.returncode != 0 or len(lines) != len(runs) or any(bad)
            or not all(line.get("checks") for line in lines)):
        sys.stderr.write(p.stderr[-4000:])
        raise SmokeFailure(f"{phase}: exit {p.returncode}, {len(lines)} "
                           f"lines of {len(runs)}, checks failed {bad}")
    return lines


def e2e_stage_profiles(work, n_reads=STAGE_READS, timeout_s=300):
    """(r) scripts/profile_front_torch.py (the panel's first batch),
    profile_finish_torch.py (the panel's and the homolog's), both with the
    L2 warm only, and ab_fixcap_torch.py (the homolog's) at `n_reads`, one
    cache under `work` (script_lines). Prints each ladder's rung ms on one
    line."""
    cache = os.path.join(work, "stage_r")
    common = ["--reads", str(n_reads), "--cache", cache, "--reps", "3"]
    runs = (("profile_front_torch", ["--workload", "panel", "--warm-only",
                                     *common]),
            ("profile_finish_torch", ["--warm-only", *common]),
            ("ab_fixcap_torch", common))
    t0 = time.perf_counter()
    lines = dict(zip((name for name, _ in runs),
                     script_lines("(r)", runs, timeout_s)))
    front = lines["profile_front_torch"]
    say(f"(r) K1 ladder, {front['workload']} B={front['batch_size']} "
        f"L={front['max_read_len']} (device ms, L2 warm): "
        + stage_ladder(front["rungs"], ("s", "d", "c", "h", "m", "m2", "l"))
        + f"; furthest above its bound: {front['furthest']}; long reads "
        f"{front['long_reads']['device_ms']:.4f}")
    for wl, fin in lines["profile_finish_torch"]["workloads"].items():
        say(f"(r) K3 ladder, {wl} (warp pass device ms, L2 warm): "
            + stage_ladder(fin["rungs"], ("k", "s", "c", "f", "a1",
                                          "sort-always", "a5"), "warp_ms")
            + f"; whole K3 f {fin['rungs']['f']['device_ms']:.4f}, f0 (K1 + "
            f"K2) {fin['f0']['device_ms']:.4f}, group pass "
            + (f"{fin['rungs']['g']['device_ms']:.4f}" if "g" in fin["rungs"]
               else "not run")
            + f"; torch.sort {fin['sort_library']['device_ms']:.4f}; "
            f"furthest above its bound: {fin['furthest']}; shares "
            f"{json.dumps(fin['shares'])}")
    fix = lines["ab_fixcap_torch"]
    for batch in fix["batches"]:
        say(f"(r) FIX_CAP2 A/B, homolog batch {batch['batch']} (impure "
            f"{batch['impure']}): " + "; ".join(
                f"cap {r['fix_cap2']} {r['branch']} K3 "
                f"{r['k3_device_ms']:.4f} K4 {r['k4_device_ms']:.4f} ms, "
                f"{r['pairs']} pairs, winner_pairs {r['winner_pairs_ms']:.2f}"
                f" ms, {r['associations']} associations"
                for r in batch["caps"]))
    shutil.rmtree(cache, ignore_errors=True)
    secs = time.perf_counter() - t0
    say(f"(r) the stage profilers and the FIX_CAP2 A/B: every check held; "
        f"{secs:.1f} s")
    return {"seconds": secs, **lines}


def e2e_probe_profiles(work, n_reads=STAGE_READS, timeout_s=300):
    """(s) scripts/profile_probe_torch.py on the panel's first batch with
    its classic/hashed A/B (--ab) and on the homolog's,
    profile_txome_torch.py (--quick: no XL_SLOTS = 2 build) and
    sort_bench_torch.py, all with the L2 warm only, at `n_reads`, one
    cache under `work` (script_lines). Prints each ladder's rung ms on one
    line."""
    cache = os.path.join(work, "stage_s")
    common = ["--reads", str(n_reads), "--cache", cache, "--reps", "3",
              "--warm-only"]
    runs = (("profile_probe_torch", ["--ab", *common]),
            ("profile_probe_torch", ["--workload", "homolog", *common]),
            ("profile_txome_torch", ["--quick", *common]),
            ("sort_bench_torch", common))
    t0 = time.perf_counter()
    lines = script_lines("(s)", runs, timeout_s)
    panel, homolog, txome, sort = lines
    for k2 in (panel, homolog):
        an, c = k2["anchors"], k2["counts"]
        say(f"(s) K2 ladder, {k2['workload']} B={k2['batch_size']} "
            f"L={k2['max_read_len']} (device ms, L2 warm): "
            + stage_ladder(k2["rungs"], ("w", "b", "m", "p"))
            + f"; furthest above its bound: {k2['furthest']}; P2 "
            f"{an['resident_match']['device_ms']:.4f}, gather"
            f"{an['gather']['row_bytes']} {an['gather']['device_ms']:.4f}, "
            f"K1 {an['front']['device_ms']:.4f}; two-lane windows "
            f"{c['two_lane_windows']}, stash windows {c['stash_windows']}, "
            f"stash rows {c['stash_rows']} of {c['stash_rows_padded']}")
    say("(s) classic/hashed A/B, panel (ms a batch with the fetch; device "
        "ms, host ms a batch): " + "; ".join(
            f"{name} {r['ms_a_batch']:.3f}; {r['device_ms_a_batch']:.4f}, "
            f"{r['host_ms_a_batch']:.4f}"
            for name, r in panel["ab"]["setups"].items())
        + "; verdicts equal")
    xl, k5 = txome["xl"], txome["classic"]
    an = txome["anchors"]
    say(f"(s) K6 ladder, txome {txome['genes']} genes (device ms, L2 warm): "
        + stage_ladder(xl["rungs"], ("g", "x", "s"))
        + f"; furthest: {xl['furthest']}; gather16 "
        f"{an['gather16']['device_ms']:.4f}, K1 {an['front']['device_ms']:.4f}"
        f"; side windows {xl['counts']['side_windows']}, flagged share "
        f"{xl['counts']['flagged_share']:.4f}")
    say("(s) K5 ladder, txome (device ms, L2 warm): "
        + stage_ladder(k5["rungs"], ("r", "y"))
        + f"; furthest: {k5['furthest']}; two-level gather "
        f"{an['two_level']['device_ms']:.4f}, 8-byte words "
        f"{an['gather8_words']['device_ms']:.4f}; call_packed xl "
        f"{txome['whole_step']['xl']['device_ms']:.4f}, classic "
        f"{txome['whole_step']['classic']['device_ms']:.4f}")
    say("(s) sort bench (device ms, L2 warm): " + ", ".join(
        f"{k} {v['device_ms']:.4f}" for k, v in sort["pieces"].items())
        + f"; dedup_ms {sort['dedup_ms']:.4f} = "
        f"{sort['dedup_over_gather_full']:.2f}x the full gather, "
        f"{sort['dedup_over_k2']:.2f}x K2 "
        f"({sort['panel_k2']['device_ms']:.4f})")
    shutil.rmtree(cache, ignore_errors=True)
    secs = time.perf_counter() - t0
    say(f"(s) the probe stage profilers, the A/B and the sort bench: every "
        f"check held; {secs:.1f} s")
    return {"seconds": secs, "probe_panel": panel, "probe_homolog": homolog,
            "txome": txome, "sort": sort}


def front_block_reads(L: int, optin: int):
    """Reads a block of K1 takes at L and its shared memory: csrc/front.cu's
    front_smem and its halving (32 reads, halved until the block fits the
    opt-in limit); past kMaxShortL the long-read kernel, one read a block
    and no shared table."""
    if L > FRONT_MAX_SHORT_L:
        return 1, 0
    words = ((L + 31) >> 5) + 2

    def smem(reads):
        return (((reads * (L >> 2) + 15) & ~15)
                + ((reads * (L >> 3) + 15) & ~15) + 8 * words * 20
                + 32 * words * 4)

    reads = 32
    if smem(reads) > 48 * 1024:
        while reads > 1 and smem(reads) > optin:
            reads >>= 1
    return reads, smem(reads)


def long_codes(rng, genes, B, L):
    """Byte codes [B, L] of reads of L/2 to L bases (the first L), each
    pieces of random genes on random strands (a quarter of the reads all of
    one gene), 1% N; invalid padding."""
    from shark_tpu_torch.ops.kmers import BYTE_TO_CODE

    codes = np.full((B, L), 4, np.uint8)
    lens = rng.integers(L // 2, L + 1, size=B)
    lens[0] = L
    for b in range(B):
        one = rng.random() < 0.25
        g0 = int(rng.integers(0, len(genes)))
        parts, n = [], 0
        while n < lens[b]:
            g = genes[g0 if one else int(rng.integers(0, len(genes)))]
            m = int(rng.integers(100, len(g) + 1))
            s = int(rng.integers(0, len(g) - m + 1))
            piece = g[s:s + m]
            parts.append(COMP[piece[::-1]] if rng.random() < 0.5 else piece)
            n += m
        codes[b, :lens[b]] = BYTE_TO_CODE[np.concatenate(parts)[:lens[b]]]
    codes[rng.random((B, L)) < 0.01] = 4
    return codes


def check_long_kernels(hindex, hgenes, tx_idx, tgenes):
    """(t) K1 -> K2 -> K3 -> K4 on the homolog index, and K1 -> K6 and
    K1 -> K5 on the transcriptome's (the index (d) saved, its xl tables
    from (d)'s cache), each against its plain version (exact) at the
    lengths LONG_LS, B = 64 (8 from 16384 on); K3 and K4 at
    max_winners 16, 2 and 1. One line an L, with the reads a block of K1
    took there. Returns {L: line fields}."""
    from shark_tpu_torch import kernels
    from shark_tpu_torch.classify import hashed, step
    from shark_tpu_torch.classify.step import Classifier
    from shark_tpu_torch.index.structure import SharkIndex

    optin = kernels.lib().shkk_max_smem_optin()
    hclf = Classifier(hindex, max_winners=16, c=C)
    tindex = SharkIndex.load(tx_idx)
    xclf = Classifier(tindex, max_winners=16, c=C,
                      probe_opts={"cache_dir": tx_idx + ".tables"})
    need(xclf.probe == "xl", f"(t) transcriptome: probe {xclf.probe}")
    cclf = Classifier(tindex, max_winners=16, c=C, probe="classic")
    rng = np.random.default_rng(2031)
    out = {}
    for L in LONG_LS:
        B = 8 if L >= FRONT_MAX_SHORT_L else 64
        reads, smem = front_block_reads(L, optin)
        line = {"B": B, "front_reads_a_block": reads, "front_smem": smem}
        for name, clf, genes in (("homolog", hclf, hgenes),
                                 ("txome", xclf, tgenes)):
            meta, thresh = clf._geometry(L)
            codes = torch.from_numpy(long_codes(rng, genes, B, L)).to(CARD)
            packed, vmask = step.pack_codes(codes)
            k1 = step.front_end(packed, vmask, meta)
            same(f"(t) front_end L={L} {name}", k1,
                 step.front_end_plain(packed, vmask, meta))
            idx_hi, idx_lo, win_valid, length = k1
            need(bool(win_valid[0].any()), f"(t) L={L}: no valid window")
            if name == "txome":
                args6 = (idx_hi, idx_lo, win_valid, xclf.dix.table,
                         xclf.dix.side, xclf.dix.side_stash, xclf._hmeta)
                k6 = hashed.probe_xl(*args6)
                same(f"(t) probe_xl L={L}", k6,
                     hashed.probe_xl_plain(*args6))
                cdix = cclf.dix
                args5 = (idx_hi, idx_lo, win_valid, cdix.bf_rank, cdix.pay)
                same(f"(t) probe_tags L={L}", step.probe_tags(*args5),
                     step.probe_tags_plain(*args5))
                line["txome_hits"] = int((k6[0] != 0).sum())
                continue
            dix, hmeta = clf.dix, clf._hmeta
            args2 = (idx_hi, idx_lo, win_valid, dix.table, dix.stash, hmeta)
            tagv, payv = hashed.probe_hashed(*args2, dix.stash_rows)
            same(f"(t) probe_hashed L={L}", (tagv, payv),
                 hashed.probe_hashed_plain(*args2))
            for W in (16, 2, 1):
                kw3 = dict(rows3=dix.rows3, ext_mat=dix.ext_mat, meta=meta,
                           max_winners=W, L=L, has_rows=hmeta.has_rows)
                args3 = (tagv, payv, length, thresh)
                k3 = step.finish_from_tags(*args3, **kw3)
                n_block = step.finish_heavy_count()
                same(f"(t) finish_from_tags L={L} W={W}", k3[:3],
                     step.finish_from_tags_plain(*args3, **kw3)[:3])
                cap, total = pair_cap(k3[0], B, W)
                same(f"(t) extract_pairs L={L} W={W}",
                     [step.extract_pairs(k3[0], k3[1], cap)],
                     [step.extract_pairs_plain(k3[0], k3[1], cap)])
                nw = (k3[0].to(torch.int64) >> 16) & 31
                line[f"W{W}"] = {"block_reads": n_block, "pairs": total,
                                 "over_W": int((nw > W).sum())}
        say(f"(t) kernels at L={L} B={B}: K1 (front_end, {reads} reads a "
            f"block, {smem} B shared), K2, K3 and K4 (max_winners 16, 2, "
            f"1) on the homolog index, K6 and K5 on the transcriptome's, "
            f"each equal to its plain version; {json.dumps(line)}")
        out[L] = line
    del hclf, xclf, cclf, tindex
    gc.collect()
    torch.cuda.empty_cache()
    return out


def e2e_edge_seeds(work, launches):
    """(t) tests/test_torch_fuzz.py's run_edges on cuda:0 for EDGE_SEEDS
    (the CLI's Bloom size): reads of 90 to 20000 bases, mates from the
    gene, --max-read-len auto, rounded and not a multiple of 8, -s,
    max_winners 1, 2 and 16 on the ties pass, batches of 32 and 8192, every
    output equal to the oracle's and to the other modes' FASTQs, each
    device run's layout kernels launched. The seeds together must cover
    EDGE_COVERS; their launches go to launches["t"]."""
    import traceback

    from shark_tpu_torch import kernels

    fuzz = fuzz_module()
    total = dict.fromkeys(kernels.KERNELS, 0)
    seen = set()
    t0 = time.perf_counter()
    for seed in EDGE_SEEDS:
        d = os.path.join(work, "edges", str(seed))
        os.makedirs(d)
        t_seed = time.perf_counter()
        try:
            r = fuzz.run_edges(d, seed, CARD)
        except Exception as e:
            traceback.print_exc()
            raise SmokeFailure(f"(t) edge seed {seed}: {type(e).__name__}: "
                               f"{e}") from e
        shutil.rmtree(d)
        for name, n in r["launches"].items():
            total[name] += n
        seen |= fuzz.edge_covers(r)
        say(f"(t) edge seed {seed}: ok band={r['band']} "
            f"longest={r['longest']} L={r['L']} lens={r['lens']} "
            f"max_read_len={r['max_read_len']} engine={r['engine']} "
            f"packed={r['packed']} single={r['single']} "
            f"W={r['max_winners']} B={r['batch_size']} layout={r['layout']} "
            f"paired={r['paired']} pair_emits={r['pair_emits']} "
            f"host_rows={r['host_rows']} group_rows={r['group_rows']} "
            f"reads={r['n_reads']} assoc={r['associations']} "
            f"({time.perf_counter() - t_seed:.1f} s)")
        gc.collect()
        torch.cuda.empty_cache()
    missing = [c for c in EDGE_COVERS if c not in seen]
    need(not missing, f"(t) the edge seeds cover none of {missing}")
    launches["t"] = ("edges", total)
    return {"seeds": list(EDGE_SEEDS), "covers": sorted(seen),
            "seconds": time.perf_counter() - t0}


def e2e_table_cache(work, launches):
    """(t) the probe-table cache on the card, for the hashed layout (auto
    on a 200-gene panel) and the xl layout (--probe xl): a --save-index
    run, then --load-index (a) with one byte of the cached table flipped,
    which the crc check must reject, and (b) with the cache slot holding
    the tables of another FASTA, which the digest must reject; both
    rebuild and re-save the tables and write the fresh run's bytes."""
    import contextlib
    import io

    from shark_tpu_torch import kernels
    from shark_tpu_torch.classify import table_cache
    from shark_tpu_torch.index.structure import SharkIndex

    rng = np.random.default_rng(2032)
    genes = {tag: panel_genes(rng, n_genes=200) for tag in ("a", "b")}
    reads = panel_reads(rng, genes["a"], 20_000)
    out = {}
    for layout, flags in (("hashed", []), ("xl", ["--probe", "xl"])):
        d = os.path.join(work, "table_cache", layout)
        fa, files = write_workload(d, genes["a"], b"A", reads, subsets=())
        fb = os.path.join(d, "other.fa")
        write_fasta(fb, genes["b"], b"B")
        idx, other = os.path.join(d, "index"), os.path.join(d, "other")
        kernels.LAUNCHES.reset()
        fresh = run_tag(d, fa, files, "all", "fresh",
                        ["--save-index", idx, *flags])
        run_cli(["-r", fb, "-1", files["all", "1"],
                 "-o", os.path.join(d, "other.1.fq"),
                 "--ssv", os.path.join(d, "other.ssv"), "-k", str(K),
                 "--save-index", other, *flags])
        table_cache.join_pending()
        launches[f"t-cache-{layout}"] = (
            "panel" if layout == "hashed" else "xl",
            kernels.LAUNCHES.snapshot())
        need(fresh["probe"] == layout, f"(t) cache: probe {fresh['probe']}")
        index = SharkIndex.load(idx)
        probe = None if layout == "hashed" else "xl"
        cache = idx + ".tables"
        need(table_cache.load_tables(cache, index, probe) is not None,
             f"(t) cache {layout}: the saved tables do not load")
        with open(os.path.join(d, "fresh.ssv"), "rb") as f:
            want = f.read()
        for case in ("flipped", "other"):
            if case == "flipped":
                path = os.path.join(cache, "table.npy")
                with open(path, "r+b") as f:
                    f.seek(os.path.getsize(path) // 2)
                    b = f.read(1)
                    f.seek(-1, os.SEEK_CUR)
                    f.write(bytes([b[0] ^ 0xFF]))
            else:
                shutil.rmtree(cache)
                shutil.copytree(other + ".tables", cache)
                with open(os.path.join(cache, "meta.json")) as f:
                    key = json.load(f)["key"]
                need(key["digest"] != table_cache.index_digest(index),
                     f"(t) cache {layout}: the other FASTA's digest matches")
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                need(table_cache.load_tables(cache, index, probe) is None,
                     f"(t) cache {layout} {case}: the damaged cache loads")
            need(case == "other" or "corrupt" in err.getvalue(),
                 f"(t) cache {layout}: no crc rejection ({err.getvalue()})")
            stats = run_tag(d, fa, files, "all", case,
                            ["--load-index", idx, *flags])
            table_cache.join_pending()
            need(stats["probe"] == layout, f"(t) cache {case}: {stats}")
            for ext in ("ssv", "1.fq"):
                with open(os.path.join(d, f"{case}.{ext}"), "rb") as f, \
                        open(os.path.join(d, f"fresh.{ext}"), "rb") as g:
                    need(f.read() == g.read(),
                         f"(t) cache {layout} {case}: {ext} differs from "
                         "the fresh run's")
            need(table_cache.load_tables(cache, index, probe) is not None,
                 f"(t) cache {layout} {case}: the tables were not re-saved")
        out[layout] = {"associations": want.count(b"\n"),
                       "reads": len(reads)}
        shutil.rmtree(d)
    say(f"(t) table cache on the card: hashed and xl, a flipped byte "
        f"(crc) and another FASTA's tables (digest) each rejected, rebuilt, "
        f"re-saved, the fresh run's bytes; {json.dumps(out)}")
    return out


def e2e_edges(work, hindex, hgenes, tx_idx, tgenes, launches):
    """(t): the kernels at long L, EDGE_SEEDS of the edge pass, and the
    damaged table cache."""
    t0 = time.perf_counter()
    kern = check_long_kernels(hindex, hgenes, tx_idx, tgenes)
    t1 = time.perf_counter()
    seeds = e2e_edge_seeds(work, launches)
    t2 = time.perf_counter()
    cache = e2e_table_cache(work, launches)
    secs = time.perf_counter() - t0
    say(f"(t) the edges: kernels at L = {list(LONG_LS)} in {t1 - t0:.1f} s, "
        f"{len(EDGE_SEEDS)} edge seeds in {t2 - t1:.1f} s (covering "
        f"{' '.join(seeds['covers'])}), the table cache in "
        f"{time.perf_counter() - t2:.1f} s; {secs:.1f} s")
    return {"seconds": secs, "kernels": kern, "seeds": seeds,
            "table_cache": cache}


def trace_busy(trace_dir):
    """(k)'s reading of its one trace, through shark_tpu_torch/utils/
    trace.py (what scripts/trace_report_torch.py prints): the card's busy
    share, the union of its kernel records (and of kernels, copies and
    memsets) over the window from the first kernel's start to the last
    kernel's end; and, for each host thread, the union of its torch
    operators and of its CUDA runtime calls, with the calls that took
    longest."""
    from shark_tpu_torch.utils import trace

    names = trace.trace_files(trace_dir)
    need(len(names) == 1, f"profile: trace files {names}")
    busy = trace.summarize(names[0])
    need(busy["kernels"], "profile: the trace holds no CUDA kernel record")
    return busy


def e2e_profiled_panel(work, n_reads, want, launches, keep=""):
    """(k) (a) again with --profile-dir: a trace, (a)'s bytes and (a)'s
    launch counts; the card's busy share over the classify window, and
    the host threads' torch and CUDA runtime time. The trace is copied
    into `keep` when given."""
    from shark_tpu_torch import kernels

    d = os.path.join(work, "panel")
    files = {("all", "1"): os.path.join(d, "all_1.fq")}
    trace_dir = os.path.join(d, "trace")
    kernels.LAUNCHES.reset()
    t0 = time.perf_counter()
    stats = run_tag(d, os.path.join(d, "genes.fa"), files, "all",
                    "all_prof", ["--profile-dir", trace_dir])
    stats["wall_s"] = time.perf_counter() - t0
    counts = kernels.LAUNCHES.snapshot()
    launches["k"] = ("panel", counts)
    need(counts == want, f"profiled: launches {counts} != (a)'s {want}")
    need(stats["n_reads"] == n_reads, f"profiled: read count {stats}")
    same_prefix(d, "profiled", "all_prof", "all_gpu", n_reads, False)
    busy = trace_busy(trace_dir)
    stats["trace"] = busy
    if keep:
        os.makedirs(keep, exist_ok=True)
        shutil.copy(os.path.join(trace_dir, busy["trace"]),
                    os.path.join(keep, "panel_k.pt.trace.json"))
    say_e2e("profiled_panel", stats, "(k) --profile-dir; its bytes and "
            "launch counts equal (a)'s")
    cls_ms = stats["classify_s"] * 1e3
    say(f"card busy share (k), panel (a) under --profile-dir: kernels "
        f"{100 * busy['kernel_busy_ms'] / busy['window_ms']:.2f}% of the "
        f"{busy['window_ms']:.1f} ms from the first kernel's start to the "
        f"last kernel's end ({busy['kernels']} kernel records, "
        f"{busy['kernel_busy_ms']:.2f} ms busy; with copies and memsets "
        f"{100 * busy['device_busy_ms'] / busy['window_ms']:.2f}%); "
        f"kernels {100 * busy['kernel_busy_ms'] / cls_ms:.2f}% of "
        f"classify_s ({cls_ms:.1f} ms); trace {busy['trace_mb']:.1f} MB")
    for tid, h in busy["host"].items():
        if not h["ops_ms"]:
            continue  # a thread that only waits on the card (the drain)
        say(f"trace host thread {tid} (k): torch operators "
            f"{h['ops_ms']:.1f} ms, CUDA runtime {h['runtime_ms']:.1f} ms "
            f"(longest: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                     h["top_runtime_ms"].items()) + ")")
    return stats


def e2e_multihost(work, n_pairs, timeout_s=300):
    """(l) (c)'s paired sample split at a pair boundary into two halves,
    two CLI processes at once on cuda:0 (--coordinator localhost:<free
    port> --num-hosts 2 --host-id 0|1, torch.distributed over gloo), each
    with a timeout: their parts merged in host order are (c)'s bytes."""
    import socket

    from shark_tpu_torch.parallel.distributed import (
        host_suffixed,
        merge_outputs,
    )

    d = os.path.join(work, "paired")
    half = n_pairs // 2
    mates = {}
    for mate in ("1", "2"):
        with open(os.path.join(d, f"all_{mate}.fq"), "rb") as f:
            lines = f.read().splitlines(True)
        need(len(lines) == 4 * n_pairs, f"multihost: mate {mate} records")
        for h, part in enumerate((lines[:4 * half], lines[4 * half:])):
            path = os.path.join(d, f"host{h}_{mate}.fq")
            with open(path, "wb") as f:
                f.write(b"".join(part))
            mates[h, mate] = path
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = os.path.join(d, "multihost")
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for h in range(2):
            log = open(f"{out}.log.{h}", "wb")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "shark_tpu_torch", "-r",
                 os.path.join(d, "genes.fa"), "-1", mates[h, "1"], "-2",
                 mates[h, "2"], "-o", f"{out}.1.fq", "-p", f"{out}.2.fq",
                 "--ssv", f"{out}.ssv", "-k", str(K), "-c", str(C), "-b",
                 str(BF_GB), "--stats-json", f"{out}.json", "--coordinator",
                 f"localhost:{port}", "--num-hosts", "2", "--host-id", str(h)],
                stdout=log, stderr=subprocess.STDOUT, cwd=d, env=env))
        for h, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(1.0, timeout_s
                                        - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                with open(f"{out}.log.{h}", "rb") as f:
                    tail = f.read()[-2000:].decode(errors="replace")
                raise SmokeFailure(f"multihost: host {h} exited {rc}:\n{tail}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    wall_s = time.perf_counter() - t0
    for ext in (".ssv", ".1.fq", ".2.fq"):
        merge_outputs([host_suffixed(out + ext, h) for h in range(2)],
                      out + ext)
    same_prefix(d, "multihost", "multihost", "all_gpu", n_pairs, True)
    hosts = []
    for h in range(2):
        with open(host_suffixed(f"{out}.json", h)) as f:
            hosts.append(json.load(f))
        need(hosts[-1]["probe"] == "hashed" and hosts[-1]["n_reads"] == (
            half if h == 0 else n_pairs - half), f"multihost: host {h} "
             f"stats {hosts[-1]}")
    say(f"e2e multihost (l): 2 processes on cuda:0, {half} + "
        f"{n_pairs - half} pairs, wall {wall_s:.1f} s (both started to both "
        f"done), classify_s " + " / ".join(
            f"{x['classify_s']:.3f}" for x in hosts)
        + "; the merged parts equal (c)'s bytes (ssv, both FASTQs)")
    return {"wall_s": wall_s, "hosts": hosts}


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

    # 2. build: g++ and the 16-byte gather's nvcc in threads while the
    # kernels' nvcc processes run
    gpp = {}

    def build_native():
        try:
            gpp["s"] = native.rebuild()
        except RuntimeError as e:
            gpp["err"] = e

    def build_floor():
        try:
            gpp["gathers"] = Gathers()
        except RuntimeError as e:
            gpp["err"] = e

    threads = [threading.Thread(target=f) for f in (build_native, build_floor)]
    for th in threads:
        th.start()
    nvcc_s, log = kernels.build(ptxas_info=True, force=True)
    for th in threads:
        th.join()
    if "err" in gpp:
        raise SmokeFailure(str(gpp["err"]))
    gathers = gpp["gathers"]
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
    record, cli_record = check_kernels(clf, hgenes, shapes, record_shape,
                                       timer, gathers)
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
                                          record_shape, timer, gathers))
        del xclf
        gc.collect()
        torch.cuda.empty_cache()
        record.update(check_sharded_kernels(tindex, cclf, tgenes, shapes,
                                            record_shape, timer, gathers))
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
        preads = panel_reads(rng, pgenes, N_PANEL_READS)
        e2e_stats["panel"] = e2e(work, "panel", pgenes, b"GENE", preads)
        a = kernels.LAUNCHES.snapshot()
        e2e_stats["homolog"] = e2e(work, "homolog", hgenes, b"H",
                                   homolog_reads(rng, hgenes, N_HOMOLOG_READS))
        b = kernels.LAUNCHES.snapshot()
        e2e_stats["paired"] = e2e(work, "paired", pgenes, b"GENE",
                                  *pair_reads(rng, pgenes, N_PAIRS))
        launches["a-c"] = ("hashed", kernels.LAUNCHES.snapshot())
        e2e_stats["replicated_homolog"] = e2e_replicated_homolog(
            work, N_HOMOLOG_READS, launches)
        e2e_stats["native"] = e2e_native_backend(work)
        e2e_stats["profiled_panel"] = e2e_profiled_panel(
            work, N_PANEL_READS, a, launches, args.out)
        e2e_stats["multihost"] = e2e_multihost(work, N_PAIRS)
        # (n) bench.py's -q 10 workload: (a)'s reads with its quality
        # profile
        quals = q10_quals(np.random.default_rng(10), N_PANEL_READS)
        kernels.LAUNCHES.reset()
        e2e_stats["q10"] = e2e(
            work, "q10", pgenes, b"GENE", preads, quals1=quals, minq=10,
            note=f" (-q 10 masks {100 * (quals < 43).mean():.2f}% of bases; "
                 f"bench.py's quality profile); {smi}")
        launches["n"] = ("panel", kernels.LAUNCHES.snapshot())
        del preads, quals
        e2e_stats.update(e2e_txome(
            tx_dir, tx_fa, panel_reads(np.random.default_rng(2027), tgenes,
                                       N_TXOME_READS), launches))
        gc.collect()
        torch.cuda.empty_cache()
        e2e_stats["soak"] = e2e_soak(work, launches)
        e2e_stats["bench_gpu"] = e2e_bench_gpu(work)
        e2e_stats["profile_split"] = e2e_profile_split(work)
        e2e_stats["ab_harnesses"] = e2e_ab_harnesses(work, gathers)
        e2e_stats["stage_profiles"] = e2e_stage_profiles(work)
        e2e_stats["probe_profiles"] = e2e_probe_profiles(work)
        e2e_stats["edges"] = e2e_edges(work, hindex, hgenes,
                                       os.path.join(tx_dir, "index"), tgenes,
                                       launches)
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
    say(f"launches over (a)-(t) and phase 5: {json.dumps(total)} (hashed "
        f"path after (a): {json.dumps(a)}, after (b): {json.dumps(b)})")

    kernels_line = {"kernels": []}
    for name, (fn, src, replaces) in KERNEL_INFO.items():
        r = record[name]
        row = {
            "name": fn, "route": "cuda", "source": src, "replaces": replaces,
            "launches": total[name], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"],
        }
        for key in ("device_ms", "device_ms_suspect", "sector_bound_ms",
                    "warm_bound_ms", "warm_ms", "exchange_back_ms",
                    "exchange_back_device_ms"):
            if key in r:
                row[key] = r[key]
        if name == "shard_route" and r.get("device_ops"):
            row["device_ops"] = r["device_ops"]  # memset and kernels
        if name in cli_record:  # the same kernel at the CLI's batch
            c = cli_record[name]
            row["cli_batch"] = {
                "B": CLI_SHAPE[0], "L": CLI_SHAPE[1], "ms": c["ms"],
                "plain_ms": c["plain_ms"], "bound_ms": c["bound"][0],
                "bound_by": c["bound"][1], "library_ms": c["library_ms"],
                "device_ms": c.get("device_ms")}
            if "device_ms_suspect" in c:
                row["cli_batch"]["device_ms_suspect"] = c["device_ms_suspect"]
        kernels_line["kernels"].append(row)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"card": smi, "kernels": kernels_line["kernels"],
                       "bounds_bytes_ops_ms": {
                           KERNEL_INFO[n][0]: record[n]["bound"][2:]
                           for n in KERNEL_INFO},
                       "floors": {KERNEL_INFO[n][0]: record[n][f]
                                  for n in KERNEL_INFO
                                  for f in ("floor", "footprint")
                                  if f in record[n]},
                       "record_shape": RECORD_SHAPE,
                       "cli_shape": CLI_SHAPE, "launches": launches,
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
