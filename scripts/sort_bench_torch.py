#!/usr/bin/env python3
"""The price of a probe dedup on one CUDA card: the port's counterpart of
bench/sort_bench.py.

    python3 scripts/sort_bench_torch.py [--n N] [--reads N] [--reps R]
        [--warm-only] [--cpu] [--cache DIR]

A gene panel's batch probes each distinct k-mer position about 8 times
(the reference's profile: 5.77 M windows over about 742k distinct
positions). Gathering each bucket once, at the cost of grouping the
duplicates, pays only if the grouping is cheap. The reference's sizes and
seed: N = 65536 x 88 = 5,767,168 positions drawn from 742,000 distinct
33-bit values (np.random.default_rng(0)), and a u32[2^19, 2, 8] table of
64-byte rows; --n scales N, and the distinct count with it. Each piece
is timed on the card as device ms (utils/timers.py device_profile, L2
warm and flushed; --warm-only: warm alone):

    sort_u32            torch.sort of the low words (int32 view: the same
                        4-byte keys and radix passes as u32)
    sort_1key_payload   the same with its indices, then the payload (the
                        window index) gathered by them
    sort_2key_payload   one int64 key hi << 32 | lo, sorted with its
                        indices, then the payload gathered
    argsort_u32         torch.argsort of the low words
    gather_distinct     floors.rows of the distinct positions' buckets
                        (bucket = lo & (2^19 - 1)), 64 bytes a row; the
                        dedup's small gather, beside index_select
    gather_full         floors.rows of every position's bucket, beside
                        index_select (the reference's control)
    flags_cumsum        first-occurrence flags of the sorted keys and
                        their int32 cumsum (the reference's glue)

and the dedup itself, in four timed steps: sort (the two-key sort and its
permutation), flags and scan (first-occurrence flags, the segment of each
sorted key, the distinct buckets compacted), the small gather, and the
scatter back (each window takes its segment's row, put back in window
order); `dedup_ms` is their sum, and the dedup's result must equal the
full gather. It is set against gather_full and against K2's whole-kernel
device ms (hashed.probe_hashed) on the first batch of bench_gpu.py's panel
(B = 65536, L = 104), whose own window and distinct position counts are
printed beside the reference's.

The pieces are library calls (torch.sort, cumsum, index_select) and the
bare gathers of shark_tpu_torch/floors.py: this prices building blocks,
as the reference did, and ports no kernel. Runs on cuda:0; --cpu runs
the same pieces on the CPU (no timing) with their checks; without a card
and without --cpu it exits 1. Prints one JSON line with every reading and
a `checks` map; exits 1 when a check fails. --reads N and --cache DIR (the
panel's) as in scripts/profile_e2e_torch.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bench_gpu  # noqa: E402
import profile_e2e_torch as pe  # noqa: E402
import profile_probe_torch as pp  # noqa: E402
from ab_layout_torch import first_batches  # noqa: E402
from shark_tpu_torch import floors  # noqa: E402
from shark_tpu_torch.classify import hashed, step  # noqa: E402
from shark_tpu_torch.utils import timers  # noqa: E402

SCRIPT = "sort_bench_torch"
N_FULL = 65536 * 88
DISTINCT_FULL = 742_000
TABLE_LG = 19  # u32[2^19, 2, 8]: 64-byte rows
ROW_BYTES = 64


def log(msg: str) -> None:
    print(f"[sort_bench] {msg}", file=sys.stderr, flush=True)


def make_inputs(n: int):
    """(positions u64 [n], table u32 [2^19, 2, 8]) as numpy, the
    reference's draws (bench/sort_bench.py:37-47) with the distinct count
    scaled to n."""
    rng = np.random.default_rng(0)
    n_distinct = max(1, round(DISTINCT_FULL * n / N_FULL))
    distinct = rng.integers(0, 1 << 33, size=n_distinct, dtype=np.uint64)
    pos = distinct[rng.integers(0, distinct.size, size=n)]
    table = rng.integers(0, 1 << 30, size=(1 << TABLE_LG, 2, 8),
                         dtype=np.uint32)
    return pos, table


def dedup_steps(key, table):
    """The dedup's four steps as functions, each taking the previous one's
    result: sort -> (sorted keys, permutation); flags and scan ->
    (permutation, segment of each sorted key, distinct buckets); gather ->
    (permutation, segment, rows of the distinct buckets); scatter ->
    every window's row (u32 [n]) in window order."""
    mask = (1 << TABLE_LG) - 1

    def sort():
        return torch.sort(key)

    def flags_scan(s):
        sk, perm = s
        first = torch.ones_like(sk, dtype=torch.bool)
        first[1:] = sk[1:] != sk[:-1]
        seg = torch.cumsum(first, 0, dtype=torch.int32) - 1
        return perm, seg, (sk[first] & mask).to(torch.int32)

    def gather(f):
        perm, seg, ubucket = f
        return perm, seg, floors.rows(table, ubucket, ROW_BYTES)

    def scatter(g):
        perm, seg, rows = g
        out = torch.empty(perm.shape, dtype=torch.int32, device=perm.device)
        out[perm] = rows.view(torch.int32)[seg]
        return out.view(torch.uint32)
    return sort, flags_scan, gather, scatter


def k2_anchor(b, reps: int, on_card: bool) -> dict:
    """K2 on the first batch of the panel: its device ms, its windows and
    distinct valid positions."""
    cfg, clf = pe.workload_config(b, "panel")
    packed, vmask = first_batches(cfg, 1)[0]
    pk = torch.from_numpy(packed).to(clf.device)
    vm = torch.from_numpy(vmask).to(clf.device)
    meta = clf._geometry(pk.shape[1] * 4)[0]
    hi, lo, valid, _ = step.front_end(pk, vm, meta)
    pos = (pp.u64(hi) << 32 | pp.u64(lo))[valid]
    out = {"windows": lo.numel(), "valid_windows": int(valid.sum()),
           "distinct_positions": int(torch.unique(pos).numel())}
    if on_card:
        dix = clf.dix
        out.update(pp.timing(lambda: hashed.probe_hashed(
            hi, lo, valid, dix.table, dix.stash, clf._hmeta,
            dix.stash_rows), reps, None))
    return out


def run(device, n: int, reps: int, warm_only: bool = False) -> dict:
    on_card = device.type == "cuda"
    pos_np, table_np = make_inputs(n)
    pos = torch.from_numpy(pos_np.view(np.int64)).to(device)
    table = torch.from_numpy(table_np).to(device)
    lo_np = (pos_np & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    lo32 = torch.from_numpy(lo_np).to(device)
    key = pos  # hi << 32 | lo: the position itself (< 2^33)
    payload = torch.arange(n, dtype=torch.int32, device=device)
    bucket = (pos & ((1 << TABLE_LG) - 1)).to(torch.int32)
    flat = table.view(-1, ROW_BYTES // 4)
    n_distinct = int(np.unique(pos_np).size)
    line = {"n": n, "distinct": n_distinct,
            "table_mb": table.numel() * 4 / 2**20}
    sort, flags_scan, gather, scatter = dedup_steps(key, table)
    s = sort()
    f = flags_scan(s)
    ubucket = f[2]
    g = gather(f)
    got = scatter(g)
    lo_sorted = np.sort(lo_np)
    checks = {
        "sort_u32_sorted": np.array_equal(
            torch.sort(lo32).values.cpu().numpy(), lo_sorted),
        "sort_2key_sorted": np.array_equal(s[0].cpu().numpy(),
                                           np.sort(pos_np).view(np.int64)),
        "argsort_sorts": np.array_equal(
            lo32[torch.argsort(lo32)].cpu().numpy(), lo_sorted),
        "distinct_found": int(ubucket.numel()) == n_distinct,
        "gather_equals_plain": torch.equal(
            floors.rows(table, ubucket, ROW_BYTES),
            floors.rows_plain(table, ubucket, ROW_BYTES)),
        "dedup_equals_full_gather": torch.equal(
            got, floors.rows_plain(table, bucket, ROW_BYTES)),
    }
    b = bench_gpu.Bench(device, float("inf"))
    line["panel_k2"] = k2_anchor(b, reps, on_card)
    if not on_card:
        line["checks"] = checks
        return line
    flush = None if warm_only else timers.l2_flusher(device=device)
    pieces = {
        "sort_u32": lambda: torch.sort(lo32),
        "sort_1key_payload": lambda: payload[torch.sort(lo32).indices],
        "sort_2key_payload": lambda: payload[torch.sort(key).indices],
        "argsort_u32": lambda: torch.argsort(lo32),
        "gather_distinct": lambda: floors.rows(table, ubucket, ROW_BYTES),
        "index_select_distinct": lambda: flat.index_select(0, ubucket),
        "gather_full": lambda: floors.rows(table, bucket, ROW_BYTES),
        "index_select_full": lambda: flat.index_select(0, bucket),
        "flags_cumsum": lambda: flags_scan(s)[1],
        "dedup_sort": sort,
        "dedup_flags_scan": lambda: flags_scan(s),
        "dedup_gather": lambda: gather(f),
        "dedup_scatter": lambda: scatter(g),
    }
    times = {}
    for name, fn in pieces.items():
        times[name] = pp.timing(fn, reps, flush)
        log(f"{name}: {times[name]['device_ms']}")
    line["pieces"] = times
    steps = ("dedup_sort", "dedup_flags_scan", "dedup_gather",
             "dedup_scatter")
    for suffix in ("", "_flushed"):
        key_ms = "device_ms" + suffix
        if all(times[s_].get(key_ms) for s_ in steps):
            ms = sum(times[s_][key_ms] for s_ in steps)
            line["dedup_ms" + suffix] = ms
            line["dedup_over_gather_full" + suffix] = (
                ms / times["gather_full"][key_ms])
    k2 = line["panel_k2"].get("device_ms")
    if k2 and "dedup_ms" in line:
        line["dedup_over_k2"] = line["dedup_ms"] / k2
    line["checks"] = checks
    return line


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", choices=("panel",), default="panel",
                    help="the workload whose first batch K2 is timed on")
    ap.add_argument("--n", type=int, default=N_FULL,
                    help="positions (the distinct count scales with it)")
    ap.add_argument("--reads", type=int, default=bench_gpu.N_READS)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--warm-only", action="store_true",
                    help="no readings with the L2 flushed")
    ap.add_argument("--cpu", action="store_true",
                    help="the pieces and their checks on the CPU, untimed")
    ap.add_argument("--cache", default="")
    args = ap.parse_args(argv)
    if device is None:
        if args.cpu:
            device = "cpu"
        elif torch.cuda.is_available():
            device = "cuda:0"
        else:
            print(f"{SCRIPT}: no CUDA card; the pieces are timed on the "
                  "card (--cpu runs them untimed)", file=sys.stderr)
            return 1
    device = torch.device(device)
    pe.size_workloads(args.reads, args.cache)
    line = run(device, args.n, args.reps, args.warm_only)
    line["device"] = bench_gpu.card_name() if device.type == "cuda" \
        else "cpu"
    print(json.dumps(line), flush=True)
    bad = [k for k, v in line["checks"].items() if v is not True]
    if bad:
        log(f"FAILED: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
