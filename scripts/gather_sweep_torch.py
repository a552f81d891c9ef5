#!/usr/bin/env python3
"""The card's bare random-gather rate by table size, row width and index
order: the port's counterpart of bench/gather_bench.py and
bench/hash_gather_bench.py (section A), on one CUDA card.

    python3 scripts/gather_sweep_torch.py [--sizes-mb 4 16 ... 2048]
        [--n 5767168] [--reps 7] [--cpu]

The hashed probe's table sizes and bucket rows were chosen on the TPU,
whose gather rate fell past 64 MB (the 64 MB cap of
shark_tpu_torch/classify/hashed.py) and with wider rows. This asks the
same of the H100 (50 MB of L2, 80 GB of HBM): for every table size (one
allocation of random words, its L2 flushed by a 128 MB write when the
size changes) and every row width of floors.ROW_BYTES (4 to 128 bytes),
n row indices (default 5,767,168, a batch of 65536 reads' 88 probe
windows) are drawn uniformly from an explicit torch.Generator seeded
with SEED (draw_indices), and the same indices sorted;
shark_tpu_torch/floors.py's bare gather folds each row to one word. Each
row of the line gives the device ms of one gather from torch.profiler
with the L2 warm (back-to-back calls) and flushed before every call,
each held against the back-to-back time (shark_tpu_torch/utils/timers.py
device_profile; a reading none of whose sessions agrees with it is
marked *_suspect), the event ms of back-to-back calls, rows/s and the
rows' GB/s at the warm device time,
and whether the gather equals its plain version (floors.rows_plain) on
the card. The summary gives, by width, the random rate at each size
over the smallest size's, the first size where it falls under half
(cliff_mb), and the 32-byte row's rate over the 16- and 64-byte rows'.

Measurement tools, not kernels of the port: the gathers count no launch.
Runs on cuda:0 unless --cpu is given (the plain versions, timed on the
host's clock as cpu_ms; no device number); without a card and without
--cpu it exits 1. Exits 1 when a gather differs from its plain version.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import bench_gpu  # noqa: E402
from shark_tpu_torch import floors  # noqa: E402
from shark_tpu_torch.utils import timers  # noqa: E402

SIZES_MB = (4, 16, 32, 48, 64, 128, 512, 1024, 2048)
WIDTHS = floors.ROW_BYTES
N_INDICES = 65536 * 88  # a batch's probe windows at L = 104, k = 17
SEED = 7


def log(msg: str) -> None:
    print(f"[gather_sweep] {msg}", file=sys.stderr, flush=True)


def draw_indices(rows: int, n: int, seed: int, device) -> torch.Tensor:
    """i32[n] row indices, uniform over [0, rows), from a torch.Generator
    on `device` seeded with `seed`: the same seed gives the same draw."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(0, rows, (n,), generator=g, device=device,
                         dtype=torch.int32)


def make_table(nbytes: int, seed: int, device) -> torch.Tensor:
    """i32[nbytes / 4] of random words from a generator seeded with
    `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    t = torch.empty(nbytes // 4, dtype=torch.int32, device=device)
    return t.random_(generator=g)


def measure(table, idx, width, reps, flush, on_card) -> dict:
    """One row's timings of floors.rows(table, idx, width)."""
    def fn():
        return floors.rows(table, idx, width)

    if not on_card:
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return {"cpu_ms": (time.perf_counter() - t0) / reps * 1e3}
    p = timers.device_profile(fn, reps, warn=log)
    pf = timers.device_profile(fn, reps, flush, warn=log)
    warm = p["device_ms"]
    row = {"device_ms": warm, "device_ms_flushed": pf["device_ms"],
           "event_ms": p["back_to_back_ms"]}
    for key, q in (("device_ms_suspect", p),
                   ("device_ms_flushed_suspect", pf)):
        if "device_ms_suspect" in q:
            row[key] = q["device_ms_suspect"]
    if warm:
        n = idx.numel()
        row["rows_per_sec"] = n / (warm / 1e3)
        row["row_gb_per_sec"] = n * width / (warm / 1e3) / 1e9
    return row


def summarize(rows, sizes, widths) -> dict:
    """By width: the random gather's rate at each size over the smallest
    size's, the first size where it falls under half (cliff_mb, None when
    it never does), and the 32-byte row's rate over the 16- and 64-byte
    rows' at each size."""
    key = "rows_per_sec" if "rows_per_sec" in rows[0] else None
    if key is None:
        return {}
    rate = {(r["size_mb"], r["width"], r["order"]): r.get(key) for r in rows}
    out = {"by_width": {}, "w32_over_w16": {}, "w32_over_w64": {}}
    for w in widths:
        base = rate.get((sizes[0], w, "random"))
        ratios = {s: rate[(s, w, "random")] / base for s in sizes
                  if base and rate.get((s, w, "random"))}
        cliff = next((s for s in sizes if ratios.get(s, 1) < 0.5), None)
        out["by_width"][w] = {"random_vs_smallest": ratios,
                              "cliff_mb": cliff}
    for s in sizes:
        r32 = rate.get((s, 32, "random"))
        for other, k in ((16, "w32_over_w16"), (64, "w32_over_w64")):
            ro = rate.get((s, other, "random"))
            if r32 and ro:
                out[k][s] = r32 / ro
    return out


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes-mb", type=int, nargs="+", default=SIZES_MB)
    ap.add_argument("--n", type=int, default=N_INDICES,
                    help="row indices a gather")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    if device is None:
        if args.cpu:
            device = "cpu"
        elif torch.cuda.is_available():
            device = "cuda:0"
        else:
            print("gather_sweep_torch: no CUDA card; the sweep measures the "
                  "card (--cpu runs the plain versions)", file=sys.stderr)
            return 1
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        floors.lib()  # nvcc before the first timing
    flush = timers.l2_flusher(device=device) if on_card else None
    rows, failed = [], []
    for s_mb in args.sizes_mb:
        nbytes = s_mb << 20
        table = make_table(nbytes, SEED, device)
        if flush is not None:
            flush()
        for w in WIDTHS:
            idx = draw_indices(nbytes // w, args.n, SEED + w, device)
            for order, ix in (("random", idx),
                              ("sorted", torch.sort(idx).values)):
                same = bool(torch.equal(floors.rows(table, ix, w),
                                        floors.rows_plain(table, ix, w)))
                row = {"size_mb": s_mb, "width": w, "order": order,
                       "equal_plain": same}
                row.update(measure(table, ix, w, args.reps, flush, on_card))
                rows.append(row)
                if not same:
                    failed.append((s_mb, w, order))
                log(json.dumps(row))
        del table
        if on_card:
            torch.cuda.empty_cache()
    line = {"n": args.n, "seed": SEED, "rows": rows,
            "summary": summarize(rows, args.sizes_mb, WIDTHS),
            "all_equal_plain": not failed,
            "device": bench_gpu.card_name() if on_card else "cpu"}
    print(json.dumps(line), flush=True)
    if failed:
        log(f"FAILED: gathers differ from their plain versions: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
