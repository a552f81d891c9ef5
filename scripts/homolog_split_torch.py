#!/usr/bin/env python3
"""The pure/impure split of the homolog workload's group path, batch by
batch: the port's counterpart of bench/homolog_split.py.

    python3 scripts/homolog_split_torch.py [--reads N] [--batch B]
        [--cpu] [--cache DIR]

The finish (K3, shark_tpu_torch/classify/step.py finish_from_tags) gives
a read its GROUP verdict when every hit of the read is a degree >= 3 row
of one group id (a pure read), provided the batch holds at most FIX_CAP2
impure row-hitting reads (step.fix_caps: FIX_CAP = B / FIX_DIV, FIX_CAP2
= B / FIX_DIV2); otherwise every read of the batch takes its full
verdict. This counts, for each batch of bench_gpu.py's homolog workload
(500k reads, B = 65536, L = 104, k = 17; gen_homolog, seed 4242), from
the (tag, payload) windows of K1 and the probe (Classifier.tags), with
the port's tags (TAG_D1, TAG_D2, TAG_ROW):
    row_reads     reads with any row hit;
    pure          every hit on a row, one group id;
    impure        row-hitting reads that are not pure (the batch's count
                  that FIX_CAP2 caps);
    direct_only   reads with direct hits and no row hit;
    empty         reads without a hit;
    row_windows, direct_windows;
and the batch's FIX_CAP and FIX_CAP2, whether impure fits each, and so
whether the batch's pure reads take their GROUP verdicts.

Runs K1 and the probe on cuda:0, counts on the card's tags, and also
takes the impure count from K3's group-count entry
(step.finish_group_count, shkk_finish_count); the two must agree, or the
run exits 1. The split depends on the data, not on the hardware: --cpu
gives it from the plain versions (no K3 count); without a card and
without --cpu it exits 1. Prints one JSON line (per batch and totals).

--reads N (default bench_gpu.py's 500000) and --cache DIR as in
scripts/profile_e2e_torch.py.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]

import torch  # noqa: E402

import bench_gpu  # noqa: E402
import profile_e2e_torch as pe  # noqa: E402
from shark_tpu_torch.classify import step  # noqa: E402


COUNTS = ("row_reads", "pure", "impure", "direct_only", "empty",
          "row_windows", "direct_windows")


def log(msg: str) -> None:
    print(f"[homolog_split] {msg}", file=sys.stderr, flush=True)


def split(tagv: torch.Tensor, payv: torch.Tensor, n: int,
          rows_bits: int) -> dict:
    """COUNTS of the first n reads of one batch's (tag, payload) windows
    (u32[B, Ls]), from the tags alone (bench/homolog_split.py:150-176)."""
    t = tagv[:n].to(torch.int64)
    p = payv[:n].to(torch.int64)
    is_row = t == step.TAG_ROW
    direct = (t == step.TAG_D1) | (t == step.TAG_D2)
    gid = p >> rows_bits if rows_bits else torch.zeros_like(p)
    any_row = is_row.any(dim=1)
    any_direct = direct.any(dim=1)
    gmax = torch.where(is_row, gid, torch.full_like(gid, -1)).max(dim=1)
    gmin = torch.where(is_row, gid, torch.full_like(gid, 0x7FFFFFFF)).min(
        dim=1)
    pure = any_row & ~any_direct & (gmax.values == gmin.values)
    return {
        "row_reads": int(any_row.sum()),
        "pure": int(pure.sum()),
        "impure": int((any_row & ~pure).sum()),
        "direct_only": int((any_direct & ~any_row).sum()),
        "empty": int((~any_direct & ~any_row).sum()),
        "row_windows": int(is_row.sum()),
        "direct_windows": int(direct.sum()),
    }


def batch_line(clf, packed, vmask, n: int) -> dict:
    """One batch's split (and on the card K3's impure count)."""
    tagv, payv, _, L = clf.tags(packed, vmask)
    meta = clf._geometry(L)[0]
    B = tagv.shape[0]
    out = {"reads": n, "batch_size": B}
    out.update(split(tagv, payv, n, meta.rows_bits))
    fix_cap, fix_cap2 = step.fix_caps(B)
    out.update(fix_cap=fix_cap, fix_cap2=fix_cap2,
               within_fix_cap=out["impure"] <= fix_cap,
               group_verdicts=bool(clf._has_rows and meta.rows_bits
                                   and out["impure"] <= fix_cap2))
    if tagv.is_cuda:
        n_fix = torch.zeros(1, dtype=torch.int32, device=tagv.device)
        step.finish_group_count(tagv, payv, n_fix, meta=meta,
                                has_rows=clf._has_rows)
        out["impure_k3"] = int(n_fix.item())
    return out


def run(cfg, clf) -> dict:
    """Every batch of cfg's sample."""
    batches = []
    ns = pe.open_stream(cfg)
    try:
        while True:
            nb = ns.next_batch()
            if nb is None:
                break
            packed, vmask, slot, n = nb
            batches.append(batch_line(clf, packed, vmask, n))
            ns.release(slot)
            log(json.dumps(batches[-1]))
    finally:
        ns.close()
    total = {k: sum(b[k] for b in batches) for k in COUNTS + ("reads",)}
    return {"batches": batches, "total": total}


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=bench_gpu.N_READS)
    ap.add_argument("--batch", type=int, default=bench_gpu.BATCH)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU (no K3 count)")
    ap.add_argument("--cache", default="")
    args = ap.parse_args(argv)
    if device is None:
        if args.cpu:
            device = "cpu"
        elif torch.cuda.is_available():
            device = "cuda:0"
        else:
            print("homolog_split_torch: no CUDA card; the split runs on the "
                  "card (--cpu runs the plain versions)", file=sys.stderr)
            return 1
    device = torch.device(device)
    pe.size_workloads(args.reads, args.cache)
    b = bench_gpu.Bench(device, float("inf"))
    cfg, clf = pe.workload_config(b, "homolog")
    cfg = dataclasses.replace(cfg, batch_size=args.batch)
    log(f"homolog: probe {clf.probe}, set-up {b.stage_s}")
    line = {"workload": "homolog", "probe": clf.probe,
            "max_read_len": cfg.max_read_len, "k": cfg.k}
    line.update(run(cfg, clf))
    rc = 0
    if device.type == "cuda":
        bad = [i for i, x in enumerate(line["batches"])
               if x["impure"] != x["impure_k3"]]
        line["k3_agrees"] = not bad
        if bad:
            log(f"FAILED: K3's impure count differs on batches {bad}")
            rc = 1
    line["device"] = bench_gpu.card_name() if device.type == "cuda" \
        else "cpu"
    print(json.dumps(line), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
