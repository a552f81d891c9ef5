#!/usr/bin/env python3
"""The full pipeline at several batch sizes in one process: the port's
counterpart of bench/ab_batch.py.

    python3 scripts/ab_batch_torch.py [B ...] [--workload panel|homolog]
        [--reads N] [--cpu] [--cache DIR]

For each batch size B (default the reference's 65536 131072 262144,
bench/ab_batch.py:22), on one warm classifier of bench_gpu.py's workload
(panel by default: 500k reads, L = 104, k = 17, c = 0.6, -b 1; homolog
with --workload homolog, the tie-heavy one):
- one serial pass (scripts/profile_e2e_torch.py serial_pass), for the
  first batch's parse wait (the C++ engine's ring filling its first
  batch before the card gets any work) and the stages of the pass;
- run_pipeline three times (bench_gpu.Bench.passes: best of 3), for
  classify_s and reads/s;
- the association count of every pass, the card's memory high-water mark
  over the B's passes (torch.cuda.max_memory_allocated), and the kernels
  launched by one overlapped pass (K4, extract_pairs, takes batches of at
  most 65536 reads: above that the drain takes the winners' host path,
  as shark_tpu's does).
Every pass at every B must write the association count of the first
pass and the same ssv and FASTQ bytes (sha256), or the run exits 1.
Prints one JSON line. Runs on cuda:0 unless --cpu is given (the plain
versions, no device number); without a card and without --cpu it exits
1. --reads N and --cache DIR as in scripts/profile_e2e_torch.py.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]

import torch  # noqa: E402

import bench_gpu  # noqa: E402
import profile_e2e_torch as pe  # noqa: E402
from shark_tpu_torch import kernels  # noqa: E402
from shark_tpu_torch.pipeline import run_pipeline  # noqa: E402


SIZES = (65536, 131072, 262144)


def log(msg: str) -> None:
    print(f"[ab_batch] {msg}", file=sys.stderr, flush=True)


def digest(paths) -> list:
    """sha256 of each file of `paths` ("" for an unused output)."""
    out = []
    for path in paths:
        if not path:
            out.append("")
            continue
        with open(path, "rb") as f:
            out.append(hashlib.sha256(f.read()).hexdigest())
    return out


def one_size(b, wl, cfg, clf, want) -> dict:
    """One batch size's serial pass, passes and checks (the module's
    docstring); `want`: the association count every pass must write, or
    None to take the first pass's."""
    on_card = clf.device.type == "cuda"
    d = os.path.dirname(cfg.ssv_path)
    serial = [os.path.join(d, f"{wl}.ab_batch{ext}")
              for ext in (".ssv", ".out1.fq", ".out2.fq")]
    if not cfg.sample2_path:
        serial[2] = ""
    pe.warm(cfg, clf)
    s = pe.serial_pass(cfg, clf, *serial)
    first = s["per_batch_s"][0] if s["per_batch_s"] else {}
    row = {"batch_size": cfg.batch_size, "batches": s["batches"],
           "first_batch_parse_ms": round(1e3 * first.get("parse", 0.0), 3),
           "serial_total_s": round(s["serial_total_s"], 6),
           "serial_stages_s": {k: round(v, 6)
                               for k, v in s["stages_s"].items()}}
    serial_digest = digest(serial)
    for path in serial:
        if path:
            os.remove(path)
    if want is None:
        want = run_pipeline(cfg, classifier=clf)["n_associations"]
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(clf.device)
    kernels.LAUNCHES.reset()
    best = b.passes(wl, cfg, clf, want, n=3, tag=f"{wl}_B{cfg.batch_size}")
    row["launches_3_passes"] = {k: v for k, v in
                                kernels.LAUNCHES.snapshot().items() if v}
    row.update(classify_s=round(best["classify_s"], 6),
               reads_per_sec=round(best["n_reads"] / best["classify_s"], 1),
               n_associations=best["n_associations"],
               n_reads=best["n_reads"])
    if on_card:
        row["max_memory_allocated_mb"] = round(
            torch.cuda.max_memory_allocated(clf.device) / 2**20, 1)
    row["digest"] = digest((cfg.ssv_path, cfg.out1_path, cfg.out2_path))
    row["serial_bytes_equal"] = row["digest"] == serial_digest
    return row


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sizes", type=int, nargs="*", default=list(SIZES))
    ap.add_argument("--workload", default="panel",
                    choices=("panel", "homolog"))
    ap.add_argument("--reads", type=int, default=bench_gpu.N_READS)
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
            print("ab_batch_torch: no CUDA card; the A/B measures the card "
                  "(--cpu runs the plain versions)", file=sys.stderr)
            return 1
    device = torch.device(device)
    pe.size_workloads(args.reads, args.cache)
    b = bench_gpu.Bench(device, float("inf"))
    cfg0, clf = pe.workload_config(b, args.workload)
    log(f"{args.workload}: probe {clf.probe}, set-up {b.stage_s}")
    rows, want, ref = [], None, None
    for B in args.sizes:
        cfg = dataclasses.replace(cfg0, batch_size=B)
        row = one_size(b, args.workload, cfg, clf, want)
        want = row["n_associations"] if want is None else want
        ref = row["digest"] if ref is None else ref
        row["bytes_equal_first"] = row["digest"] == ref
        rows.append(row)
        log(json.dumps(row))
    ok = (not b.failures and all(r["bytes_equal_first"]
                                 and r["serial_bytes_equal"] for r in rows))
    line = {"workload": args.workload, "reads": rows[0]["n_reads"],
            "max_read_len": cfg0.max_read_len, "probe": clf.probe,
            "sizes": rows, "exact": ok, "failures": b.failures,
            "stage_s": b.stage_s,
            "device": bench_gpu.card_name() if device.type == "cuda"
            else "cpu"}
    print(json.dumps(line), flush=True)
    if not ok:
        log("FAILED: a batch size's bytes or association count differ")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
