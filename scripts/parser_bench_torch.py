#!/usr/bin/env python3
"""The host's ingest ceiling: the C++ engine's NativeStream pull rate, no
device (the port's counterpart of bench/parser_bench.py).

    python3 scripts/parser_bench_torch.py [FASTQ] [BATCH_SIZE]

Pulls every batch of FASTQ (default: bench_gpu.py's panel, 500k reads,
generated into its cache when missing) through the full ring (parse ->
encode and pack on the encoder threads -> the shk_next copy into fresh
arrays) and releases it, best of 3 a setting: byte codes (pack_mode=0,
which skips the pack planes) and packed (the port's main path), each with
the encoder thread counts the reference sweeps (1, 2, 3; the pipeline
runs 1 unless -t asks for more). The page cache is warmed first. Prints
one line a setting and a JSON line of reads/s with the host's CPU count
and, where nvidia-smi answers, the card's name and power limit (the
machine the rate was taken on).
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import bench_gpu  # noqa: E402
from shark_tpu_torch.io.native import NativeStream  # noqa: E402

THREADS = (1, 2, 3)


def log(msg: str) -> None:
    print(f"[parser] {msg}", file=sys.stderr, flush=True)


def drain(fastq: str, packed: bool, batch_size: int, threads: int):
    """(reads, seconds) of one pull through the whole file."""
    ns = NativeStream(fastq, "", batch_size, bench_gpu.MAX_LEN, 0,
                      packed=packed, encode_threads=threads)
    n_total = 0
    try:
        t0 = time.perf_counter()
        while True:
            nb = ns.next_batch()
            if nb is None:
                break
            n_total += nb[-1]
            ns.release(nb[-2])
        dt = time.perf_counter() - t0
    finally:
        ns.close()
    return n_total, dt


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    fastq = argv[0] if argv else bench_gpu.gen_workload()[1]
    batch_size = int(argv[1]) if len(argv) > 1 else bench_gpu.BATCH
    with open(fastq, "rb") as f:  # warm the page cache
        while f.read(1 << 24):
            pass
    rates = {}
    n = 0
    for packed in (False, True):
        for threads in THREADS:
            best = 0.0
            for _ in range(3):
                n, dt = drain(fastq, packed, batch_size, threads)
                best = max(best, n / dt)
            key = f"{'packed' if packed else 'bytes'}_enc_threads_{threads}"
            rates[key] = round(best, 1)
            log(f"{key}: {best:,.0f} reads/s")
    out = {"fastq": os.path.basename(fastq), "reads": n,
           "batch_size": batch_size, "max_read_len": bench_gpu.MAX_LEN,
           "reads_per_sec": rates, "host_cpus": os.cpu_count()}
    # the rate is the host's; the card names the machine it was taken on
    out["device"] = (bench_gpu.card_name() if torch.cuda.is_available()
                     else None)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
