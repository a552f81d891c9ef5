#!/usr/bin/env python3
"""Per-batch overheads of the port's classify call: the batch's copy to
the card vs the dispatch vs the kernels (the port's counterpart of
bench/dispatch_bench.py).

    python3 scripts/dispatch_bench_torch.py [n_batches=8] [--cpu]

On the panel of bench_gpu.py (its workload and cache, its warm
classifier on the saved index), its first n_batches packed batches from
the C++ engine, each measured best of 3 on the host's clock, ending with
a fetch to the host:
- Classifier.call_packed on device-resident inputs and on the engine's
  numpy arrays, fetching the last batch's packed verdicts only, and
  fetching every batch's (ms a batch);
- the copy of one packed batch (planar codes and validity, 2.56 MB at
  B = 65536, L = 104) to the card from the engine's pageable arrays, and,
  as a measurement only, from a pinned copy of the same bytes: host ms
  (the two .to(non_blocking=True) and a synchronise) and device ms (CUDA
  events), best of 5;
- the launch floor: 8 sums of a device-resident tensor, the last fetched
  (ms a call).
Prints one line a measurement and a JSON line with all of them and the
card's name and power limit. Runs on cuda:0 unless --cpu is given (the
plain versions, no pinned copy); without a card and without --cpu it
exits 1.
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
from shark_tpu_torch.io.native import NativeStream  # noqa: E402


def log(msg: str) -> None:
    print(f"[dispatch] {msg}", file=sys.stderr, flush=True)


def best_of(fn, reps: int) -> float:
    """Least host seconds of fn() over `reps` runs."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_batches", nargs="?", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    if args.cpu:
        dev = torch.device("cpu")
    elif torch.cuda.is_available():
        dev = torch.device("cuda", 0)
    else:
        print("dispatch_bench_torch: no CUDA card (--cpu runs the plain "
              "versions)", file=sys.stderr)
        return 1
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    b = bench_gpu.Bench(dev, float("inf"))
    m = bench_gpu.Main(b)
    cfg = b.config("panel", m.fasta, m.fastq)
    _, clf = b.classifier("panel", cfg, m.idx_dir)
    B, L = bench_gpu.BATCH, bench_gpu.MAX_LEN
    ns = NativeStream(m.fastq, "", B, L, 0, packed=True)
    host = []
    try:
        for _ in range(args.n_batches):
            nb = ns.next_batch()
            if nb is None:
                break
            packed, vmask, slot, _ = nb
            host.append((packed, vmask))
            ns.release(slot)
    finally:
        ns.close()
    t0 = time.perf_counter()
    clf.call_packed(*host[0])[0].cpu()
    log(f"{len(host)} batches of {B} x {L}, probe {clf.probe}; warm "
        f"{time.perf_counter() - t0:.2f} s")
    devb = [(torch.from_numpy(p).to(dev), torch.from_numpy(v).to(dev))
            for p, v in host]
    sync()
    out = {"batches": len(host), "batch_size": B, "max_read_len": L,
           "probe": clf.probe}
    for fetch in ("last", "all"):
        for tag, batches in (("device_resident", devb), ("numpy", host)):
            def run():
                outs = [clf.call_packed(p, v) for p, v in batches]
                for o in (outs if fetch == "all" else outs[-1:]):
                    o[0].cpu()
            ms = 1e3 * best_of(run, 3) / len(batches)
            out[f"call_{tag}_fetch_{fetch}_ms"] = round(ms, 4)
            log(f"{tag:>15} inputs, fetch {fetch:>4}: {ms:8.3f} ms a batch")

    p0, v0 = host[0]
    out["batch_bytes"] = int(p0.nbytes + v0.nbytes)
    sources = {"pageable": (torch.from_numpy(p0), torch.from_numpy(v0))}
    if on_card:
        sources["pinned"] = tuple(t.pin_memory() for t in sources["pageable"])
    for tag, (pt, vt) in sources.items():
        def copy():
            a = pt.to(dev, non_blocking=True)
            c = vt.to(dev, non_blocking=True)
            sync()
            return a, c
        host_ms = 1e3 * best_of(copy, 5)
        out[f"h2d_{tag}_host_ms"] = round(host_ms, 4)
        line = f"H2D of one batch ({out['batch_bytes'] / 1e6:.2f} MB) from " \
               f"{tag} memory: host {host_ms:.4f} ms"
        if on_card:
            dev_ms = float("inf")
            for _ in range(5):
                e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                e[0].record()
                pt.to(dev, non_blocking=True)
                vt.to(dev, non_blocking=True)
                e[1].record()
                e[1].synchronize()
                dev_ms = min(dev_ms, e[0].elapsed_time(e[1]))
            out[f"h2d_{tag}_device_ms"] = round(dev_ms, 4)
            out[f"h2d_{tag}_gb_s"] = round(
                out["batch_bytes"] / dev_ms / 1e6, 3)
            line += f", device {dev_ms:.4f} ms " \
                    f"({out[f'h2d_{tag}_gb_s']:.2f} GB/s)"
        log(line)

    xs = devb[0][1]
    xs.sum().cpu()

    def tiny():
        outs = [xs.sum() for _ in range(8)]
        outs[-1].cpu()
    out["launch_floor_ms"] = round(1e3 * best_of(tiny, 3) / 8, 4)
    log(f"launch floor (x.sum() on the device, 8 calls, last fetched): "
        f"{out['launch_floor_ms']:.4f} ms a call")
    out["device"] = bench_gpu.card_name() if on_card else "cpu"
    print(json.dumps(out), flush=True)
    b.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
