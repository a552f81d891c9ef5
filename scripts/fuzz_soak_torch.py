#!/usr/bin/env python3
"""Long-running end-to-end differential fuzz soak of shark_tpu_torch on
the card (the port's round-closing gate).

Replays tests/test_torch_fuzz.py's run_seed over many fresh random seeds:
each seed's workload through the device path (native engine and Python
I/O), --backend native and --backend cpu, and the seed's extra path (the
Bloom filter in 8 shards on the card with a small routing cap, or the
index replicated over [cuda:0, cuda:0]), every output held to the oracle's
ssv and to each other's FASTQs, and each device run's kernel launches to
its layout; then the ties pass (every gene written two or three times).
The per-seed body is loaded from the test file, so the soak certifies
exactly what the pytest gate does.

With --edges each seed runs the file's edge pass instead (run_edges): reads
of 90 to 20000 bases in four bands of the padded-length rules, mate 2 from
the gene of mate 1, --max-read-len 0, rounded or not a multiple of 8 (the
native engine's unpacked path), -s, max_winners 1, 2 or 16 on the ties
pass (reads tied across more genes than the list holds take the host
recompute) and batches of 32 or 8192 reads, at the CLI's Bloom size.

Usage: python3 scripts/fuzz_soak_torch.py [--edges] [n_seeds=100]
       [start_seed=10000] [--cpu]

Runs on cuda:0 unless --cpu is given; without a card, or when the native
engine or the kernel library does not build, it exits 2 and never falls
back to the CPU. Prints one line per seed (its layout, its extra path,
whether reprobe fired, its seconds; with --edges its band, padded lengths,
--max-read-len kind, -s, max_winners, batch size and host-recomputed rows)
and a summary line that counts the seeds by what they covered; exits 1 on
any failure, naming the failing seeds (and their bands). Imports no jax.
"""

import argparse
import importlib.util
import os
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402


def _load_fuzz_mod():
    """The per-seed body lives in tests/test_torch_fuzz.py (run_seed): one
    implementation for the pytest gate, chip_smoke.py and this soak."""
    spec = importlib.util.spec_from_file_location(
        "torch_fuzz_mod", os.path.join(ROOT, "tests", "test_torch_fuzz.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ready(cpu: bool):
    """The device, or an error message: the card and its kernel library
    unless `cpu`, and the native engine built from this checkout."""
    from shark_tpu_torch import kernels
    from shark_tpu_torch.io import native

    if not cpu and not torch.cuda.is_available():
        return None, "no CUDA device (pass --cpu to soak the plain versions)"
    try:
        native.rebuild()
    except RuntimeError as e:
        return None, f"the native engine does not build: {e}"
    if not native.available():
        return None, "the native engine does not load"
    if cpu:
        return "cpu", ""
    try:
        kernels.lib()
    except RuntimeError as e:
        return None, f"the kernel library does not build: {e}"
    return "cuda:0", ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_seeds", nargs="?", type=int, default=100)
    ap.add_argument("start_seed", nargs="?", type=int, default=10000)
    ap.add_argument("--cpu", action="store_true",
                    help="soak the plain PyTorch versions on the host")
    ap.add_argument("--edges", action="store_true",
                    help="run the edge pass (run_edges) on each seed")
    args = ap.parse_args(argv)
    device, why = _ready(args.cpu)
    if device is None:
        print(f"[soak] {why}", flush=True)
        return 2
    fuzz = _load_fuzz_mod()
    if args.edges:
        return _soak_edges(fuzz, device, args.n_seeds, args.start_seed)
    t0 = time.time()
    failed = []
    seen = {}
    for i in range(args.n_seeds):
        seed = args.start_seed + i
        t_seed = time.time()
        with tempfile.TemporaryDirectory() as tmp:
            try:
                r = fuzz.run_seed(tmp, seed, device)
            except Exception:
                failed.append(seed)
                print(f"[soak] seed {seed} FAILED", flush=True)
                traceback.print_exc()
                continue
        extra = "+".join(r["extras"]) or "none"
        for key, on in ((r["layout"], True), (extra, True),
                        ("reprobe", r["reprobe"]),
                        ("groups", r["group_rows"])):
            if on:
                seen[key] = seen.get(key, 0) + 1
        print(
            f"[soak] seed {seed} ok layout={r['layout']} extra={extra} "
            f"reprobe={'yes' if r['reprobe'] else 'no'} k={r['k']} "
            f"paired={int(r['paired'])} gz={int(r['gz'])} minq={r['minq']} "
            f"reads={r['n_reads']} assoc={r['associations']} "
            f"ties: K4 {r['tie_pairs']} group_rows {r['group_rows']} "
            f"({i + 1}/{args.n_seeds}, "
            f"{time.time() - t_seed:.1f} s)",
            flush=True,
        )
    print(
        f"[soak] done on {device}: {args.n_seeds} seeds "
        f"({args.start_seed}..{args.start_seed + args.n_seeds - 1}), "
        f"{len(failed)} failures"
        + (f" (seeds {' '.join(map(str, failed))})" if failed else "")
        + f", {time.time() - t0:.0f} s; seeds passed by layout, extra path, "
        + "reprobe and GROUP verdicts of the ties pass: "
        + " ".join(f"{k}={v}" for k, v in sorted(seen.items())),
        flush=True,
    )
    return 1 if failed else 0


def _soak_edges(fuzz, device, n_seeds: int, start: int) -> int:
    """The edge pass over seeds start .. start + n_seeds - 1."""
    t0 = time.time()
    failed = []
    seen = {}
    for i in range(n_seeds):
        seed = start + i
        t_seed = time.time()
        with tempfile.TemporaryDirectory() as tmp:
            band = fuzz.draw_edges(tmp, seed)["band"]
            try:
                r = fuzz.run_edges(tmp, seed, device)
            except Exception:
                failed.append(f"{seed} (band {band})")
                print(f"[soak] edge seed {seed} band {band} FAILED",
                      flush=True)
                traceback.print_exc()
                continue
        for key in fuzz.edge_covers(r):
            seen[key] = seen.get(key, 0) + 1
        path = ("packed" if r["packed"] else "u8") if r["engine"] else "python"
        print(
            f"[soak] edge seed {seed} ok band={r['band']} "
            f"longest={r['longest']} L={','.join(map(str, r['L']))} "
            f"lens={r['lens']} max_read_len={r['max_read_len']} "
            f"engine={path} "
            f"single={int(r['single'])} W={r['max_winners']} "
            f"B={r['batch_size']} layout={r['layout']} "
            f"paired={int(r['paired'])} pair_emits={r['pair_emits']} "
            f"host_rows={r['host_rows']} group_rows={r['group_rows']} "
            f"reads={r['n_reads']} assoc={r['associations']} "
            f"({i + 1}/{n_seeds}, {time.time() - t_seed:.1f} s)",
            flush=True,
        )
    print(
        f"[soak] edges done on {device}: {n_seeds} seeds "
        f"({start}..{start + n_seeds - 1}), {len(failed)} failures"
        + (f" (seeds {', '.join(failed)})" if failed else "")
        + f", {time.time() - t0:.0f} s; seeds passed by band, max_winners, "
        "batch size, --max-read-len kind, layout and path: "
        + " ".join(f"{k}={v}" for k, v in sorted(seen.items())),
        flush=True,
    )
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
