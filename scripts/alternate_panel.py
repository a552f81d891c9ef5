#!/usr/bin/env python3
"""Run chip_smoke.py's panel workload (a), or with --paired its paired
workload (c), end to end through the CLI of two checkouts in turns, on
one CUDA card, and print each run's classify rate.

    python3 scripts/alternate_panel.py [--paired] CHECKOUT_A CHECKOUT_B [PAIRS]

The workload is chip_smoke.py's run (a): 500 genes of 1500 bp and
500,000 single-end 100 bp reads with 2% errors, or its run (c): the same
genes and 50,000 innie pairs, made with its generators and seed, written
once under build/ of the checkout holding this script.
Each run is a fresh `python -m shark_tpu_torch` process in its checkout
with the smoke's flags (-k 17 -c 0.6 -b 1); the rate is reads /
classify_s from --stats-json. One warm-up run per checkout builds its
kernels and C++ engine; then PAIRS pairs (default 10) alternate which
checkout goes first. Every run's ssv must equal the first run's.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def run(checkout, d, fa, files, tag):
    """One CLI run in `checkout`; returns (reads/s, ssv bytes)."""
    out = os.path.join(d, tag)
    argv = [sys.executable, "-m", "shark_tpu_torch", "-r", fa,
            "-1", files["all", "1"], "-o", out + ".fq", "--ssv",
            out + ".ssv", "-k", str(cs.K), "-c", str(cs.C), "-b",
            str(cs.BF_GB), "--stats-json", out + ".json"]
    if ("all", "2") in files:
        argv += ["-2", files["all", "2"], "-p", out + ".2.fq"]
    env = dict(os.environ, PYTHONPATH=checkout)
    subprocess.run(argv, cwd=checkout, env=env, check=True,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    with open(out + ".json") as f:
        stats = json.load(f)
    with open(out + ".ssv", "rb") as f:
        ssv = f.read()
    return stats["n_reads"] / stats["classify_s"], ssv


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return q[0], statistics.median(xs), q[2]


def main() -> int:
    args = sys.argv[1:]
    paired = args[:1] == ["--paired"]
    args = args[1:] if paired else args
    if len(args) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the runs are on the card", file=sys.stderr)
        return 1
    sides = [os.path.abspath(p) for p in args[:2]]
    pairs = int(args[2]) if len(args) > 2 else 10
    if pairs < 2:
        print("PAIRS must be at least 2", file=sys.stderr)
        return 2
    d = os.path.join(HERE, "build", "alternate_panel")
    os.makedirs(d, exist_ok=True)
    try:
        rng = np.random.default_rng(12345)  # chip_smoke.py's phase-4 seed
        genes = cs.panel_genes(rng)
        reads = cs.panel_reads(rng, genes, cs.N_PANEL_READS)
        if paired:  # phase 4 draws the pairs after (a) and (b)'s reads
            cs.homolog_reads(rng, cs.homolog_genes(np.random.default_rng(7)),
                             cs.N_HOMOLOG_READS)
            reads = cs.pair_reads(rng, genes, cs.N_PAIRS)
        else:
            reads = (reads,)
        fa, files = cs.write_workload(d, genes, b"GENE", *reads, subsets=())
        want = None
        for s, side in enumerate(sides):  # warm-up: builds each checkout
            _, ssv = run(side, d, fa, files, f"warm{s}")
            want = want if want is not None else ssv
            if ssv != want:
                raise SystemExit(f"{side}: ssv differs from {sides[0]}'s")
        rates = {side: [] for side in sides}
        for p in range(pairs):
            order = sides if p % 2 == 0 else sides[::-1]
            for side in order:
                rate, ssv = run(side, d, fa, files, "run")
                if ssv != want:
                    raise SystemExit(f"{side}: ssv differs")
                rates[side].append(rate)
                print(f"pair {p} {side}: {rate:.0f} reads/s", flush=True)
        wins = sum(b > a for a, b in zip(*rates.values()))
        for side in sides:
            lo, med, hi = quartiles(rates[side])
            print(f"{side}: median {med:.0f} reads/s, quartiles {lo:.0f} "
                  f"- {hi:.0f}, runs {len(rates[side])}")
        print(f"{sides[1]} faster in {wins} of {pairs} pairs")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
