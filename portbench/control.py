#!/usr/bin/env python3
"""The two sides of a cell's correctness check that must come out false.

The control: the plain reference with the strand guarantee broken
(forward k-mers only, as a front end that skipped the reverse complement
would hash them) put in the program's place, at the cell's own size, and
compared as a run compares the program. The faults: the program's timed
path broken underneath (the drain's winner pairs), run through the
harness's own window and verdict:
    half_batch  the answers of the second half of every batch left out
    answer      one gene id of every batch altered where the drain makes it

    python3 portbench/control.py --workload <cell> --seeds 11 12 13
    python3 portbench/control.py --workload <cell> --seeds 11 \\
        --fault half_batch --seconds 5

One line a seed: {"seed", "correct", the numbers compared, "seconds"};
`correct` is the harness's verdict and must be false. Needs a CUDA card
(--cpu rehearses the control on the CPU, for tests)."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import run as harness  # noqa: E402
from portbench.reference import shark as ref  # noqa: E402

FAULTS = ("half_batch", "answer")


def control_checks(cell, paths, device) -> dict:
    """The numbers compared, with the control in the program's place."""
    want = harness.reference(cell, paths, device)
    ctl = harness.reference(cell, paths, device, canonical=False)
    ssv, fastq = ref.render(*ctl)
    counts = [(len(ctl[2]), len(set(ctl[2].tolist())))]
    return harness.checks(want, ssv, fastq, counts)


def plant(fault: str) -> None:
    """Break the program's drain in this process: every later pass of
    run_pipeline hands the emit the faulty winner pairs."""
    import numpy as np
    from shark_tpu_torch import pipeline

    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    real = pipeline._winner_pairs

    def faulty(cfg, index, result, n, *a, **kw):
        ri, gi = real(cfg, index, result, n, *a, **kw)
        if fault == "half_batch":
            keep = ri < n // 2
            return ri[keep], gi[keep]
        if len(gi):
            gi = np.array(gi, copy=True)
            gi[len(gi) // 2] = (gi[len(gi) // 2] + 1) % index.n_genes
        return ri, gi

    pipeline._winner_pairs = faulty


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=FAULTS)
    p.add_argument("--seconds", type=float, default=5.0,
                   help="the window of a fault's run")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    device = "cpu" if args.cpu else "cuda:0"
    cell = harness.Cell.find(ROOT, args.workload)
    cache = os.path.join(ROOT, "build", "portbench", "inputs")
    if args.fault:
        plant(args.fault)
    for seed in args.seeds:
        t = time.perf_counter()
        if args.fault:
            result = harness.run(harness.parse_args([
                "--workload", cell.name, "--seed", str(seed), "--seconds",
                str(args.seconds), "--trace", "0"]), allow_cpu=args.cpu)
            out = {k: v["value"] for k, v in result["checks"].items()}
            line = {"fault": args.fault, "attempted": result["attempted"],
                    "failed": result["failed"]}
        else:
            out = control_checks(cell, harness.inputs(cell, seed, cache),
                                 device)
            line = {}
        print(json.dumps({"seed": seed, "correct": harness.verdict(out),
                          **line, **out,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
