#!/usr/bin/env python3
"""The group path's impure-read cap on one CUDA card: the port's
counterpart of bench/ab_fixcap.py and bench/ab_fixdiv.py.

    python3 scripts/ab_fixcap_torch.py [--reads N] [--reps R] [--cpu]
        [--cache DIR]

In the reference FIX_DIV sized the sub-batch of impure reads that its
finish re-scored. The port's finish (K3, csrc/finish.cu) keeps only
FIX_CAP2 (step.fix_caps: FIX_CAP = min(B, max(64, B // FIX_DIV)), FIX_CAP2
= min(B, max(FIX_CAP, B // FIX_DIV2))): a batch with at most FIX_CAP2
impure row-hitting reads gives its pure reads their GROUP verdicts, a
heavier one gives every read its full verdict. On the first two batches
of bench_gpu.py's homolog workload (B = 65536, L = 104):

(a) the reference's sweep: fix_caps(B) for FIX_DIV 16, 64, 128 and 256
    (FIX_DIV2 as committed), computed here, not by changing the
    package's constants; at B = 65536 every one gives one FIX_CAP2, so
    K3 gets the same cap each time and one timing (b's production row)
    stands for all four;
(b) what the cap decides: fix_cap2 at 0, 64, 128, 256, 1024, 4096
    (production) and 65536, passed to Classifier.finish as the port's
    wrapper takes it, on each batch's tags (Classifier.tags). Each row
    gives the batch's impure count and the branch taken, the GROUP-bit
    count, K3's device ms split by op (timers.device_profile, least of
    three sessions held against the back-to-back time; *_suspect where
    none agrees), K4's device ms and pair count (step.extract_pairs on
    the verdicts, at the pipeline's quantised capacity, chip_smoke.py
    pair_cap), the host's pipeline._winner_pairs ms on the fetched
    packed verdicts (best of 5; the pair stream or winner matrix it asks
    for is fetched inside it, as in the pipeline), and the (read, gene)
    associations it yields.

Checks: at every cap the verdicts (packed, winners, best_cov) equal the
plain finish given the same cap; at every cap on production's side of the
impure count (at or above it, while production's cap is) they equal
production's; below it no GROUP bit is set; the four FIX_DIV values give
one FIX_CAP2. The associations per cap are a finding, not a
check: with max_winners 16 and families of 8 both branches may agree or
not. No default changes: FIX_DIV and FIX_DIV2 decide verdict bits and
stay shark_tpu's values.

Runs on cuda:0; --cpu runs the plain versions (no timing); without a card
and without --cpu it exits 1. Prints one JSON line with every reading and
a `checks` map; exits 1 when a check fails. --reads N and --cache DIR as
in scripts/profile_e2e_torch.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]

import torch  # noqa: E402

import bench_gpu  # noqa: E402
import profile_e2e_torch as pe  # noqa: E402
from chip_smoke import pair_cap  # noqa: E402
import profile_front_torch as pf  # noqa: E402
from shark_tpu_torch import pipeline  # noqa: E402
from shark_tpu_torch.classify import step  # noqa: E402

FIX_DIVS = (16, 64, 128, 256)
CAPS = (0, 64, 128, 256, 1024, 4096, 65536)
BATCHES = 2


def log(msg: str) -> None:
    print(f"[ab_fixcap] {msg}", file=sys.stderr, flush=True)


def fix_caps_at(B: int, fix_div: int, fix_div2: int = step.FIX_DIV2):
    """step.fix_caps(B) with FIX_DIV = fix_div (the reference's sweep)."""
    fix_cap = min(B, max(64, B // fix_div))
    return fix_cap, min(B, max(fix_cap, B // fix_div2))


def sweep(B: int) -> dict:
    """(a): the caps of each FIX_DIV at batch size B."""
    rows = {str(d): dict(zip(("fix_cap", "fix_cap2"), fix_caps_at(B, d)))
            for d in FIX_DIVS}
    return {"batch_size": B, "fix_div2": step.FIX_DIV2, "by_fix_div": rows,
            "production": dict(zip(("fix_cap", "fix_cap2"),
                                   step.fix_caps(B))),
            "one_fix_cap2": len({r["fix_cap2"] for r in rows.values()}) == 1}


def winner_pairs_ms(cfg, clf, res, n: int, batch, reps: int = 5):
    """(best ms of pipeline._winner_pairs on the fetched packed verdicts,
    its association count)."""
    packed_np = res[0].cpu().numpy()
    best, count = None, None
    for _ in range(reps):
        t0 = time.perf_counter()
        ri, _ = pipeline._winner_pairs(cfg, clf.index, res, n, batch,
                                       cfg.max_winners, packed_np=packed_np,
                                       groups=clf.groups)
        ms = (time.perf_counter() - t0) * 1e3
        best = ms if best is None else min(best, ms)
        count = int(ri.size)
    return best, count


def cap_row(cfg, clf, tags, cap: int, impure: int, n: int, batch, want,
            on_card: bool, reps: int) -> dict:
    """One cap on one batch: (b)'s readings and its checks."""
    tagv, payv, length, L = tags
    meta, thresh = clf._geometry(L)
    res = clf.finish(tags, fix_cap2=cap)
    B, W = tagv.shape[0], clf.max_winners
    grp = int(((res[0] >> step.PACK_GRP_SHIFT) & 1).sum())
    group_branch = impure <= cap
    row = {"fix_cap2": cap, "impure": impure,
           "branch": "group" if group_branch else "full",
           "group_bits": grp}
    if group_branch == (impure <= step.fix_caps(B)[1]):
        row["verdicts_equal_production"] = all(
            torch.equal(x, y) for x, y in zip(res[:3], want[:3]))
    if not group_branch:
        row["no_group_bits"] = grp == 0
    plain = step.finish_from_tags_plain(
        tagv, payv, length, thresh, rows3=clf.dix.rows3,
        ext_mat=clf.dix.ext_mat, meta=meta, max_winners=W, L=L,
        has_rows=clf._has_rows, fix_cap2=cap)
    row["verdicts_equal_plain"] = all(
        torch.equal(x, y) for x, y in zip(res[:3], plain[:3]))
    cap4, pairs = pair_cap(res[0], B, W)  # the pipeline's K4 capacity
    row.update(pairs=pairs, pair_cap=cap4)
    row["winner_pairs_ms"], row["associations"] = winner_pairs_ms(
        cfg, clf, res, n, batch)
    if on_card:
        p3 = pf.device_ms(lambda: clf.finish(tags, fix_cap2=cap), reps)
        row.update(k3_device_ms=p3["device_ms"],
                   k3_device_ops=p3["device_ops"])
        if "device_ms_suspect" in p3:
            row["k3_device_ms_suspect"] = p3["device_ms_suspect"]
        p4 = pf.device_ms(lambda: step.extract_pairs(res[0], res[1], cap4),
                          reps)
        row["k4_device_ms"] = p4["device_ms"]
        if "device_ms_suspect" in p4:
            row["k4_device_ms_suspect"] = p4["device_ms_suspect"]
    return row


def first_batches(cfg, k: int):
    """[(packed, vmask, reads)] of cfg's first k batches, copied."""
    out = []
    ns = pe.open_stream(cfg)
    try:
        while len(out) < k:
            nb = ns.next_batch()
            if nb is None:
                break
            packed, vmask, slot, n = nb
            out.append((packed.copy(), vmask.copy(), n))
            ns.release(slot)
    finally:
        ns.close()
    return out


def impure_count(clf, tags) -> int:
    """The batch's impure row-hitting reads: K3's group pass on the card,
    its plain version on the CPU (step.finish_group_count)."""
    n_fix = torch.zeros(1, dtype=torch.int32, device=tags[0].device)
    clf.group_count(tags, n_fix)
    return int(n_fix.item())


def run(device, reps: int) -> dict:
    on_card = device.type == "cuda"
    b = bench_gpu.Bench(device, float("inf"))
    cfg, clf = pe.workload_config(b, "homolog")
    out = {"workload": "homolog", "probe": clf.probe,
           "max_winners": clf.max_winners, "batches": []}
    checks = {}
    B = None
    for i, (packed, vmask, n) in enumerate(first_batches(cfg, BATCHES)):
        pk = torch.from_numpy(packed).to(device)
        vm = torch.from_numpy(vmask).to(device)
        tags = clf.tags(pk, vm)
        B = tags[0].shape[0]
        impure = impure_count(clf, tags)
        want = clf.finish(tags)
        rows = [cap_row(cfg, clf, tags, c, impure, n, (packed, vmask), want,
                        on_card, reps) for c in CAPS]
        for r in rows:
            for k in ("verdicts_equal_production", "no_group_bits",
                      "verdicts_equal_plain"):
                if k in r:
                    checks[f"batch{i}_cap{r['fix_cap2']}_{k}"] = r[k]
            log(json.dumps({k: v for k, v in r.items()
                            if k != "k3_device_ops"}))
        out["batches"].append({"batch": i, "batch_size": B, "reads": n,
                               "impure": impure, "caps": rows})
    out["sweep"] = sweep(B)
    checks["one_fix_cap2"] = out["sweep"]["one_fix_cap2"]
    out["checks"] = checks
    return out


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=bench_gpu.N_READS)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU (no timing)")
    ap.add_argument("--cache", default="")
    args = ap.parse_args(argv)
    if device is None:
        if args.cpu:
            device = "cpu"
        elif torch.cuda.is_available():
            device = "cuda:0"
        else:
            print("ab_fixcap_torch: no CUDA card; the A/B runs on the card "
                  "(--cpu runs the plain versions)", file=sys.stderr)
            return 1
    device = torch.device(device)
    pe.size_workloads(args.reads, args.cache)
    line = run(device, args.reps)
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
