#!/usr/bin/env python3
"""Time the front end (K1), the hashed probe (K2), the finish (K3), the
pair stream (K4), the classic probe (K5), the xl probe (K6) and the
sharded router, owner probe and return (K7a, K7b, K7c) of shark_tpu_torch
on one CUDA card, kernel by kernel.

    python3 scripts/time_front_finish.py [CHECKOUT]

CHECKOUT is the root of the checkout whose kernels are timed (default: the
one holding this script), so that two commits can be held side by side in
one run on one card; the helpers (workloads, timers, the bare gathers)
come from this script's own chip_smoke.py. Each kernel is first checked
against its plain version, then printed: its CUDA-event time as
chip_smoke.py takes it (median of 7, L2 flushed), the host time of one
wrapper call (50 calls without a synchronisation), and the device time of
each kernel and memset the wrapper launches (torch.profiler, L2 warm, mean
over the records of 7 calls, with the count of records).

K1, K2, K3 and K4 run on the homolog panel's index of chip_smoke.py
(k 17, 2^33 Bloom bits) at B x L in {8192 x 104, 65536 x 104,
65536 x 208}; K6 on chip_smoke.py's 50,000-gene transcriptome index (xl
layout with a side table) at 8192 x 104 and 65536 x 104, where at 65536
it also prints chip_smoke.py's footprint runs (every bucket masked into
the table's first 32 MB or 256 MB, the whole table, no side table; the
masked runs are wrong and timing only) beside the bare 16-byte gather at
the same buckets; K5 on that index's classic tables, and K7a-c on that
index split into 8 shards on the card (K7b on the slots the owners
receive from K7a, K7c on the replies, in place where CHECKOUT's return
takes strides, and the exchange back's contiguous copy of the replies
that the one-card path made before), at 8192 x 104 and 65536 x 104.
"""

import argparse
import functools
import importlib.util
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

OWN_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SHAPES = [(8192, 104), (65536, 104), (65536, 208)]
XL_SHAPES = [(8192, 104), (65536, 104)]
REPS = 7


def device_breakdown(cs, fn):
    """{kernel name: (device ms per recorded launch, records)} over REPS
    calls; fewer records than REPS means the profiler missed some."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    timers = cs.own_timers()
    return {timers.op_name(e.key): (round(t / e.count / 1e3, 4), e.count)
            for e, t in timers.device_records(prof)}


def host_us(fn, n=50):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def report(cs, tag, fn, timer):
    print(f"{tag}: event_ms={timer(fn):.4f} host_us={host_us(fn):.1f} "
          f"device_ms={device_breakdown(cs, fn)}", flush=True)


def time_homolog(cs, timer):
    """K1, K3 and K4 on the homolog panel's index."""
    from shark_tpu_torch.classify import hashed, step
    from shark_tpu_torch.classify.step import Classifier
    from shark_tpu_torch.index.build import build_index

    genes = cs.homolog_genes(np.random.default_rng(7))
    index = build_index([(f"H{g:05d}", s.tobytes())
                         for g, s in enumerate(genes)], cs.K, cs.BF_GB << 33)
    clf = Classifier(index, max_winners=16, c=cs.C)
    rng = np.random.default_rng(2024)
    for B, L in SHAPES:
        meta, thresh = clf._geometry(L)
        codes = torch.from_numpy(cs.codes_for_shape(rng, genes, B, L)).cuda()
        packed, vmask = step.pack_codes(codes)
        front = functools.partial(step.front_end, packed, vmask, meta)
        k1 = front()
        cs.same("front_end", k1, step.front_end_plain(packed, vmask, meta))
        hi, lo, valid, length = k1
        args2 = (hi, lo, valid, clf.dix.table, clf.dix.stash, clf._hmeta)
        # the count of stash rows the kernel reads, where CHECKOUT's
        # wrapper takes it
        rows = getattr(clf.dix, "stash_rows", None)
        probe = functools.partial(hashed.probe_hashed, *args2,
                                  *(() if rows is None else (rows,)))
        tagv, payv = probe()
        cs.same("probe_hashed", (tagv, payv),
                hashed.probe_hashed_plain(*args2))
        kw = dict(rows3=clf.dix.rows3, ext_mat=clf.dix.ext_mat, meta=meta,
                  max_winners=16, L=L, has_rows=clf._hmeta.has_rows)
        finish = functools.partial(step.finish_from_tags, tagv, payv, length,
                                   thresh, **kw)
        k3 = finish()
        cs.same("finish_from_tags", k3[:3],
                step.finish_from_tags_plain(tagv, payv, length, thresh,
                                            **kw)[:3])
        cap, total = cs.pair_cap(k3[0], B, 16)
        pairs = functools.partial(step.extract_pairs, k3[0], k3[1], cap)
        cs.same("extract_pairs", [pairs()],
                [step.extract_pairs_plain(k3[0], k3[1], cap)])
        report(cs, f"B={B} L={L} front", front, timer)
        report(cs, f"B={B} L={L} probe", probe, timer)
        report(cs, f"B={B} L={L} finish", finish, timer)
        report(cs, f"B={B} L={L} pairs (pairs {total}, cap {cap})", pairs,
               timer)


def txome_xl(cs):
    """(genes, the xl Classifier) of chip_smoke.py's transcriptome."""
    from shark_tpu_torch.classify.step import Classifier
    from shark_tpu_torch.io import native

    work = os.path.join(OWN_ROOT, "build", "time_xl")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        genes = cs.txome_genes(np.random.default_rng(2026))
        fa = os.path.join(work, "genes.fa")
        cs.write_fasta(fa, genes, b"G")
        tindex = native.build_index_native(fa, cs.K, cs.BF_GB << 33,
                                           threads=os.cpu_count())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    xclf = Classifier(tindex, max_winners=16, c=cs.C)
    assert xclf.probe == "xl" and xclf._hmeta.has_side
    return genes, xclf


def xl_windows(cs, xclf, genes, rng, B, L):
    """Front-end windows of B transcriptome reads at L on the card."""
    from shark_tpu_torch.classify import step

    meta, _ = xclf._geometry(L)
    codes = torch.from_numpy(cs.codes_for_shape(
        rng, genes, B, L, single=cs.panel_reads)).cuda()
    return step.front_end(*step.pack_codes(codes), meta)[:3]


def time_xl(cs, timer):
    """K6 on the transcriptome index, and its footprint at B = 65536."""
    from shark_tpu_torch.classify import hashed

    gathers = cs.Gathers()
    genes, xclf = txome_xl(cs)
    dix, hmeta = xclf.dix, xclf._hmeta
    rng = np.random.default_rng(2025)
    for B, L in XL_SHAPES:
        wins = xl_windows(cs, xclf, genes, rng, B, L)
        args6 = (*wins, dix.table, dix.side, dix.side_stash, hmeta)
        xl = functools.partial(hashed.probe_xl, *args6)
        cs.same("probe_xl", xl(), hashed.probe_xl_plain(*args6))
        report(cs, f"B={B} L={L} xl", xl, timer)
        if B == 65536:
            fp = cs.xl_footprint(args6, hmeta, gathers)
            print(f"B={B} L={L} xl footprint (event ms, device ms, "
                  f"back-to-back ms): "
                  f"{json.dumps(fp)}", flush=True)
    return genes, xclf


def time_classic(cs, genes, xclf, timer):
    """K5 on the transcriptome index's classic tables."""
    from shark_tpu_torch.classify import step
    from shark_tpu_torch.classify.step import Classifier

    cclf = Classifier(xclf.index, max_winners=16, c=cs.C, probe="classic")
    rng = np.random.default_rng(2025)
    for B, L in XL_SHAPES:
        args5 = (*xl_windows(cs, xclf, genes, rng, B, L), cclf.dix.bf_rank,
                 cclf.dix.pay)
        classic = functools.partial(step.probe_tags, *args5)
        cs.same("probe_tags", classic(), step.probe_tags_plain(*args5))
        report(cs, f"B={B} L={L} classic", classic, timer)


def time_sharded(cs, genes, xclf, timer):
    """K7a, K7b and K7c with the transcriptome index split into cs.SHARDS
    shards on the card, on front-end windows."""
    from shark_tpu_torch.parallel import sharded_bf as sb

    n = cs.SHARDS
    dev = torch.device("cuda", 0)
    sclf = sb.ShardedBFClassifier(xclf.index, max_winners=16, c=cs.C,
                                  devices=[dev] * n)
    tables = sclf.dix[dev]
    rng = np.random.default_rng(2028)
    for B, L in XL_SHAPES:
        wins = [t.reshape(n, B // n, -1) for t in
                xl_windows(cs, xclf, genes, rng, B, L)]
        kw = dict(n=n, wps=sclf.wps, wide=False,
                  cap=sclf._probe_cap(B // n, L))
        route = functools.partial(sb.shard_route, *wins, **kw)
        send, slot, owner, _ = route()
        cs.same("shard_route", (send, slot, owner),
                sb.shard_route_plain(*wins, **kw)[:3])
        recv = cs._transposed(send)
        args = (recv, tables.bf_rank, tables.pay)
        probe = functools.partial(sb.shard_probe, *args)
        reply = probe()
        cs.same("shard_probe", [reply], [sb.shard_probe_plain(*args)])
        # the replies in place where CHECKOUT's return takes strides (as
        # its classifier passes them on one card), else their copy
        in_place = hasattr(sb, "_check_back")
        back = reply.transpose(0, 1) if in_place else cs._transposed(reply)
        ret = functools.partial(sb.shard_return, back, owner, slot)
        cs.same("shard_return", ret(), sb.shard_return_plain(back, owner,
                                                             slot))
        where = f"B={B} L={L}"
        report(cs, f"{where} shard_route ({n} shards, cap {kw['cap']})",
               route, timer)
        report(cs, f"{where} shard_probe ({n} shards)", probe, timer)
        report(cs, f"{where} shard_return ({n} shards, replies "
               f"{'in place' if in_place else 'copied'})", ret, timer)
        report(cs, f"{where} exchange back (the replies' contiguous copy)",
               functools.partial(cs._transposed, reply), timer)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkout", nargs="?", default=OWN_ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this script times the kernels on the card",
              file=sys.stderr)
        return 1
    root = os.path.abspath(args.checkout)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(OWN_ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from shark_tpu_torch import kernels
    from shark_tpu_torch.io import native
    from shark_tpu_torch.utils.timers import cuda_ms

    native.rebuild()  # a library built on another host may not load here
    kernels.build(force=True)
    kernels.lib()
    timer = functools.partial(cuda_ms, reps=REPS)
    print(f"{root}: {torch.cuda.get_device_name(0)}", flush=True)
    time_homolog(cs, timer)
    genes, xclf = time_xl(cs, timer)
    time_classic(cs, genes, xclf, timer)
    time_sharded(cs, genes, xclf, timer)
    return 0


if __name__ == "__main__":
    sys.exit(main())
