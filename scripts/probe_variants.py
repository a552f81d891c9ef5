#!/usr/bin/env python3
"""Time variants of the hashed probe (K2, csrc/probe.cu) and of the sharded
owner probe (K7b, shard_probe_kernel in csrc/route.cu) of shark_tpu_torch
on one CUDA card, in one process, each on one allocation of the same
tables and the same windows or received slots, beside what they are held
to.

    python3 scripts/probe_variants.py [OTHER_CHECKOUT ...]

Every variant is built by nvcc into a library of its own under
build/variants/ and called through its C entry point, and is first
held to the plain version (exact); then all are timed back to back (20
launches between two CUDA events, L2 warm) in two rounds of alternating
order.

K2: this checkout's csrc/probe.cu and each OTHER_CHECKOUT's (another
commit, such as the parent), on chip_smoke.py's homolog index at
B = 65536, L = 104 with its stash and with a stash of 32 padding rows
(wrong results where a window matches a stash row: timing only), beside
P2's kernel (resident_match) on the same buckets and keys, which is K2's
bucket work without the stash; then each variant's device time with the
stash, and P2's (torch.profiler, L2 warm).

K7b: this checkout's csrc/route.cu with K7b taking 1, 2 or 4 received
slots a thread (kProbeSlots; every (word, rank) load of a thread issued
before its first pay load) and its table loads plain (ld.global, as
committed) or through the read-only path without L1 allocation
(ld.global.nc.L1::no_allocate), and each OTHER_CHECKOUT's csrc/route.cu
that differs from this one, on chip_smoke.py's transcriptome index split
into 8 shards on the card, on the slots K7a routes from B = 65536 reads
at L = 104, on the whole tables and with every routed word masked into
each shard's first 4 MB of (word, rank) rows (wrong results, timing
only), beside chip_smoke.py's bare two-level gather (word rows, then the
hits' pay rows, dependent) and the bare 8-byte gathers of the same rows.
Then, as a measurement only, the two-level gather, the 8-byte gathers
and the committed kernel again with the device's
cudaLimitMaxL2FetchGranularity set to 32 bytes, then restored: that
limit is device-wide, and no code of the port sets it.
"""

import ctypes
import os
import re
import sys

import numpy as np
import torch

OWN_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, OWN_ROOT)

import chip_smoke as cs  # noqa: E402
import time_front_finish as tff  # noqa: E402
from shark_tpu_torch import kernels  # noqa: E402
from shark_tpu_torch.io import native  # noqa: E402
from shark_tpu_torch.parallel import sharded_bf as sb  # noqa: E402

timers = cs.own_timers()

B, L = 65536, 104
SLOTS = re.compile(r"constexpr int kProbeSlots = \d+;")
LOAD = '#define SHKK_PROBE_LOAD "ld.global.v2.u32"'
LOAD_NC = '#define SHKK_PROBE_LOAD "ld.global.nc.L1::no_allocate.v2.u32"'
# the entry point before it took the owner count (one thread a slot)
OLD_SIGNATURE = re.compile(r"shkk_shard_probe\(const void\* recv, long long "
                           r"per_owner,\s+long long total")


def source(root, name):
    """(text, include dir) of csrc/<name> in the checkout at root."""
    csrc = os.path.join(os.path.abspath(root), "shark_tpu_torch", "csrc")
    with open(os.path.join(csrc, name)) as f:
        return f.read(), csrc


def route_variants(others):
    """{name: (build waiter, takes the owner count)} of K7b's variants."""
    src, inc = source(OWN_ROOT, "route.cu")
    assert SLOTS.search(src) and LOAD in src
    texts = {}
    for slots in (1, 2, 4):
        for load in ("plain", "nc"):
            text = SLOTS.sub(f"constexpr int kProbeSlots = {slots};", src)
            if load == "nc":
                text = text.replace(LOAD, LOAD_NC)
            texts[f"s{slots}_{load}"] = (text, inc)
    for k, other in enumerate(others):
        text, oinc = source(other, "route.cu")
        if text != src:
            texts[f"other{k}"] = (text, oinc)
    out = {}
    for name, (text, inc) in texts.items():
        owners = OLD_SIGNATURE.search(text) is None
        argtypes = kernels._SIGNATURES["shkk_shard_probe"]
        if not owners:
            argtypes = [ctypes.c_void_p, ctypes.c_longlong, *argtypes[2:]]
        out[name] = (kernels.build_variant(
            f"route_{name}", text, inc, "shkk_shard_probe", argtypes), owners)
    return out


def probe_variants(others):
    """{name: (build waiter, takes n_real)} of K2's variants."""
    out = {}
    for k, root in enumerate([OWN_ROOT, *others]):
        text, inc = source(root, "probe.cu")
        new = "int n_real," in text
        argtypes = kernels._SIGNATURES["shkk_probe"]
        if not new:  # the entry point before it took n_real
            argtypes = argtypes[:10] + argtypes[11:]
        name = "committed" if k == 0 else f"other{k - 1}"
        out[name] = (kernels.build_variant(
            f"probe_{name}", text, inc, "shkk_probe", argtypes), new)
    return out


def route_caller(fn, owners, tables):
    """recv -> reply through one K7b variant; `owners`: its entry point
    takes (recv, owner count, slots an owner) rather than (recv, slots an
    owner, all slots)."""
    def call(recv):
        reply = torch.empty_like(recv)
        per_owner = recv.shape[1] * recv.shape[2]
        first = recv.shape[0] if owners else per_owner
        second = per_owner if owners else recv.shape[0] * per_owner
        rc = fn(recv.data_ptr(), first, second, tables.bf_rank.data_ptr(),
                tables.bf_rank.shape[1], tables.pay.data_ptr(),
                tables.pay.shape[1], reply.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return reply
    return call


def alternate(calls, runs):
    """{run: {variant: (least, most) back-to-back ms}} over two rounds of
    alternating order; runs[run] maps a variant's call to a thunk."""
    names = list(calls)
    out = {}
    for run, bind in runs.items():
        times = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                times[name].append(timers.back_to_back_ms(bind(calls[name])))
        out[run] = {name: (min(t), max(t)) for name, t in times.items()}
    return out


def say_runs(runs):
    for run, t in runs.items():
        print(f"  {run:>13}: " + "  ".join(
            f"{name} {a:.4f}/{b:.4f}" for name, (a, b) in t.items()),
            flush=True)


def time_probe(built):
    """K2's variants on the homolog index at B x L."""
    from shark_tpu_torch.classify import hashed, step
    from shark_tpu_torch.classify.step import Classifier
    from shark_tpu_torch.experiments import resident_match as R
    from shark_tpu_torch.index.build import build_index

    genes = cs.homolog_genes(np.random.default_rng(7))
    index = build_index([(f"H{g:05d}", s.tobytes())
                         for g, s in enumerate(genes)], cs.K, cs.BF_GB << 33)
    clf = Classifier(index, max_winners=16, c=cs.C)
    dix, hmeta = clf.dix, clf._hmeta
    meta, _ = clf._geometry(L)
    codes = torch.from_numpy(cs.codes_for_shape(
        np.random.default_rng(2024), genes, B, L)).cuda()
    hi, lo, valid, _ = step.front_end(*step.pack_codes(codes), meta)
    want = hashed.probe_hashed_plain(hi, lo, valid, dix.table, dix.stash,
                                     hmeta)
    calls = {name: kernels.probe_variant_caller(fn(), new, dix.table,
                                                hmeta)
             for name, (fn, new) in built.items()}
    for name, call in calls.items():
        cs.same(f"probe_hashed variant {name}",
                call(hi, lo, valid, dix.stash, dix.stash_rows), want)
    pad = torch.full((32, 4), -1, dtype=torch.int32,
                     device=lo.device).view(torch.uint32)
    rows, wantp = cs.resident_operands(hi, lo, valid, hmeta.lgB)
    t128 = dix.table.view(-1, 128)
    print(f"hashed probe: {torch.cuda.get_device_name(0)}; B={B} L={L}, "
          f"{lo.numel()} windows, {int(valid.sum())} valid, stash "
          f"{dix.stash_rows} of {dix.stash.shape[0]} rows; all variants "
          f"exact; back-to-back ms (L2 warm):", flush=True)
    runs = {
        "stash": lambda c: lambda: c(hi, lo, valid, dix.stash,
                                     dix.stash_rows),
        "padding stash": lambda c: lambda: c(hi, lo, valid, pad, 0),
    }
    say_runs(alternate(calls, runs))
    print("  device ms (torch.profiler), stash: " + "  ".join(
        f"{name} {cs.device_profile(runs['stash'](c))['device_ms']:.4f}"
        for name, c in calls.items()), flush=True)

    def p2():
        return R.resident_match(rows, wantp, t128)
    print(f"  resident_match (P2) on the same buckets: back-to-back "
          f"{timers.back_to_back_ms(p2):.4f}, device "
          f"{cs.device_profile(p2)['device_ms']:.4f}",
          flush=True)


def time_shard_probe(fns):
    """K7b's variants with the transcriptome index in 8 shards on the
    card, and the floors, also at an L2 fetch granularity of 32 bytes."""
    gathers = cs.Gathers()
    genes, xclf = tff.txome_xl(cs)
    n = cs.SHARDS
    dev = torch.device("cuda", 0)
    sclf = sb.ShardedBFClassifier(xclf.index, max_winners=16, c=cs.C,
                                  devices=[dev] * n)
    tables, wps = sclf.dix[dev], sclf.wps
    hi, lo, valid = (t.reshape(n, B // n, -1) for t in tff.xl_windows(
        cs, xclf, genes, np.random.default_rng(2028), B, L))
    send = sb.shard_route(hi, lo, valid, n=n, wps=wps, wide=False,
                          cap=sclf._probe_cap(B // n, L))[0]
    recv = cs._transposed(send)
    want = sb.shard_probe_plain(recv, tables.bf_rank, tables.pay)
    calls = {name: route_caller(fn, owners, tables)
             for name, (fn, owners) in fns.items()}
    for name, call in calls.items():
        cs.same(f"shard_probe variant {name}", [call(recv)], [want])
    masked = cs.masked_words(recv, wps, 19)
    widx, pidx, hit = cs.owner_probe_rows(recv, tables, wps)
    widx, pidx = widx.to(torch.int32), pidx.to(torch.int32)
    ridx = pidx[hit]
    print(f"owner probe: {torch.cuda.get_device_name(0)}; B={B} L={L}, "
          f"{n} shards, {recv.numel() // 2} slots, {widx.numel()} routed, "
          f"{ridx.numel()} hits; all variants exact; back-to-back ms "
          f"(L2 warm):", flush=True)
    say_runs(alternate(calls, {
        "full": lambda c: lambda: c(recv),
        "4MB": lambda c: lambda: c(masked),
    }))

    def floors():
        return {
            "two_level": timers.back_to_back_ms(lambda: gathers.two_level(
                tables.bf_rank, widx, tables.pay, pidx)),
            "gather_words": timers.back_to_back_ms(
                lambda: gathers.rows(tables.bf_rank, widx, 8)),
            "gather_pays": timers.back_to_back_ms(
                lambda: gathers.rows(tables.pay, ridx, 8)),
            "committed": timers.back_to_back_ms(
                lambda: sb.shard_probe(recv, tables.bf_rank, tables.pay)),
        }
    was = gathers.l2_fetch_granularity()
    print(f"  floors at the default L2 fetch granularity ({was} bytes): "
          f"{floors()}", flush=True)
    try:
        gathers.l2_fetch_granularity(32)
        print(f"  floors at an L2 fetch granularity of 32 bytes: "
              f"{floors()}", flush=True)
    finally:
        gathers.l2_fetch_granularity(was)
    print(f"  restored to {gathers.l2_fetch_granularity()} bytes; default "
          f"again: {floors()}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this script times kernels on the card",
              file=sys.stderr)
        return 1
    native.rebuild()  # a library built on another host may not load here
    others = sys.argv[1:]
    probes = probe_variants(others)  # every nvcc started here
    routes = route_variants(others)
    time_probe(probes)
    time_shard_probe({name: (fn(), owners)
                      for name, (fn, owners) in routes.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
