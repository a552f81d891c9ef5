#!/usr/bin/env python3
"""K6's and K5's device time by sub-stage on one CUDA card, and the
XL_SLOTS = 2 layout: the port's counterpart of bench/profile_xl.py and
bench/profile_txome.py.

    python3 scripts/profile_txome_torch.py [--genes N] [--quick]
        [--reads N] [--reps R] [--warm-only] [--cpu] [--cache DIR]

The batch is the first of bench_gpu.py's txome (50,000 genes, seed 7; the
reference's [n_genes] is --genes), B = 65536, L = 104, on
Bench.classifier's production xl tables and on the classic tables built
from the same index (classify/step.py build_device_index). Each rung is a
timing-only variant of the committed source, made at run time by checked
substitutions (every anchor found exactly once, else the script raises;
scripts/profile_front_torch.py's helpers), built by nvcc into
build/variants/profile_txome_torch/<rung>/ and launched through
kernels.xl_variant_caller or kernels.classic_variant_caller. No variant is
a kernel of the port.

K6 (csrc/xl.cu), cumulative:
    g   the main 16-byte bucket load of the valid windows, its words
        folded into tagv (no match, no side table)
    x   g + the match; no side resolve (the entry point takes has_side
        0), so a window that needs the side table gets a wrong result:
        timing only, held equal to s on every other window
    s   the whole K6 with its side resolve: its text is the committed
        source; must equal hashed.probe_xl and probe_xl_plain
K5 (csrc/classic.cu), cumulative:
    r   the (word, rank) row alone: hit and rank written, no pay load
        (and no miss word); its hits must be y's tagged windows
    y   the whole K5: its text is the committed source; must equal
        step.probe_tags and probe_tags_plain

Each rung gives its device ms (utils/timers.py device_profile, as in
scripts/profile_probe_torch.py) with the L2 warm and flushed (--warm-only:
warm alone), its delta from the rung below, its own bound (bytes over
3.35 TB/s or integer operations over 16.7 T/s, as chip_smoke.py counts
K6 and K5: 17 bytes a window for the streams; K6 a 16-byte row per
distinct bucket touched, 64 bytes per distinct side bucket and the side
stash, 2 operations a window for the address, 26 for the match, 32 + 4 S
+ 10 a side window; K5 an 8-byte (word, rank) row per distinct word, an
8-byte pay row per distinct hit rank, 8 operations a window for the rank
and 12 in all), the gap between them, its share of the whole kernel, and
its occupancy (blocks per SM exported by the variant; no shared memory).
`furthest` names the rung whose own piece is furthest above its bound.
Anchors on the same windows: K1 (step.front_end; the reference's x0
front), floors.rows of the same 16-byte buckets, and floors.two_level of
K5's rows (with floors.rows of its (word, rank) rows alone). Counts: the
flagged buckets and their share, the windows that take the side path.
The whole step: Classifier.call_packed's device ms for xl and classic on
the batch (the reference's s3/x4 full and c4), their verdicts equal.

XL_SLOTS = 2 (skipped with --quick): the xl table built by
hashed.build_hashed_xl with the module constant set to 2 (restored after,
as bench/profile_xl.py:271-273 and :339 do), its table's and side table's
GB and flagged share, and a variant of xl.cu that loads 8-byte rows and
matches two slots, held to the 4-slot production result on every window
and to probe_xl_plain, beside floors.rows of its 8-byte buckets. When the
build refuses (spill cap), the line says slots2_buildable: false.

Runs on cuda:0; --cpu runs the plain versions, the counts, the XL_SLOTS =
2 build and its plain result, and the text checks, and builds nothing;
without a card and without --cpu it exits 1. Prints one JSON line with
every reading and a `checks` map; exits 1 when a check fails. --reads N
and --cache DIR as in scripts/profile_e2e_torch.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bench_gpu  # noqa: E402
import profile_e2e_torch as pe  # noqa: E402
import profile_front_torch as pf  # noqa: E402
import profile_probe_torch as pp  # noqa: E402
from ab_layout_torch import first_batches  # noqa: E402
from shark_tpu_torch import floors, kernels  # noqa: E402
from shark_tpu_torch.classify import hashed, step  # noqa: E402
from shark_tpu_torch.classify.step import Classifier  # noqa: E402
from shark_tpu_torch.utils import timers  # noqa: E402

SCRIPT = "profile_txome_torch"
XL_RUNGS = ("g", "x", "s")
K5_RUNGS = ("r", "y")

ANCHOR_XL_MATCH = "  u32 tag[kWin], pay[kWin];\n  bool need[kWin];\n"
ANCHOR_XL_STORE = "  if (kVec && full) {\n    T t, p;\n"
ANCHOR_XL_ENTRY = "  if (n > 0) {\n    const XlArgs a{"
ANCHOR_XL_KERNEL = "// kVec: idx_lo, idx_hi, tagv and payv are aligned"
ANCHOR_XL_LOAD = ("    v[r] = valid[r] ? load_row(a.table + (u64)(lo[r] & "
                  "bmask))\n")
ANCHOR_XL_SLOTS = ("    for (int s = 0; s < 4; ++s) {\n"
                   "      const u32 meta = w[s] >> 16;\n")
ANCHOR_K5_MISS = "  const u32 miss = (pay[0].y & 0xFFFFu) << 16;\n"
ANCHOR_K5_PAY = ("    if (hit) pw = pay[wr.y + __popc(wr.x & ((1u << bit) - "
                 "1u))];\n")
ANCHOR_K5_OUT = "  const u32 tag = pw.x >> 30;\n"
ANCHOR_K5_END = "}\n\n}  // namespace"

XL_FOLD = """  u32 tag[kWin], pay[kWin];
#pragma unroll
  for (int r = 0; r < kWin; ++r) {  // timing only: the bucket folded
    tag[r] = lo[r] ^ v[r].x ^ v[r].y ^ v[r].z ^ v[r].w;
    pay[r] = hi[r];
  }

"""
XL_NO_SIDE = ("  if (n > 0) {\n    has_side = 0;  // timing only: no side "
              "resolve\n    const XlArgs a{")
XL_LOAD8 = """// XL_SLOTS = 2: one 8-byte row, as the 16-byte row's first half.
__device__ __forceinline__ uint4 load_row8(const uint2* p) {
  uint2 v;
  asm volatile("ld.global.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p));
  return make_uint4(v.x, v.y, 0u, 0u);
}

"""
K5_RANK = ("    pw.y = wr.y + __popc(wr.x & ((1u << bit) - 1u));  // timing "
           "only: the rank, no pay load\n")
K5_OUT = "  tagv[i] = hit ? 1u : 0u;\n  payv[i] = pw.y;\n"
XL_OCCUPANCY = """
extern "C" int shkk_xl_occupancy(int* blocks, int* smem) {
  *smem = 0;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, probe_xl_kernel<true>, kThreads, 0);
}
"""
K5_OCCUPANCY = """
extern "C" int shkk_classic_occupancy(int* blocks, int* smem) {
  *smem = 0;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, classic_kernel, kThreads, 0);
}
"""


def log(msg: str) -> None:
    print(f"[profile_txome] {msg}", file=sys.stderr, flush=True)


def xl_source(rung: str, text: str) -> str:
    """xl.cu (`text`) cut to `rung` (g, x, s, or slots2: s on 8-byte
    rows of two slots); s is the committed text."""
    what = "xl.cu"
    ro = pf.replace_once
    if rung == "s":
        return text
    if rung == "slots2":
        text = ro(text, ANCHOR_XL_KERNEL, XL_LOAD8 + ANCHOR_XL_KERNEL, what)
        text = ro(text, ANCHOR_XL_LOAD, ANCHOR_XL_LOAD.replace(
            "load_row(a.table", "load_row8(reinterpret_cast<const uint2*>("
            "a.table)"), what)
        return ro(text, ANCHOR_XL_SLOTS,
                  ANCHOR_XL_SLOTS.replace("s < 4", "s < 2"), what)
    text = ro(text, ANCHOR_XL_ENTRY, XL_NO_SIDE, what)
    if rung == "x":
        return text
    if rung == "g":
        return pf.replace_span(text, ANCHOR_XL_MATCH, ANCHOR_XL_STORE,
                               XL_FOLD, what)
    raise ValueError(f"unknown rung {rung!r}")


def classic_source(rung: str, text: str) -> str:
    """classic.cu (`text`) cut to `rung`; y is the committed text."""
    what = "classic.cu"
    if rung == "y":
        return text
    if rung == "r":
        text = pf.replace_once(text, ANCHOR_K5_MISS, "", what)
        text = pf.replace_once(text, ANCHOR_K5_PAY, K5_RANK, what)
        return pf.replace_span(text, ANCHOR_K5_OUT, ANCHOR_K5_END, K5_OUT,
                               what)
    raise ValueError(f"unknown rung {rung!r}")


def variant_texts() -> dict:
    """({rung: xl.cu variant}, {rung: classic.cu variant}), each with its
    occupancy export; raises profile_front_torch.VariantError when a
    committed source no longer holds an anchor once."""
    xl, k5 = pf.committed("xl.cu"), pf.committed("classic.cu")
    return ({r: xl_source(r, xl) + XL_OCCUPANCY
             for r in (*XL_RUNGS, "slots2")},
            {r: classic_source(r, k5) + K5_OCCUPANCY for r in K5_RUNGS})


def build_slots2(index):
    """build_hashed_xl with hashed.XL_SLOTS = 2, restored after, even when
    the build raises; None when it refuses (spill cap)."""
    old = hashed.XL_SLOTS
    try:
        hashed.XL_SLOTS = 2
        return hashed.build_hashed_xl(index)
    finally:
        hashed.XL_SLOTS = old


def xl_counts(hi, lo, valid, dix, hmeta) -> tuple:
    """K6's counts, the valid windows' buckets (i32) and the windows that
    take the side path."""
    bucket, rest = hashed._bucket_rest(pp.u64(lo), pp.u64(hi), hmeta.lgB)
    row = step.gather_u32(dix.table, bucket)
    _, _, matched = hashed._match16(row, rest, valid,
                                    (1 << hashed.XL_REST_BITS) - 1)
    need = valid & (((row[..., 0] >> hashed.XL_FLAG_BIT) & 1) == 1) & \
        ~matched if hmeta.has_side else torch.zeros_like(valid)
    del row
    flagged = int(((pp.u64(dix.table[:, 0]) >> hashed.XL_FLAG_BIT) & 1).sum())
    bidx = bucket[valid].to(torch.int32)
    side_b = pp.u64(lo)[need] & ((1 << hmeta.side_lgB) - 1)
    return {"windows": lo.numel(), "valid_windows": int(valid.sum()),
            "buckets_touched": int(torch.unique(bidx).numel()),
            "side_windows": int(need.sum()),
            "side_buckets_touched": int(torch.unique(side_b).numel()),
            "flagged_buckets": flagged,
            "flagged_share": flagged / dix.table.shape[0]}, bidx, need


def xl_bounds(c: dict, side_stash_rows: int) -> dict:
    n, ns, S = c["windows"], c["side_windows"], side_stash_rows
    streams = n * 17 + c["buckets_touched"] * 16
    side = c["side_buckets_touched"] * 64 + (S * 16 if ns else 0)
    match = n * (4 * 4 + 10)
    return {"g": pf.bound(streams, 2 * n), "x": pf.bound(streams, match),
            "s": pf.bound(streams + side,
                          match + ns * (4 * 8 + 4 * S + 10))}


def classic_rows(hi, lo, valid, bf_rank):
    """K5's rows: (word index of each valid window, its pay row or -1)
    as i32, and the counts."""
    low = pp.u64(lo)
    word = (pp.u64(hi) << 27) | (low >> 5)
    rank, hit = step.probe_rank_plain(bf_rank, word, low & 31, valid)
    widx = word[valid].to(torch.int32)
    pidx = torch.where(hit, rank, -1)[valid].to(torch.int32)
    return widx, pidx, {"windows": lo.numel(),
                        "word_rows": int(torch.unique(widx).numel()),
                        "hits": int(hit.sum()),
                        "pay_rows": int(torch.unique(rank[hit]).numel())}


def classic_bounds(c: dict) -> dict:
    n = c["windows"]
    rows = n * 17 + c["word_rows"] * 8
    return {"r": pf.bound(rows, 8 * n),
            "y": pf.bound(rows + c["pay_rows"] * 8, 12 * n)}


def slots2_plain(index, args, want) -> tuple:
    """(the line's slots2 fields, device tables, meta, plain result); the
    plain result is held to the 4-slot one (`want`)."""
    built = build_slots2(index)
    if built is None:
        return {"slots2_buildable": False}, None, None, None
    t2, s2, st2, hm2 = built
    dev = args[0].device
    tables = tuple(step.to_device(a, dev, np.uint32) for a in (t2, s2, st2))
    plain = hashed.probe_xl_plain(*args, *tables, hm2)
    out = {"slots2_buildable": True, "lgB": hm2.lgB,
           "side_lgB": hm2.side_lgB, "has_side": hm2.has_side,
           "table_gb": t2.nbytes / 1e9, "side_gb": s2.nbytes / 1e9,
           "side_stash_rows": hashed.stash_rows_before_pad(st2),
           "flagged_share": float(((t2[:, 0] >> hashed.XL_FLAG_BIT) & 1)
                                  .sum()) / t2.shape[0],
           "plain_equals_slots4": pf.same(plain, want)}
    return out, tables, hm2, plain


def ladder(rungs, libs, caller, reps, flush, tag) -> dict:
    """Each rung's occupancy and timing (rows of `rungs` updated,
    profile_probe_torch.time_rounds); returns {rung: its result on the
    windows}."""
    calls = {}
    for r, (fn, occ) in libs.items():
        if r in rungs:
            calls[r] = caller(fn)
            rungs[r].update(pp.occupancy(occ))
    return pp.time_rounds(rungs, calls, reps, flush, tag)


def run(device, reps: int, quick: bool, warm_only: bool = False) -> dict:
    on_card = device.type == "cuda"
    xl_texts, k5_texts = variant_texts()
    checks = {"variant_texts_built": True,
              "s_text_is_committed": xl_source("s", pf.committed("xl.cu"))
              == pf.committed("xl.cu"),
              "y_text_is_committed": classic_source(
                  "y", pf.committed("classic.cu"))
              == pf.committed("classic.cu")}
    if quick:
        del xl_texts["slots2"]
    built_xl = built_k5 = None
    if on_card:
        built_xl = pf.start_builds(f"{SCRIPT}/xl", xl_texts, "shkk_probe_xl",
                                   "shkk_xl_occupancy")
        built_k5 = pf.start_builds(f"{SCRIPT}/classic", k5_texts,
                                   "shkk_classic", "shkk_classic_occupancy")
    b = bench_gpu.Bench(device, float("inf"))
    cfg, clf = pe.workload_config(b, "txome")
    index = clf.index
    if clf.probe != "xl":  # a small index picks hashed; the ladder is xl's
        clf = Classifier(index, max_winners=cfg.max_winners, c=cfg.c,
                         device=device, probe="xl")
    classic = Classifier(index, max_winners=cfg.max_winners, c=cfg.c,
                         device=device, probe="classic")
    packed, vmask = first_batches(cfg, 1)[0]
    pk = torch.from_numpy(packed).to(device)
    vm = torch.from_numpy(vmask).to(device)
    L = pk.shape[1] * 4
    meta, _ = clf._geometry(L)
    hi, lo, valid, _ = step.front_end(pk, vm, meta)
    dix, hmeta, cdix = clf.dix, clf._hmeta, classic.dix
    xc, bidx, need = xl_counts(hi, lo, valid, dix, hmeta)
    S = hashed.stash_rows_before_pad(dix.side_stash.cpu().numpy())
    widx, pidx, kc = classic_rows(hi, lo, valid, cdix.bf_rank)
    xargs = (hi, lo, valid, dix.table, dix.side, dix.side_stash, hmeta)
    kargs = (hi, lo, valid, cdix.bf_rank, cdix.pay)
    xl_plain = hashed.probe_xl_plain(*xargs)
    k5_plain = step.probe_tags_plain(*kargs)
    line = {"genes": bench_gpu.TXOME_GENES, "batch_size": pk.shape[0],
            "max_read_len": L, "windows_a_read": hi.shape[1],
            "xl": {"lgB": hmeta.lgB, "side_lgB": hmeta.side_lgB,
                   "has_side": hmeta.has_side,
                   "table_gb": dix.table.numel() * 4 / 1e9,
                   "side_gb": dix.side.numel() * 4 / 1e9,
                   "side_stash_rows": S, "counts": xc,
                   "rungs": xl_bounds(xc, S)},
            "classic": {"bf_rank_gb": cdix.bf_rank.numel() * 4 / 1e9,
                        "pay_gb": cdix.pay.numel() * 4 / 1e9, "counts": kc,
                        "rungs": classic_bounds(kc)}}
    want = [clf.call_packed(pk, vm), classic.call_packed(pk, vm)]
    checks["xl_verdicts_equal_classic"] = torch.equal(want[0][0],
                                                      want[1][0])
    s2 = None
    if not quick:
        fields, tables2, hm2, plain2 = slots2_plain(index, xargs[:3],
                                                    xl_plain)
        line["slots2"] = fields
        if fields["slots2_buildable"]:
            checks["slots2_plain_equals_slots4"] = fields.pop(
                "plain_equals_slots4")
            s2 = (tables2, hm2, plain2)
    if not on_card:
        line["checks"] = checks
        return line
    flush = None if warm_only else timers.l2_flusher(device=device)
    checks["probe_xl_equals_plain"] = pf.same(hashed.probe_xl(*xargs),
                                              xl_plain)
    checks["probe_tags_equals_plain"] = pf.same(step.probe_tags(*kargs),
                                                k5_plain)
    xl_libs, k5_libs = built_xl(), built_k5()
    xr, kr = line["xl"]["rungs"], line["classic"]["rungs"]

    def xl_caller(fn):
        c = kernels.xl_variant_caller(fn, dix.table, dix.side,
                                      dix.side_stash, hmeta)
        return lambda: c(hi, lo, valid)

    def k5_caller(fn):
        c = kernels.classic_variant_caller(fn, cdix.bf_rank, cdix.pay)
        return lambda: c(hi, lo, valid)

    got = ladder(xr, xl_libs, xl_caller, reps, flush, "profile_txome xl")
    checks["s_equals_probe_xl"] = pf.same(got["s"], xl_plain)
    checks["x_equals_s_outside_side"] = pp.equal_outside(got["x"], got["s"],
                                                         need)
    checks["g_folds_its_buckets"] = torch.equal(
        got["g"][0], pp.bucket_fold(hi, lo, valid, dix.table, hmeta.lgB, 16))
    got = ladder(kr, k5_libs, k5_caller, reps, flush,
                 "profile_txome classic")
    checks["y_equals_probe_tags"] = pf.same(got["y"], k5_plain)
    checks["r_hits_are_y_tags"] = torch.equal(
        got["r"][0].view(torch.int32) != 0, got["y"][0].view(torch.int32) != 0)
    pf.climb_both(line["xl"], xr, XL_RUNGS, "s", flush is not None)
    pf.climb_both(line["classic"], kr, K5_RUNGS, "y", flush is not None)
    gather16 = floors.rows(dix.table, bidx, 16)
    checks["gather16_equals_plain"] = torch.equal(
        gather16, floors.rows_plain(dix.table, bidx, 16))
    two = floors.two_level(cdix.bf_rank, widx, cdix.pay, pidx)
    checks["two_level_equals_plain"] = torch.equal(
        two, floors.two_level_plain(cdix.bf_rank, widx, cdix.pay, pidx))
    line["anchors"] = {
        "front": pp.timing(lambda: step.front_end(pk, vm, meta), reps, None),
        "gather16": pp.timing(lambda: floors.rows(dix.table, bidx, 16),
                              reps, flush),
        "two_level": pp.timing(lambda: floors.two_level(
            cdix.bf_rank, widx, cdix.pay, pidx), reps, flush),
        "gather8_words": pp.timing(lambda: floors.rows(cdix.bf_rank, widx,
                                                       8), reps, flush)}
    line["whole_step"] = {
        "xl": pp.timing(lambda: clf.call_packed(pk, vm), reps, None),
        "classic": pp.timing(lambda: classic.call_packed(pk, vm), reps,
                             None)}
    if s2 is not None:
        (t2, side2, st2), hm2, plain2 = s2
        fn, occ = xl_libs["slots2"]
        call = kernels.xl_variant_caller(fn, t2, side2, st2, hm2)
        res = call(hi, lo, valid)
        checks["slots2_equals_slots4"] = pf.same(res, xl_plain)
        checks["slots2_equals_plain"] = pf.same(res, plain2)
        b2 = hashed._bucket_rest(pp.u64(lo), pp.u64(hi), hm2.lgB)[0]
        b2 = b2[valid].to(torch.int32)
        line["slots2"].update(pp.occupancy(occ))
        line["slots2"].update(pp.timing(lambda: call(hi, lo, valid), reps,
                                        flush))
        line["slots2"]["gather8"] = pp.timing(
            lambda: floors.rows(t2, b2, 8), reps, flush)
        line["slots2"]["vs_s"] = (line["slots2"]["device_ms"]
                                  / xr["s"]["device_ms"])
    line["checks"] = checks
    return line


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", choices=("txome",), default="txome")
    ap.add_argument("--genes", type=int, default=bench_gpu.TXOME_GENES,
                    help="the txome's gene count (the reference's n_genes)")
    ap.add_argument("--quick", action="store_true",
                    help="skip the XL_SLOTS = 2 layout")
    ap.add_argument("--reads", type=int, default=bench_gpu.N_READS)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--warm-only", action="store_true",
                    help="no readings with the L2 flushed")
    ap.add_argument("--cpu", action="store_true",
                    help="the plain versions and the text checks only")
    ap.add_argument("--cache", default="")
    args = ap.parse_args(argv)
    if device is None:
        if args.cpu:
            device = "cpu"
        elif torch.cuda.is_available():
            device = "cuda:0"
        else:
            print(f"{SCRIPT}: no CUDA card; the rungs run on the card "
                  "(--cpu runs the plain versions)", file=sys.stderr)
            return 1
    device = torch.device(device)
    pe.size_workloads(args.reads, args.cache)
    bench_gpu.TXOME_GENES = args.genes
    line = run(device, args.reps, args.quick, args.warm_only)
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
