#!/usr/bin/env python3
"""K3's device time by sub-stage on one CUDA card: the port's counterpart
of bench/profile_finish.py and bench/profile_group_finish.py.

    python3 scripts/profile_finish_torch.py [--workload panel|homolog|all]
        [--reads N] [--reps R] [--warm-only] [--cpu] [--cache DIR]

The reference cut its finish into cumulative jits. On the card the finish
is one source (K3, shark_tpu_torch/csrc/finish.cu) of three launches: the
group pass (groups_kernel), the warp pass (warp_kernel, one warp a read)
and the block path (block_kernel, the reads too heavy for a warp). The
rungs are timing-only variants of the warp pass, made at run time from
the committed source by checked substitutions (every anchor found exactly
once, else the script raises; scripts/profile_front_torch.py's helpers),
built under build/variants/profile_finish_torch/<rung>/ and launched
through the port's wrapper (step.finish_from_tags via
Classifier.finish) with its library entry point routed to the variant.
The group pass and the block path run unchanged in every rung and are
read as their own profiler ops. No variant is a kernel of the port.

    f0   K1 + K2 alone (Classifier.tags: the front end and the probe)
    g    the group pass alone (step.finish_group_count; homolog only)
    k    + the key build into the per-warp slice and registers, with the
         block path's list (warp_read); the keys folded into one word
    s    + the sort (or its skip when the keys ascend)
    c    + the one-gene path and the segment scans: best only, no winners
    f    the whole K3: its text is the committed source; must equal
         finish_from_tags and its plain version, and its block path's read
         count (step.finish_heavy_count) step.finish_heavy_reads_plain
    a1   f with one key a window (the reference's k0-only lower bound;
         wrong results, timing only)
    sort-always  f with the ascending-keys skip removed; must equal f
    a5   f on the first 84 tag columns, a contiguous copy (100 bp reads
         have 84 real windows of the padded 88); verdicts must equal f's

k, s, c and f are cumulative on the warp pass: each gives the warp
kernel's device ms and the whole call's (timers.device_profile, least of
three sessions held against the back-to-back time; *_suspect where none
agrees), L2 warm and flushed (--warm-only: warm alone), the delta from
the rung below, the piece's own lower bound (bytes over 3.35 TB/s or
integer operations over 16.7 T/s: tags and payloads 8 bytes a window,
the rows3 rows the impure reads touch, flags and group ids 5 bytes a
read, 4 a key to build, nk log2 nk for the reads whose keys do not
ascend, 6 a key for the scans, and the verdicts' 12 + 4 W bytes a read),
the warp pass's share of f's (share_of_f; call_share_of_f for the whole
call), and the occupancy (active blocks per SM of the three kernels,
cudaOccupancyMaxActiveBlocksPerMultiprocessor exported by the variant's
source, and the block path's dynamic shared memory). Beside s,
torch.sort(dim=1) of the same keys, padded to [B, max nk], is the library
yardstick of the sort rung alone. Per workload it prints the share of
reads that skip the sort, take the one-gene path, go to the block path,
or have no key (from the keys in the order the warp builds them).
`furthest` names the cumulative rung whose piece is furthest above its
bound.

The reference's a2 (tag-2 windows compacted by a sort), a3 (winners by
top_k) and a4 (coverage and hits in one fused cumsum) are choices of how
XLA lays out the finish. K3 already builds only the valid keys, selects
winners by ballot and scans in one pass, so they have no counterpart.

Workloads: bench_gpu.py's panel (production hashed entry16 table, few
rows) and homolog (rows3, group ids, GROUP verdicts), their generators,
seeds and Bench.classifier, first batch, B = 65536, L = 104. Runs on
cuda:0; --cpu runs the plain versions, the shares and the text checks and
builds nothing; without a card and without --cpu it exits 1. Prints one
JSON line with every reading and a `checks` map; exits 1 when a check
fails. --reads N and --cache DIR as in scripts/profile_e2e_torch.py.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]

import torch  # noqa: E402

import bench_gpu  # noqa: E402
import profile_e2e_torch as pe  # noqa: E402
import profile_front_torch as pf  # noqa: E402
from ab_layout_torch import first_batches  # noqa: E402
from shark_tpu_torch import kernels  # noqa: E402
from shark_tpu_torch.classify import step  # noqa: E402
from shark_tpu_torch.utils import timers  # noqa: E402

CUMULATIVE = ("k", "s", "c", "f")
RUNG_LIBS = ("k", "s", "c", "f", "a1", "sort-always")  # a5 runs f's
REAL_WINDOWS = bench_gpu.READ_LEN - bench_gpu.K + 1  # a5: 84 of 88

ANCHOR_SORT = "  // ---- sort, unless the keys already ascend ----"
ANCHOR_AFTER_SORT = ("  const int pb = a.pos_bits;\n"
                     "  const u32 pmask = (1u << pb) - 1u;\n"
                     "  const int M = a.L + 1;\n")
ANCHOR_WARP_END = "}\n\n// The verdict of read b by its warp"
ANCHOR_ONE_GENE_OUT = "    const int nw = nk > 0 ? 1 : 0;\n"
ANCHOR_ONE_GENE_END = "    return;\n  }\n\n  // ---- segments"
ANCHOR_WINNERS = ("  // ---- winners: segment ends scoring best, ascending "
                  "gene ----\n  int nw = 0, w0 = -1;")
ANCHOR_KEY_COUNT = "    const int incl = warp_incl_sum(cnt, lane);"
ANCHOR_SORT_SKIP = ("  if (!__all_sync(kFull, ordered)) "
                    "warp_bitonic_sort<NR>(key, lane, 0);")

# k and s: every key of the read folded into its packed slot, so that the
# keys (and, in s, their sort) stay live
FOLD = """  u32 fold = 0;
#pragma unroll
  for (int r = 0; r < NR; ++r) fold ^= key[r];
  fold = __reduce_xor_sync(kFull, fold);
  if (lane == 0) a.packed[b] = (int)fold;
"""
OCCUPANCY = """
extern "C" int shkk_finish_occupancy(int smem, int* warp_blocks,
                                     int* block_blocks, int* group_blocks) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      warp_blocks, warp_kernel, kLightWarps * 32, 0);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(block_blocks,
                                                    block_kernel, kThreads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      group_blocks, groups_kernel, 256, 0);
}
"""
OPS_BUILD, OPS_SCAN = 4, 6  # integer operations a key


def log(msg: str) -> None:
    print(f"[profile_finish] {msg}", file=sys.stderr, flush=True)


def rung_source(rung: str, text: str) -> str:
    """finish.cu (`text`) cut to `rung`; f is the committed text."""
    what = "finish.cu"
    rs, ro = pf.replace_span, pf.replace_once
    if rung == "f":
        return text
    if rung == "k":
        return rs(text, ANCHOR_SORT, ANCHOR_WARP_END, FOLD, what)
    if rung == "s":
        return rs(text, ANCHOR_AFTER_SORT, ANCHOR_WARP_END, FOLD, what)
    if rung == "c":
        text = rs(text, ANCHOR_ONE_GENE_OUT, ANCHOR_ONE_GENE_END,
                  "    if (lane == 0) a.packed[b] = nk > 0 ? cov * M + nk "
                  ": 0;\n", what)
        return rs(text, ANCHOR_WINNERS, ANCHOR_WARP_END,
                  "  if (lane == 0) a.packed[b] = best;\n", what)
    if rung == "a1":
        return ro(text, ANCHOR_KEY_COUNT,
                  "    if (needy) cnt = 1;\n    needy = false;\n"
                  "    cnt = cnt < 1 ? cnt : 1;\n" + ANCHOR_KEY_COUNT, what)
    if rung == "sort-always":
        return ro(text, ANCHOR_SORT_SKIP,
                  "  warp_bitonic_sort<NR>(key, lane, 0);", what)
    raise ValueError(f"unknown rung {rung!r}")


def variant_texts() -> dict:
    """{rung: full text (rung source and occupancy export)}; raises
    profile_front_torch.VariantError when the committed finish.cu no
    longer holds an anchor once."""
    text = pf.committed("finish.cu")
    return {r: rung_source(r, text) + OCCUPANCY for r in RUNG_LIBS}


def block_smem(meta, Ls: int, has_rows: bool, has_ext: bool) -> int:
    """The block path's dynamic shared memory, as finish_from_tags sizes
    it (0 when its keys go to a global scratch)."""
    kmax = max(meta.degree3 if has_rows else 0, 2) * Ls + (
        step.EXT_CAP2 * meta.ext3_w if has_ext else 0)
    key_cap = max(step._FINISH_CHUNK, 1 << max(0, (kmax - 1).bit_length()))
    return 0 if key_cap * 8 > step._FINISH_SMEM_MAX else key_cap * 8


def warp_keys(clf, tags):
    """(keys int64 [B, Ls * w] in the order the warp pass builds them, -1
    for no key; the reads that take their GROUP verdict): direct genes,
    one pseudo-gene key a row window of a pure read, the inline genes of
    the other reads' rows (none for a row past the inline width with an
    extension table: that read takes the block path)."""
    tagv, payv, _, L = tags
    meta, _ = clf._geometry(L)
    t, p = tagv.to(torch.int64), payv.to(torch.int64)
    B, Ls = t.shape
    pb, rb = meta.pos_bits, meta.rows_bits
    pos = (torch.arange(Ls, device=t.device) + (L - Ls))[None, :]
    none = torch.full_like(t, -1)
    direct = (t == step.TAG_D1) | (t == step.TAG_D2)
    cols = [torch.where(direct, ((p & 0xFFFF) << pb) | pos, none),
            torch.where(t == step.TAG_D2, ((p >> 16) << pb) | pos, none)]
    grp, _ = step._group_reads(t, p, clf._has_rows, rb)
    if clf._has_rows:
        D = meta.degree3
        is_row = t == step.TAG_ROW
        r3 = clf.dix.rows3.to(torch.int64)
        ridx = torch.clamp(torch.where(is_row, p & ((1 << rb) - 1)
                                       if rb else p, 0), max=r3.shape[0] - 1)
        rw = r3[ridx]

        def field(i):
            w = rw[..., i >> 1]
            return (w >> 16) if (i & 1) else (w & 0xFFFF)

        deg = torch.where(is_row, field(0), 0)
        if clf.dix.ext_mat is not None and meta.ext3_w > 0:
            inline = torch.where(deg > D, 0, deg)
        else:
            inline = torch.clamp(deg, max=D)
        impure = is_row & ~grp[:, None]
        cols[0] = torch.where(is_row & grp[:, None],
                              (meta.n_genes << pb) | pos, cols[0])
        for d in range(D):
            has = impure & (inline > d)
            gene = torch.where(has, (field(1 + d) << pb) | pos, none)
            if d < 2:
                cols[d] = torch.where(has, gene, cols[d])
            else:
                cols.append(gene)
    return torch.stack(cols, dim=2).reshape(B, -1), grp


def path_shares(clf, tags) -> dict:
    """Reads by the path the warp pass gives them, with each read's key
    count (nk) and the keys padded to [B, max nk] for the sort yardstick."""
    tagv, payv, _, L = tags
    meta, _ = clf._geometry(L)
    keys, grp = warp_keys(clf, tags)
    valid = keys >= 0
    nk = valid.sum(dim=1)
    running = torch.cummax(keys, dim=1).values
    prev = torch.cat([torch.full_like(running[:, :1], -1),
                      running[:, :-1]], dim=1)
    ascending = ~(valid & (keys < prev)).any(dim=1)
    gene = keys >> meta.pos_bits
    big = torch.full_like(gene, 1 << 40)
    one_gene = (torch.where(valid, gene, big).min(dim=1).values
                == torch.where(valid, gene, -1).max(dim=1).values) | (nk == 0)
    block = step.finish_heavy_reads_plain(
        tagv, payv, rows3=clf.dix.rows3, ext_mat=clf.dix.ext_mat, meta=meta,
        L=L, has_rows=clf._has_rows)
    warp = ~block
    B = keys.shape[0]
    max_nk = max(1, int(nk.max()))
    padded = torch.sort(torch.where(valid, keys, 0x7FFFFFFF), dim=1).values
    padded = padded[:, :max_nk].to(torch.int32).contiguous()
    return {
        "shares": {"sort_skipped": int((ascending & warp & (nk > 0)).sum())
                   / B,
                   "one_gene": int((one_gene & warp & (nk > 0)).sum()) / B,
                   "block_path": int(block.sum()) / B,
                   "no_key": int((nk == 0).sum()) / B,
                   "group_verdicts": int(grp.sum()) / B},
        "block_reads": int(block.sum()), "max_nk": max_nk,
        "keys": int(nk.sum()), "nk": nk, "needs_sort": ~ascending & warp,
        "padded": padded, "grp": grp}


def rung_bounds(clf, tags, sh, W: int) -> dict:
    """Each rung's bound (see the module docstring)."""
    tagv, payv, _, L = tags
    meta, _ = clf._geometry(L)
    B, Ls = tagv.shape
    n = B * Ls
    nk = sh["nk"].to(torch.float64)
    sort_ops = nk * torch.log2(torch.clamp(nk, min=2))
    sort_need = float(sort_ops[sh["needs_sort"]].sum())
    sort_all = float(sort_ops.sum())
    keys = float(nk.sum())
    rows_bytes = 0
    if clf._has_rows:
        t = tagv.to(torch.int64)
        rb = meta.rows_bits
        p = payv.to(torch.int64)
        impure_row = (t == step.TAG_ROW) & ~sh["grp"][:, None]
        ridx = (p & ((1 << rb) - 1)) if rb else p
        rows_bytes = int(torch.unique(ridx[impure_row]).numel()) \
            * clf.dix.rows3.shape[1] * 4
    tags_in = n * 8 + B * 5 + rows_bytes
    verdicts = B * (12 + 4 * W)
    windows_hit = float((tagv != 0).sum())
    b = pf.bound
    return {
        "g": b(n * 8 + B * 5, 0),
        "k": b(tags_in + B * 4, OPS_BUILD * keys),
        "s": b(tags_in + B * 4, OPS_BUILD * keys + sort_need),
        "c": b(tags_in + B * 4, (OPS_BUILD + OPS_SCAN) * keys + sort_need),
        "f": b(tags_in + verdicts,
               (OPS_BUILD + OPS_SCAN) * keys + sort_need),
        "a1": b(tags_in + verdicts, (OPS_BUILD + OPS_SCAN) * windows_hit),
        "sort-always": b(tags_in + verdicts,
                         (OPS_BUILD + OPS_SCAN) * keys + sort_all),
        "a5": b(tags_in * REAL_WINDOWS / Ls + verdicts,
                (OPS_BUILD + OPS_SCAN) * keys + sort_need),
    }


def same(a, b) -> bool:
    """The verdicts (packed, winners, best_cov) of two finishes agree."""
    return all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))


def first_columns(tags, n: int):
    """tags cut to their first n windows, contiguous copies."""
    tagv, payv, length, L = tags
    return (tagv[:, :n].contiguous(), payv[:, :n].contiguous(), length, L)


def rung_timing(call, reps, flush) -> dict:
    """The call's device ms and ops, L2 warm and (with `flush`) flushed,
    with the warp pass's own ms (warp_ms, warp_ms_flushed)."""
    out = pf.device_ms(call, reps)
    if flush is not None:
        out.update(pf.device_ms(call, reps, flush, "_flushed"))
    for suffix in ("", "_flushed"):
        if "device_ms" + suffix in out:
            ops = out.get("device_ops" + suffix) or {}
            out["warp_ms" + suffix] = ops.get("warp_kernel")
    return out


def run_workload(b, wl: str, built, reps: int, warm_only: bool) -> dict:
    """One workload's ladder; `built` waits for the variant libraries
    (None on the CPU)."""
    on_card = built is not None
    cfg, clf = pe.workload_config(b, wl)
    packed, vmask = first_batches(cfg, 1)[0]
    dev = clf.device
    pk = torch.from_numpy(packed).to(dev)
    vm = torch.from_numpy(vmask).to(dev)
    tags = clf.tags(pk, vm)
    tagv, payv, length, L = tags
    meta, _ = clf._geometry(L)
    B, Ls = tagv.shape
    W = clf.max_winners
    sh = path_shares(clf, tags)
    rungs = rung_bounds(clf, tags, sh, W)
    groups = bool(clf._has_rows and meta.rows_bits)
    if not groups:
        del rungs["g"]
    real = first_columns(tags, REAL_WINDOWS)
    pad_hits = int((tagv[:, REAL_WINDOWS:] != 0).sum())
    plain = step.finish_from_tags_plain(
        tagv, payv, length, clf._geometry(L)[1], rows3=clf.dix.rows3,
        ext_mat=clf.dix.ext_mat, meta=meta, max_winners=W, L=L,
        has_rows=clf._has_rows)
    checks = {"padding_windows_empty": pad_hits == 0}
    line = {"workload": wl, "probe": clf.probe, "batch_size": B,
            "max_read_len": L, "windows": Ls, "max_winners": W,
            "degree3": meta.degree3, "rows_bits": meta.rows_bits,
            "group_pass": groups, "keys": sh["keys"],
            "max_nk": sh["max_nk"], "block_reads": sh["block_reads"],
            "shares": sh["shares"], "rungs": rungs}
    if not on_card:
        checks["a5_plain_equals_plain"] = same(clf.finish(real), plain)
        line["checks"] = checks
        return line
    flush = None if warm_only else timers.l2_flusher(device=dev)
    want = clf.finish(tags)
    want_heavy = step.finish_heavy_count()
    heavy_plain = sh["block_reads"]
    checks["finish_equals_plain"] = same(want, plain)
    checks["heavy_count_equals_plain"] = want_heavy == heavy_plain
    line["f0"] = pf.device_ms(lambda: clf.tags(pk, vm), reps)
    if groups:
        n_fix = torch.zeros(1, dtype=torch.int32, device=dev)
        rungs["g"].update(rung_timing(lambda: clf.group_count(tags, n_fix),
                                      reps, flush))
    smem = block_smem(meta, Ls, clf._has_rows,
                      clf._has_rows and clf.dix.ext_mat is not None
                      and meta.ext3_w > 0)
    f_res = None
    libs = built()
    for r in ("k", "s", "c", "f", "a1", "sort-always", "a5"):
        fn, occ = libs["f" if r == "a5" else r]
        on = real if r == "a5" else tags
        wb, bb, gb = (ctypes.c_int(0) for _ in range(3))
        kernels.check(occ(smem, ctypes.byref(wb), ctypes.byref(bb),
                          ctypes.byref(gb)), f"occupancy of {r}")
        row = rungs[r]
        row.update(warp_blocks_per_sm=wb.value, block_blocks_per_sm=bb.value,
                   group_blocks_per_sm=gb.value, block_smem_bytes=smem)
        with pf.routed(shkk_finish=fn):
            got = clf.finish(on)
            heavy = step.finish_heavy_count()
            row.update(rung_timing(lambda on=on: clf.finish(on), reps, flush))
        row["block_reads"] = heavy
        if r == "f":
            f_res = got
            checks["f_equals_finish"] = same(got, want)
            checks["f_equals_plain"] = same(got, plain)
            checks["f_heavy_count_equals_plain"] = heavy == heavy_plain
        elif r == "sort-always":
            checks["sort_always_equals_f"] = same(got, f_res)
        elif r == "a5":
            checks["a5_equals_f"] = same(got, f_res)
        log(f"{wl} {r}: " + json.dumps(
            {k: v for k, v in row.items() if "ops" not in k}))
    line["furthest"] = pf.climb(rungs, CUMULATIVE, "f", "warp_ms")
    for r in ("a1", "sort-always", "a5"):
        rungs[r]["vs_f_ms"] = rungs[r]["device_ms"] - rungs["f"]["device_ms"]
        rungs[r]["warp_vs_f_ms"] = (rungs[r]["warp_ms"]
                                    - rungs["f"]["warp_ms"])
    for r in rungs.values():
        if r.get("device_ms") is not None:
            r["call_share_of_f"] = r["device_ms"] / rungs["f"]["device_ms"]
    padded = sh["padded"]
    line["sort_library"] = {"shape": list(padded.shape), **pf.device_ms(
        lambda: torch.sort(padded, dim=1), reps)}
    rungs["s"]["library_ms"] = line["sort_library"]["device_ms"]
    line["checks"] = checks
    return line


def run(device, workloads, reps: int, warm_only: bool = False) -> dict:
    on_card = device.type == "cuda"
    texts = variant_texts()
    checks = {"variant_texts_built": True,
              "f_text_is_committed": rung_source("f", pf.committed(
                  "finish.cu")) == pf.committed("finish.cu")}
    built = pf.start_builds("profile_finish_torch", texts, "shkk_finish",
                            "shkk_finish_occupancy") if on_card else None
    b = bench_gpu.Bench(device, float("inf"))
    out = {"workloads": {}}
    for wl in workloads:
        line = run_workload(b, wl, built, reps, warm_only)
        for k, v in line.pop("checks").items():
            checks[f"{wl}_{k}"] = v
        out["workloads"][wl] = line
    out["checks"] = checks
    return out


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", choices=("panel", "homolog", "all"),
                    default="all")
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
            print("profile_finish_torch: no CUDA card; the rungs run on the "
                  "card (--cpu runs the plain versions)", file=sys.stderr)
            return 1
    device = torch.device(device)
    pe.size_workloads(args.reads, args.cache)
    wls = ("panel", "homolog") if args.workload == "all" \
        else (args.workload,)
    line = run(device, wls, args.reps, args.warm_only)
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
