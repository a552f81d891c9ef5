#!/usr/bin/env python3
"""Layouts of the hashed probe table side by side on one CUDA card: the
port's counterpart of bench/ab_lgb.py, bench/ab_slots.py and
bench/ab_entry.py.

    python3 scripts/ab_layout_torch.py [--below 3] [--slots 8 6 4]
        [--no-entry8] [--batches 4] [--reps 7] [--reads N] [--cpu]
        [--cache DIR]

The production layout (shark_tpu_torch/classify/hashed.py
build_hashed_index: entry16 words, 8 slots a 32-byte bucket, the
smallest bucket count from natural - 3 up whose stash stays within
SMALL_STASH, under the 64 MB table cap) was chosen for the TPU's gather
engine. On bench_gpu.py's panel index (500 genes, k = 17, -b 1) and the
first --batches batches of its reads (B = 65536, L = 104), this builds:
(a) the bucket count pinned (bench/ab_lgb.py:28-75 _build_pinned, over
    the port's own hashed._pack_table and _pad_stash) at every lgB from
    natural - --below up to natural: entry16 with 8 slots (natural:
    build_hashed_index's, ceil(log2) of the slot words, capped at 64 MB),
    and entry8, the layout the reference pinned (natural: ceil(log2) of
    the entries, capped at MAX_BUCKETS); a count is buildable when the
    rest (14 or 30 bits) holds the Bloom position and the stash stays
    within STASH_CAP (the reference's rule, bench/ab_lgb.py:108-121);
(b) 8, 6 and 4 slots (--slots) at the production bucket count
    (bench/ab_slots.py:87-94) and at the natural one, each buildable while
    its stash stays within the variant's 2048 rows;
(c) entry8 (64-byte planar buckets of 8-byte entries) as
    build_hashed_index(allow16=False) picks it (bench/ab_entry.py),
    beside entry16.
Layouts of 4 or 8 slots and entry8 run through the committed K2
(hashed.probe_hashed, csrc/probe.cu), whose template holds them, unless
their padded stash is past its STASH_CAP rows: the row then records that
K2 refuses it, and runs it through the variant. The 6-slot layout
(24-byte buckets) runs through a variant library: csrc/probe.cu with a
6-slot layout (three 8-byte loads a bucket) and a stash of up to 2048
rows, built by nvcc (shark_tpu_torch/kernels.py build_variant, under
build/variants/ab_layout_probe/) with the text substituted; the
production K2 is not edited.

Every variant's probe is first held to its plain version
(hashed.probe_hashed_plain) on the card, then its verdicts (packed,
winners, best_cov of K1 -> the variant's probe -> K3, batch by batch) to
the production layout's, exactly. Each row gives lgB, slots, entry, the
table's MB, the stash's real and padded rows, the probe's device ms from
torch.profiler with the L2 warm and flushed (128 MB written before every
call), each held against the back-to-back time
(shark_tpu_torch/utils/timers.py device_profile; a reading none of whose
sessions agrees with it is marked *_suspect), its back-to-back event ms
on the first batch, and the event ms of K1 -> probe -> K3 a
batch over the batches; a layout with a stash also gives the probe's
warm device ms reading no stash row (wrong results where a window's
entry is in the stash: timing only), which splits the stash's cost from
the bucket's. A layout that cannot be built says why on its row and is
not timed. Prints one JSON line; exits 1 when a probe or a
verdict differs. Runs on cuda:0 unless --cpu is given (the plain
versions and the verdicts only, no timing); without a card and without
--cpu it exits 1. --reads N and --cache DIR as in
scripts/profile_e2e_torch.py.
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
from shark_tpu_torch import kernels  # noqa: E402
from shark_tpu_torch.classify import hashed, step  # noqa: E402
from shark_tpu_torch.utils import timers  # noqa: E402


VARIANT_STASH = 2048  # the variant's stash rows (K2: hashed.STASH_CAP)
# csrc/probe.cu -> the variant: (text, replacement), each found once
SUBSTITUTIONS = (
    ("constexpr int kMaxStash = 256;  // STASH_CAP",
     f"constexpr int kMaxStash = {VARIANT_STASH};"),
    ("enum Layout { kEntry16x8, kEntry16x4, kEntry8 };",
     "enum Layout { kEntry16x8, kEntry16x4, kEntry8, kEntry16x6 };"),
    ("kLayout == kEntry16x8 ? 2 : (kLayout == kEntry16x4 ? 1 : 4);",
     "kLayout == kEntry16x8 ? 2 : (kLayout == kEntry8 ? 4 : 1);"),
    ("""  uint4 v[kLoads];
  const uint4* row = a.table + (u64)(lo & ((1u << a.lgB) - 1u)) * kLoads;
#pragma unroll
  for (int q = 0; q < kLoads; ++q)
    v[q] = valid ? row[q] : make_uint4(0u, 0u, 0u, 0u);
""", """  uint4 v[kLoads];
  u32 w6[6];
  if constexpr (kLayout == kEntry16x6) {
    const uint2* row6 = reinterpret_cast<const uint2*>(a.table) +
                        (u64)(lo & ((1u << a.lgB) - 1u)) * 3;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const uint2 x = valid ? row6[q] : make_uint2(0u, 0u);
      w6[2 * q] = x.x;
      w6[2 * q + 1] = x.y;
    }
  } else {
    const uint4* row = a.table + (u64)(lo & ((1u << a.lgB) - 1u)) * kLoads;
#pragma unroll
    for (int q = 0; q < kLoads; ++q)
      v[q] = valid ? row[q] : make_uint4(0u, 0u, 0u, 0u);
  }
"""),
    ("""    for (int q = 0; q < kLoads; ++q) {
      const u32 w[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const u32 meta = w[r] >> 16;""", """    {
      constexpr int kWords = kLayout == kEntry16x6 ? 6 : 4 * kLoads;
      u32 w[kWords];
#pragma unroll
      for (int r = 0; r < kWords; ++r) {
        if constexpr (kLayout == kEntry16x6) {
          w[r] = w6[r];
        } else {
          const uint4 q = v[r / 4];
          w[r] = r % 4 == 0 ? q.x : r % 4 == 1 ? q.y : r % 4 == 2 ? q.z : q.w;
        }
      }
#pragma unroll
      for (int r = 0; r < kWords; ++r) {
        const u32 meta = w[r] >> 16;"""),
    ("(entry16 && slots != 8 && slots != 4)",
     "(entry16 && slots != 8 && slots != 4 && slots != 6)"),
    ("""    else if (slots == 8)
      launch<kEntry16x8>(a, st);""", """    else if (slots == 6)
      launch<kEntry16x6>(a, st);
    else if (slots == 8)
      launch<kEntry16x8>(a, st);"""),
    ('extern "C" int shkk_probe(', 'extern "C" int shkk_probe_ab_variant('),
)


def log(msg: str) -> None:
    print(f"[ab_layout] {msg}", file=sys.stderr, flush=True)


def variant_source() -> str:
    """csrc/probe.cu with SUBSTITUTIONS made; raises when one no longer
    finds its text."""
    with open(os.path.join(kernels.CSRC, "probe.cu")) as f:
        text = f.read()
    for old, new in SUBSTITUTIONS:
        if text.count(old) != 1:
            raise RuntimeError(f"csrc/probe.cu no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build_variant():
    """nvcc the variant (kernels.build_variant); its C entry point, which
    takes shkk_probe's arguments."""
    return kernels.build_variant(
        "ab_layout_probe", variant_source(), kernels.CSRC,
        "shkk_probe_ab_variant", kernels._SIGNATURES["shkk_probe"])()


class Layout:
    """One table layout: its arrays on the device and its probe."""

    def __init__(self, name, table, stash, hmeta, device, variant=None):
        self.name = name
        self.hmeta = hmeta
        self.table = torch.from_numpy(np.ascontiguousarray(table)).to(device)
        self.stash = torch.from_numpy(np.ascontiguousarray(stash)).to(device)
        self.stash_rows = hashed.stash_rows_before_pad(stash)
        self.k2_refused = None
        if hmeta.slots == 6:
            self.route = "variant"
        elif stash.shape[0] > hashed.STASH_CAP:
            self.route = "variant"
            self.k2_refused = (f"stash of {stash.shape[0]} rows past K2's "
                               f"STASH_CAP {hashed.STASH_CAP}")
        else:
            self.route = "k2"
        self.variant = variant

    def row(self) -> dict:
        h = self.hmeta
        out = {"name": self.name, "entry": "entry16" if h.entry16
               else "entry8", "slots": h.slots, "lgB": h.lgB,
               "table_mb": self.table.numel() * 4 / 2**20,
               "stash_real": self.stash_rows,
               "stash_padded": int(self.stash.shape[0]), "route": self.route}
        if self.k2_refused:
            out["k2_refused"] = self.k2_refused
        return out

    def probe(self, idx_hi, idx_lo, win_valid, stash_rows=None):
        """(tagv, payv); `stash_rows` = 0 reads no stash row (wrong
        results where a window's entry is in the stash: timing only)."""
        if stash_rows is None:
            stash_rows = self.stash_rows
        if not idx_lo.is_cuda or self.route == "k2":
            return hashed.probe_hashed(idx_hi, idx_lo, win_valid, self.table,
                                       self.stash, self.hmeta, stash_rows)
        if self.stash.shape[0] > VARIANT_STASH:
            raise ValueError(f"stash of {self.stash.shape[0]} rows past the "
                             f"variant's {VARIANT_STASH}")
        return kernels.probe_variant_caller(
            self.variant, True, self.table, self.hmeta)(
            idx_hi, idx_lo, win_valid, self.stash, stash_rows)


def natural_lgb(index, entry16: bool) -> int:
    """build_hashed_index's natural bucket count: entry16 x 8 slots (slot
    words over 2^lgB, capped at 64 MB), or entry8 (entries over 2^lgB,
    capped at MAX_BUCKETS; bench/ab_lgb.py:108-111)."""
    if entry16:
        deg = np.diff(index.offsets)
        words = int(np.where(deg == 1, 1, 2).sum())
        lg_cap = int(np.log2(hashed.MAX_TABLE_BYTES // (4 * 8)))
    else:
        words = int(index.n_set_bits)
        lg_cap = int(np.log2(hashed.MAX_BUCKETS))
    return min(max(6, int(np.ceil(np.log2(words)))), lg_cap)


def candidates(index, clf, below, slot_list, entry8):
    """(natural lgB of entry16, [[name, parts, build]]): `build()` gives
    (table, padded stash, HashedMeta) or a string saying why the layout
    cannot be built. (a) pins entry16 x 8 slots, and entry8 as the
    reference's _build_pinned did, at natural - below .. natural; (b)
    gives each of slot_list at the production and the natural entry16
    bucket counts; (c) entry8 as build_hashed_index(allow16=False) picks
    it."""
    pos, tag, payload, has_rows, deg = hashed._entry_streams(index)
    need16 = np.where(deg == 1, 1, 2).astype(np.int64)
    nat = natural_lgb(index, True)

    def pinned(lg, slots, entry16, cap):
        def build():
            rest_bits = 14 if entry16 else 30
            if index.size_bits > (1 << lg) << rest_bits:
                return (f"the {rest_bits}-bit rest cannot hold positions at "
                        f"lgB {lg}")
            table, stash = hashed._pack_table(
                pos, tag, payload, need16 if entry16 else None, lg, entry16,
                slots)
            if stash.shape[0] > cap:
                return f"stash of {stash.shape[0]} entries past {cap} rows"
            return table, hashed._pad_stash(stash), hashed.HashedMeta(
                lgB=lg, has_rows=has_rows, entry16=entry16, slots=slots)
        return build

    out = {}

    def add(key, part, build):
        name = f"{key[0]}_s{key[1]}_lgB{key[2]}"
        out.setdefault(key, [name, [], build])[1].append(part)

    for lg in range(max(6, nat - below), nat + 1):
        add(("entry16", 8, lg), "a_bucket_count",
            pinned(lg, 8, True, hashed.STASH_CAP))
    if entry8:
        nat8 = natural_lgb(index, False)
        for lg in range(max(6, nat8 - below), nat8 + 1):
            add(("entry8", 8, lg), "a_bucket_count",
                pinned(lg, 8, False, hashed.STASH_CAP))
    for lg in sorted({clf._hmeta.lgB, nat}):
        for slots in slot_list:
            add(("entry16", slots, lg), "b_slots",
                pinned(lg, slots, True, VARIANT_STASH))
    if entry8:
        built = hashed.build_hashed_index(index, allow16=False)
        if built is None:
            out[("entry8",)] = ["entry8", ["c_entry"], lambda: (
                "build_hashed_index(allow16=False) builds no table")]
        else:
            add(("entry8", 8, built[2].lgB), "c_entry", lambda: built)
    return nat, list(out.values())


def fronts_of(clf, batches):
    """K1's windows of each batch: [(idx_hi, idx_lo, win_valid, length,
    L)]."""
    out = []
    for packed, vmask in batches:
        pk = torch.as_tensor(packed).to(clf.device)
        vm = torch.as_tensor(vmask).to(clf.device)
        L = pk.shape[1] * 4
        out.append((*step.front_end(pk, vm, clf._geometry(L)[0]), L))
    return out


def verdicts(clf, layout, fronts):
    """(packed, winners, best_cov) of each batch through `layout`'s
    probe."""
    return [clf.finish((*layout.probe(hi, lo, valid), length, L))[:3]
            for hi, lo, valid, length, L in fronts]


def device_ms(fn, reps, flush=None) -> dict:
    """{"device_ms"[, "device_ms_suspect"]} of timers.device_profile."""
    p = timers.device_profile(fn, reps, flush, warn=log)
    return {k: p[k] for k in ("device_ms", "device_ms_suspect") if k in p}


def time_layout(clf, layout, fronts, batches_dev, reps, flush) -> dict:
    """The probe's device ms (L2 warm, flushed) and event ms on the first
    batch, and K1 -> probe -> K3's event ms a batch."""
    hi, lo, valid = fronts[0][:3]

    def probe():
        return layout.probe(hi, lo, valid)

    warm, flushed = device_ms(probe, reps), device_ms(probe, reps, flush)
    meta = clf._geometry(fronts[0][4])[0]

    def step_all():
        for pk, vm in batches_dev:
            h, l_, v, length = step.front_end(pk, vm, meta)
            clf.finish((*layout.probe(h, l_, v), length, fronts[0][4]))

    out = {"probe_device_ms": warm["device_ms"],
           "probe_device_ms_flushed": flushed["device_ms"],
           "probe_event_ms": timers.back_to_back_ms(probe),
           "step_event_ms_per_batch": timers.back_to_back_ms(step_all, 5)
           / len(batches_dev)}
    for key, p in (("probe_device_ms_suspect", warm),
                   ("probe_device_ms_flushed_suspect", flushed)):
        if "device_ms_suspect" in p:
            out[key] = p["device_ms_suspect"]
    if layout.stash_rows:
        out["probe_device_ms_no_stash"] = device_ms(
            lambda: layout.probe(hi, lo, valid, stash_rows=0),
            reps)["device_ms"]
    return out


def first_batches(cfg, n: int):
    """The first n packed batches of cfg's sample, copied."""
    out = []
    ns = pe.open_stream(cfg)
    try:
        while len(out) < n:
            nb = ns.next_batch()
            if nb is None:
                break
            packed, vmask, slot, _ = nb
            out.append((packed.copy(), vmask.copy()))
            ns.release(slot)
    finally:
        ns.close()
    return out


def same(a, b) -> bool:
    return all(torch.equal(x, y) for xs, ys in zip(a, b)
               for x, y in zip(xs, ys))


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--below", type=int, default=3,
                    help="(a): bucket counts from natural - BELOW")
    ap.add_argument("--slots", type=int, nargs="*", default=[8, 6, 4],
                    choices=(4, 6, 8))
    ap.add_argument("--no-entry8", action="store_true")
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--reads", type=int, default=bench_gpu.N_READS)
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
            print("ab_layout_torch: no CUDA card; the A/B measures the card "
                  "(--cpu runs the plain versions)", file=sys.stderr)
            return 1
    device = torch.device(device)
    on_card = device.type == "cuda"
    pe.size_workloads(args.reads, args.cache)
    b = bench_gpu.Bench(device, float("inf"))
    cfg, clf = pe.workload_config(b, "panel")
    index = clf.index
    variant = build_variant() if on_card else None
    flush = timers.l2_flusher(device=device) if on_card else None
    batches = first_batches(cfg, args.batches)
    batches_dev = [(torch.from_numpy(p).to(device),
                    torch.from_numpy(v).to(device)) for p, v in batches]
    fronts = fronts_of(clf, batches)
    prod = Layout("production", clf.dix.table.cpu().numpy(),
                  clf.dix.stash.cpu().numpy(), clf._hmeta, device, variant)
    want = verdicts(clf, prod, fronts)
    nat, cands = candidates(index, clf, args.below, args.slots,
                            not args.no_entry8)
    rows = []
    failed = []
    for name, parts, build in [("production", ["production"],
                                lambda: prod)] + cands:
        built = build()
        if isinstance(built, str):
            rows.append({"name": name, "parts": parts, "buildable": False,
                         "why": built})
            log(json.dumps(rows[-1]))
            continue
        lay = built if isinstance(built, Layout) else Layout(
            name, *built, device, variant)
        row = {"parts": parts, **lay.row(), "buildable": True}
        row["production_layout"] = (
            (lay.hmeta.entry16, lay.hmeta.slots, lay.hmeta.lgB)
            == (clf._hmeta.entry16, clf._hmeta.slots, clf._hmeta.lgB))
        if on_card:
            hi, lo, valid = fronts[0][:3]
            got = lay.probe(hi, lo, valid)
            plain = hashed.probe_hashed_plain(hi, lo, valid, lay.table,
                                              lay.stash, lay.hmeta)
            row["probe_equal_plain"] = all(
                torch.equal(x, y) for x, y in zip(got, plain))
        row["verdicts_equal"] = same(verdicts(clf, lay, fronts), want)
        if on_card:
            row.update(time_layout(clf, lay, fronts, batches_dev, args.reps,
                                   flush))
        if not row["verdicts_equal"] or not row.get("probe_equal_plain",
                                                     True):
            failed.append(name)
        rows.append(row)
        log(json.dumps(row))
        del lay
    base = rows[0].get("probe_device_ms")
    for r in rows:
        if base and r.get("probe_device_ms"):
            r["probe_vs_production"] = r["probe_device_ms"] / base
    line = {"workload": "panel", "reads": args.reads,
            "batches": len(batches), "batch_size": cfg.batch_size,
            "max_read_len": cfg.max_read_len, "n_set_bits":
            int(index.n_set_bits), "natural_lgB": nat,
            "production": rows[0], "rows": rows, "verdicts_equal": not
            failed, "device": bench_gpu.card_name() if on_card else "cpu"}
    print(json.dumps(line), flush=True)
    if failed:
        log(f"FAILED: probes or verdicts differ: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
