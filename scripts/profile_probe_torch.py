#!/usr/bin/env python3
"""K2's device time by sub-stage on one CUDA card, and the classic
against hashed A/B: the port's counterpart of bench/profile_hashed.py,
bench/profile_rowpath.py (its K2 half) and bench/kernel_ab.py.

    python3 scripts/profile_probe_torch.py [--workload panel|homolog]
        [--ab] [--reads N] [--reps R] [--warm-only] [--cpu] [--cache DIR]

The reference cut its hashed probe into cumulative jits. On the card K2
is one kernel (shark_tpu_torch/csrc/probe.cu, probe_kernel), so each rung
is a timing-only variant of probe.cu: text made at run time from the
committed source by checked substitutions (every anchor found exactly
once, else the script raises; scripts/profile_front_torch.py's helpers),
built by nvcc into build/variants/profile_probe_torch/<rung>/ and
launched through kernels.probe_variant_caller on the production table.
No variant is a kernel of the port. The rungs, cumulative:

    w   the window streams alone: idx_hi, idx_lo and win_valid read, and
        tagv, payv written from them (no bucket load, no stash)
    b   w + the bucket loads of the valid windows, their words folded
        into tagv
    m   b + the slot match; the stash skipped (the entry point takes no
        stash row), so a window whose position is in the stash gets a
        wrong result: timing only, held equal to p on every other window
    p   the whole K2: its text is the committed source; must equal
        hashed.probe_hashed and probe_hashed_plain

Each rung gives its device ms (shark_tpu_torch/utils/timers.py
device_profile: least of three profiler sessions, each held against the
back-to-back time; *_suspect where none agrees) with the L2 warm and
flushed (--warm-only: warm alone), its delta from the rung below, its own
lower bound (bytes over 3.35 TB/s or integer operations over 16.7 T/s:
17 bytes a window for the streams, a bucket of the table per distinct
bucket the valid windows touch, the stash's rows; 2 operations a window
for the bucket's address, 4 a slot and 10 more for the match, as
chip_smoke.py counts K2), the gap between them, its share of p, and its
occupancy (active blocks per SM, cudaOccupancyMaxActiveBlocksPerMultiprocessor
exported by the variant, and the dynamic shared memory of a block).
`furthest` names the rung whose own piece is furthest above its bound.
Beside them, on the same windows: P2 (experiments/resident_match.py) on
K2's buckets, held equal to K2 outside the stash, and floors.rows, a bare
gather of the same buckets (32 bytes a row on entry16 8-slot). Counts: the
windows that match two lanes (degree-2 and row entries), the windows that
hit the stash, and the stash's real and padded rows.

The batch is the first of bench_gpu.py's panel (default) or homolog
(profile_rowpath.py's question: every core k-mer of degree 8), B = 65536,
L = 104, on Bench.classifier's production table.

--ab (kernel_ab.py's question, the panel): Classifier.call_packed with
the fetch of the packed verdicts, per batch over the first 4 batches,
best of --reps, for classic at L = 128, classic at L = 104 and hashed at
L = 104 (the reference's -b 1; the classic tables built through
classify/step.py build_device_index), as ms and reads/s a batch (the
batches come from the host, as the reference passed numpy arrays), and
the device ms a batch (the kernels on resident batches) beside the
host's ms to queue them (the wrappers' work); the packed verdicts must be
equal across the three, batch by batch.

Runs on cuda:0; --cpu runs the plain versions, the counts, the A/B's
verdicts and the text checks and builds nothing; without a card and
without --cpu it exits 1. Prints one JSON line with every reading and a
`checks` map; exits 1 when a check fails. --reads N and --cache DIR as in
scripts/profile_e2e_torch.py.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]

import torch  # noqa: E402

import bench_gpu  # noqa: E402
import profile_e2e_torch as pe  # noqa: E402
import profile_front_torch as pf  # noqa: E402
from ab_layout_torch import first_batches  # noqa: E402
from shark_tpu_torch import floors, kernels  # noqa: E402
from shark_tpu_torch.classify import hashed, step  # noqa: E402
from shark_tpu_torch.classify.step import Classifier  # noqa: E402
from shark_tpu_torch.experiments import resident_match as R  # noqa: E402
from shark_tpu_torch.utils import timers  # noqa: E402

cs = pf.chip_smoke
SCRIPT = "profile_probe_torch"
CUMULATIVE = ("w", "b", "m", "p")
AB_BATCHES = 4
AB_SETUPS = (("classic", 128), ("classic", 104), ("hashed", 104))

ANCHOR_LOADS = ("  // the bucket's loads, all in flight before the first "
                "compare\n")
ANCHOR_MATCH = "  const u32 rest = (lo >> a.lgB) | (hi << (32 - a.lgB));\n"
ANCHOR_KERNEL_END = "\ntemplate <Layout kLayout>\nvoid launch("
ANCHOR_ENTRY = "  if (n > 0) {\n    int lg = 6;"

NO_STASH = ("  if (n > 0) {\n    n_real = 0;  // timing only: no stash row "
            "is read\n    int lg = 6;")
STREAMS = """  if (!live) return;
  // timing only: the window streams, folded into the outputs
  a.tagv[i] = lo ^ (valid ? 0x80000000u : 0u);
  a.payv[i] = hi;
}
"""
FOLD_BUCKET = """  if (!live) return;
  // timing only: the bucket's words folded into the outputs
  u32 f = lo;
#pragma unroll
  for (int q = 0; q < kLoads; ++q) f ^= v[q].x ^ v[q].y ^ v[q].z ^ v[q].w;
  a.tagv[i] = f;
  a.payv[i] = hi;
}
"""
OCCUPANCY = """
extern "C" int shkk_probe_occupancy(int entry16, int slots, int n_real,
                                    int* blocks, int* smem) {
  int lg = 6;
  while ((1 << lg) < 4 * n_real) ++lg;
  const size_t bytes = n_real > 0 ? sizeof(u32) << lg : 0;
  *smem = (int)bytes;
  if (!entry16)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, probe_kernel<kEntry8>, kThreads, bytes);
  if (slots == 8)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, probe_kernel<kEntry16x8>, kThreads, bytes);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, probe_kernel<kEntry16x4>, kThreads, bytes);
}
"""


def log(msg: str) -> None:
    print(f"[profile_probe] {msg}", file=sys.stderr, flush=True)


def rung_source(rung: str, text: str) -> str:
    """probe.cu (`text`) cut to `rung`; p is the committed text."""
    what = "probe.cu"
    if rung == "p":
        return text
    text = pf.replace_once(text, ANCHOR_ENTRY, NO_STASH, what)
    if rung == "m":
        return text
    if rung == "b":
        return pf.replace_span(text, ANCHOR_MATCH, ANCHOR_KERNEL_END,
                               FOLD_BUCKET, what)
    if rung == "w":
        return pf.replace_span(text, ANCHOR_LOADS, ANCHOR_KERNEL_END,
                               STREAMS, what)
    raise ValueError(f"unknown rung {rung!r}")


def variant_texts() -> dict:
    """{rung: full text (rung source and occupancy export)}; raises
    profile_front_torch.VariantError when the committed probe.cu no
    longer holds an anchor once."""
    text = pf.committed("probe.cu")
    return {r: rung_source(r, text) + OCCUPANCY for r in CUMULATIVE}


def occupancy(occ, *args) -> dict:
    """{"blocks_per_sm", "smem_bytes"} from a variant's occupancy export
    called with `args` and then the two outputs."""
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    kernels.check(occ(*args, ctypes.byref(blocks), ctypes.byref(smem)),
                  "occupancy")
    return {"blocks_per_sm": blocks.value, "smem_bytes": smem.value}


def timing(call, reps: int, flush) -> dict:
    """The call's device ms and ops, L2 warm and (with `flush`)
    flushed."""
    out = pf.device_ms(call, reps)
    if flush is not None:
        out.update(pf.device_ms(call, reps, flush, "_flushed"))
    return out


def least(row: dict, t: dict) -> None:
    """row keeps the lesser of its reading and t's, warm and flushed
    (device ms with its ops and any suspect mark)."""
    for suffix in ("", "_flushed"):
        key = "device_ms" + suffix
        if t.get(key) is None or (row.get(key) is not None
                                  and row[key] <= t[key]):
            continue
        for k in (key, "device_ops" + suffix, key + "_suspect"):
            row.pop(k, None)
            if k in t:
                row[k] = t[k]


def time_rounds(rows: dict, calls: dict, reps: int, flush, tag: str):
    """Each call's result, and its device ms in rows[name]: the least of
    two rounds, the second in the reverse order (a reading can move the
    one after it), with each round's warm reading in rounds_ms."""
    names = list(calls)
    got = {name: calls[name]() for name in names}
    for order in (names, names[::-1]):
        for name in order:
            t = timing(calls[name], reps, flush)
            rows[name].setdefault("rounds_ms", []).append(t["device_ms"])
            least(rows[name], t)
    for name in names:
        print(f"[{tag}] {name}: " + json.dumps(
            {k: v for k, v in rows[name].items() if "ops" not in k}),
            file=sys.stderr, flush=True)
    return got


def u64(t: torch.Tensor) -> torch.Tensor:
    """u32 values as int64."""
    return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def window_counts(hi, lo, valid, table, stash, hmeta) -> tuple:
    """The windows' counts, the valid windows' buckets (bidx, i32) and the
    stash mask."""
    bucket, rest = hashed._bucket_rest(u64(lo), u64(hi), hmeta.lgB)
    bidx = bucket[valid].to(torch.int32)
    out = {"windows": lo.numel(), "valid_windows": int(valid.sum()),
           "buckets_touched": int(torch.unique(bidx).numel()),
           "bucket_bytes": table[0].numel() * 4}
    if hmeta.entry16:
        row = step.gather_u32(table, bucket)
        meta = row >> 16
        lanes = (((meta >> 14) != 0) & ((meta & 0x3FFF) == rest[..., None])
                 & valid[..., None]).sum(dim=-1)
        out["two_lane_windows"] = int((lanes >= 2).sum())
        del row, meta
    stash_mask = cs.stash_hits(hi, lo, valid, stash)
    real, padded = cs.stash_counts(stash)
    out.update(stash_windows=int(stash_mask.sum()), stash_rows=real,
               stash_rows_padded=padded)
    return out, bidx, stash_mask


def rung_bounds(c: dict, slots: int, stash_bytes: int) -> dict:
    """Each rung's bound (module docstring)."""
    n = c["windows"]
    streams = n * 17
    buckets = c["buckets_touched"] * c["bucket_bytes"]
    match = n * (4 * slots + 10)
    return {"w": pf.bound(streams, 0),
            "b": pf.bound(streams + buckets, 2 * n),
            "m": pf.bound(streams + buckets, match),
            "p": pf.bound(streams + buckets + stash_bytes, match)}


def bucket_fold(hi, lo, valid, table, lgB: int, row_bytes: int):
    """What a folding rung writes to tagv: lo xor every word of the
    window's bucket where valid, lo elsewhere (u32)."""
    bucket = hashed._bucket_rest(u64(lo), u64(hi), lgB)[0]
    rows = floors.rows_plain(table, bucket.reshape(-1), row_bytes)
    low = lo.view(torch.int32)
    return torch.where(valid, low ^ rows.view(torch.int32).view(lo.shape),
                       low).view(torch.uint32)


def equal_outside(got, want, mask) -> bool:
    """(tagv, payv) equal on every window outside `mask`."""
    keep = ~mask
    return all(torch.equal(g.view(torch.int32)[keep],
                           w.view(torch.int32)[keep])
               for g, w in zip(got, want))


def probe_ladder(b, wl: str, built, reps: int, warm_only: bool) -> dict:
    """One workload's K2 ladder; `built` waits for the variant libraries
    (None on the CPU)."""
    cfg, clf = pe.workload_config(b, wl)
    packed, vmask = first_batches(cfg, 1)[0]
    dev = clf.device
    pk = torch.from_numpy(packed).to(dev)
    vm = torch.from_numpy(vmask).to(dev)
    dix, hmeta = clf.dix, clf._hmeta
    L = pk.shape[1] * 4
    meta, _ = clf._geometry(L)
    hi, lo, valid, _ = step.front_end(pk, vm, meta)
    c, bidx, stash_mask = window_counts(hi, lo, valid, dix.table, dix.stash,
                                        hmeta)
    rungs = rung_bounds(c, hmeta.slots, dix.stash.numel() * 4)
    line = {"workload": wl, "probe": clf.probe, "batch_size": pk.shape[0],
            "max_read_len": L, "windows_a_read": hi.shape[1],
            "lgB": hmeta.lgB, "entry16": hmeta.entry16,
            "slots": hmeta.slots, "table_mb": dix.table.numel() * 4 / 2**20,
            "counts": c, "rungs": rungs}
    args = (hi, lo, valid, dix.table, dix.stash, hmeta)
    plain = hashed.probe_hashed_plain(*args)
    p2 = hmeta.entry16 and hmeta.slots == 8
    checks = {}
    if p2:
        p2_rows, p2_want = cs.resident_operands(hi, lo, valid, hmeta.lgB)
        t128 = dix.table.view(-1, 128)

        def p2_call():
            return R.resident_match(p2_rows, p2_want, t128)
        got = p2_call().view(*lo.shape, 2)
        checks["resident_match_equals_plain_outside_stash"] = equal_outside(
            (got[..., 0], got[..., 1]), plain, stash_mask)
    gathered = floors.rows(dix.table, bidx, c["bucket_bytes"])
    checks["gather_equals_plain"] = torch.equal(
        gathered, floors.rows_plain(dix.table, bidx, c["bucket_bytes"]))
    if built is None:
        line["checks"] = checks
        return line
    flush = None if warm_only else timers.l2_flusher(device=dev)
    want = hashed.probe_hashed(*args, dix.stash_rows)
    checks["probe_hashed_equals_plain"] = pf.same(want, plain)
    calls = {}
    for r, (fn, occ) in built().items():
        call = kernels.probe_variant_caller(fn, True, dix.table, hmeta)
        calls[r] = (lambda call=call: call(hi, lo, valid, dix.stash,
                                           dix.stash_rows))
        rungs[r].update(occupancy(occ, int(hmeta.entry16), hmeta.slots,
                                  dix.stash_rows if r == "p" else 0))
    results = time_rounds(rungs, calls, reps, flush, f"profile_probe {wl}")
    checks["p_equals_probe_hashed"] = pf.same(results["p"], want)
    checks["p_equals_plain"] = pf.same(results["p"], plain)
    checks["m_equals_p_outside_stash"] = equal_outside(
        results["m"], results["p"], stash_mask)
    top = torch.where(valid, -(1 << 31), 0).to(torch.int32)
    checks["w_writes_its_streams"] = pf.same(
        results["w"], ((lo.view(torch.int32) ^ top).view(torch.uint32), hi))
    checks["b_folds_its_buckets"] = pf.same(results["b"], (bucket_fold(
        hi, lo, valid, dix.table, hmeta.lgB, c["bucket_bytes"]), hi))
    pf.climb_both(line, rungs, CUMULATIVE, "p", flush is not None)
    anchors = {"front": timing(lambda: step.front_end(pk, vm, meta), reps,
                               None),
               "gather": {"row_bytes": c["bucket_bytes"],
                          "rows": int(bidx.numel()),
                          **timing(lambda: floors.rows(
                              dix.table, bidx, c["bucket_bytes"]), reps,
                              flush)}}
    if p2:
        anchors["resident_match"] = timing(p2_call, reps, flush)
    line["anchors"] = anchors
    line["checks"] = checks
    return line


def ab(b, device, reps: int) -> dict:
    """kernel_ab.py's A/B on the panel (module docstring)."""
    m = bench_gpu.Main(b)
    cfgs = {L: b.config("panel", m.fasta, m.fastq, max_len=L)
            for L in (104, 128)}
    index, hashed_clf = b.classifier("panel", cfgs[104], m.idx_dir)
    t0 = time.perf_counter()
    classic = Classifier(index, max_winners=cfgs[104].max_winners,
                         c=cfgs[104].c, device=device, probe="classic")
    out = {"classic_tables_s": time.perf_counter() - t0,
           "bf_rank_gb": classic.dix.bf_rank.numel() * 4 / 1e9}
    batches = {L: first_batches(cfg, AB_BATCHES) for L, cfg in cfgs.items()}
    on_card = device.type == "cuda"
    got = {}
    setups = {}
    for probe, L in AB_SETUPS:
        clf = classic if probe == "classic" else hashed_clf
        bs = batches[L]
        name = f"{probe}_L{L}"
        got[name] = [clf.call_packed(pk, vm)[0].cpu() for pk, vm in bs]
        row = {"batches": len(bs), "batch_size": bs[0][0].shape[0]}
        if on_card:
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                outs = [clf.call_packed(pk, vm) for pk, vm in bs]
                for o in outs:
                    o[0].cpu()
                best = min(best, (time.perf_counter() - t0) / len(bs))
            row["ms_a_batch"] = best * 1e3
            row["reads_per_s"] = row["batch_size"] / best
            res = [(torch.from_numpy(pk).to(device),
                    torch.from_numpy(vm).to(device)) for pk, vm in bs]
            d = timers.device_profile(lambda: [clf.call_packed(pk, vm)
                                               for pk, vm in res], reps,
                                      warn=log)
            row["device_ms_a_batch"] = (d["device_ms"] / len(bs)
                                        if d["device_ms"] else None)
            row["host_ms_a_batch"] = d["host_ms"] / len(bs)
            if "device_ms_suspect" in d:
                row["device_ms_suspect"] = d["device_ms_suspect"]
        setups[name] = row
        log(f"ab {name}: {json.dumps(row)}")
    names = list(got)
    out["setups"] = setups
    out["verdicts_equal"] = all(
        torch.equal(got[names[0]][i], got[x][i])
        for x in names[1:] for i in range(len(got[names[0]])))
    if on_card:
        h = setups["hashed_L104"]["ms_a_batch"]
        c104 = setups["classic_L104"]["ms_a_batch"]
        out["classic_L104_over_hashed"] = c104 / h
        out["classic_L128_over_L104"] = (setups["classic_L128"]["ms_a_batch"]
                                         / c104)
    return out


def run(device, wl: str, with_ab: bool, reps: int,
        warm_only: bool = False) -> dict:
    on_card = device.type == "cuda"
    texts = variant_texts()
    checks = {"variant_texts_built": True,
              "p_text_is_committed": rung_source("p", pf.committed(
                  "probe.cu")) == pf.committed("probe.cu")}
    built = pf.start_builds(SCRIPT, texts, "shkk_probe",
                            "shkk_probe_occupancy") if on_card else None
    b = bench_gpu.Bench(device, float("inf"))
    line = probe_ladder(b, wl, built, reps, warm_only)
    checks.update(line.pop("checks"))
    if with_ab:
        line["ab"] = ab(b, device, reps)
        checks["ab_verdicts_equal"] = line["ab"]["verdicts_equal"]
    line["checks"] = checks
    return line


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", choices=("panel", "homolog"),
                    default="panel")
    ap.add_argument("--ab", action="store_true",
                    help="also the classic against hashed A/B (panel)")
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
    line = run(device, args.workload, args.ab, args.reps, args.warm_only)
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
