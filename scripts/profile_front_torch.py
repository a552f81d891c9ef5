#!/usr/bin/env python3
"""K1's device time by sub-stage on one CUDA card: the port's counterpart
of bench/profile_front.py.

    python3 scripts/profile_front_torch.py [--workload txome|panel]
        [--reads N] [--reps R] [--warm-only] [--cpu] [--cache DIR]

The reference cut its front end (unpack, canonical k-mers, XXH64, mod
size) into cumulative jits and timed each. On the card the front end is
one kernel (K1, shark_tpu_torch/csrc/front.cu, staged path front_kernel),
so each rung here is a timing-only variant of front.cu: text made at run
time from the committed source by checked substitutions (every anchor
found exactly once, else the script raises), built by nvcc into
build/variants/profile_front_torch/<rung>/ (kernels.build_variant) and
launched through the port's own wrapper (step.front_end), whose library
entry point is routed to the variant (`routed`). No variant is a kernel of
the port. The rungs, cumulative:

    s   stage the planar rows into shared memory (16-byte loads) and
        build the `where` table; one byte of each staged read is folded
        into the length slot so that the loads stay live
    d   s + decode into the F/R/V bit streams (put_word) and the length
    c   d + each window's canonical k-mer (funnel shifts, min of forward
        and reverse complement), stored folded to (hi, lo)
    h   c + xxh64_8 of it, stored as (hi, lo)
    m   the whole K1: the mod and win_valid; its text is the committed
        source, and it must equal step.front_end and its plain version
    m2  m at a Bloom size that is a multiple of 2^32 but not a power of
        two (mod_mode 2, the magic-number remainder); must equal the
        plain version
    l   the length alone: the validity rows staged and decoded by ballot
        (the code rows not staged); must give K1's lengths

d's and l's lengths must also equal K1's. Each rung gives its device ms
(shark_tpu_torch/utils/timers.py device_profile: least of three profiler
sessions, each held against the back-to-back time; a reading none of
whose sessions agrees is marked *_suspect), with the L2 warm and flushed
(128 MB written before every call; --warm-only: warm alone), its delta from the rung below, its
own lower bound (the larger of its bytes over 3.35 TB/s and its integer
operations over 16.7 T/s), its share of m, and its occupancy: active
blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor, exported by
the variant's own source) and the dynamic shared memory of a block.
`furthest` names the cumulative rung whose own piece (its delta) is
furthest above the piece's bound. A batch of 64 reads at L = 32768
(front_long_kernel, off the main path) gets its whole-kernel time only.

The batch is the workload's first at bench_gpu.py's B = 65536, L = 104:
the txome's (the reference's choice; no index is built, since K1 reads
only k and the Bloom size) or the panel's. Runs on cuda:0; --cpu runs the
plain versions and the text checks and builds nothing; without a card
and without --cpu it exits 1. Prints one JSON line with every reading and
a `checks` map; exits 1 when a check fails. --reads N and --cache DIR as
in scripts/profile_e2e_torch.py.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bench_gpu  # noqa: E402
import chip_smoke  # noqa: E402
import profile_e2e_torch as pe  # noqa: E402
from ab_layout_torch import first_batches  # noqa: E402
from shark_tpu_torch import kernels  # noqa: E402
from shark_tpu_torch.classify import step  # noqa: E402
from shark_tpu_torch.utils import timers  # noqa: E402

MOD2_BITS = 3 << 32  # m2: a multiple of 2^32, not a power of two
LONG_SHAPE = (64, 32768)  # front_long_kernel (L > 16384)

CUMULATIVE = ("s", "d", "c", "h", "m")
# Integer operations a window of each cumulative rung: chip_smoke.py's 50
# for the whole K1, split by the work each piece adds: the decode about 6
# (the where lookup, two shared loads, shifts and masks, a share of the
# five warp reductions), the canonical k-mer 10 (two 64-bit funnel shifts
# and the min), XXH64 28 (five 64-bit multiplies of three 32-bit
# multiply-adds each, two rotates, three xor-shifts), the mod and the
# validity bits 6.
OPS_A_WINDOW = {"s": 0, "d": 6, "c": 16, "h": 44, "m": 50, "m2": 50,
                "l": 0}

ANCHOR_KERNEL = ("__global__ void __launch_bounds__(kWarps * 32) "
                 "front_kernel(const FrontArgs a) {")
ANCHOR_LOOP = "  for (int r = warp; r < nr; r += kWarps) {"
ANCHOR_LOOP_END = "}\n\n// Reads longer than kMaxShortL"
ANCHOR_EMIT_LOOP = ("    for (int j = lane; j < a.Ls; j += 32)\n"
                    "      emit_window(a, row + j, F, R, V, first + j);\n")
ANCHOR_EMIT_CALL = "emit_window(a, row + j, F, R, V, first + j);"
ANCHOR_STAGE_CODES = "  stage(sp, a.packed + b0 * L4, nr * L4, a.vec);\n"

LOOP_S = """  for (int r = warp; r < nr; r += kWarps)
    if (lane == 0)
      a.length[b0 + r] = sp[r * L4] ^ sv[r * L8] ^ (int)where[32 + r];
"""
LOOP_L = """  for (int r = warp; r < nr; r += kWarps) {
    const uint8_t* vrow = sv + r * L8;
    int n_valid = 0;
    for (int c = 0; c < NC; ++c) {
      const u32 w = where[32 * c + lane];
      const u32 v = w != 0xFFFFFFFFu
                        ? (vrow[(w >> 12) & 0xFFFu] >> (w >> 27)) & 1u
                        : 0u;
      n_valid += __popc(__ballot_sync(kFull, v));
    }
    if (lane == 0) a.length[b0 + r] = n_valid;
  }
"""
# every variant (and m) exports its staged kernel's occupancy at L
OCCUPANCY = """
extern "C" int shkk_front_occupancy(int L, int* blocks, int* smem) {
  int reads = kReads;
  if (front_smem(L, kReads) > 48 * 1024) {
    const size_t optin = (size_t)shkk_max_smem_optin();
    while (reads > 1 && front_smem(L, reads) > optin) reads >>= 1;
  }
  const size_t bytes = front_smem(L, reads);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        front_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  *smem = (int)bytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, front_kernel, kWarps * 32, bytes);
}
"""


class VariantError(RuntimeError):
    """A committed source no longer holds a variant's anchor once."""


def log(msg: str) -> None:
    print(f"[profile_front] {msg}", file=sys.stderr, flush=True)


def replace_once(text: str, old: str, new: str, what: str) -> str:
    """text with `old`, which it must hold exactly once, replaced."""
    n = text.count(old)
    if n != 1:
        raise VariantError(f"{what} holds {old!r} {n} times, not once")
    return text.replace(old, new)


def replace_span(text: str, start: str, end: str, new: str,
                 what: str) -> str:
    """text with the span from `start` up to (not including) `end`
    replaced by `new`; each anchor found exactly once, `end` after
    `start`."""
    for a in (start, end):
        n = text.count(a)
        if n != 1:
            raise VariantError(f"{what} holds {a!r} {n} times, not once")
    i, j = text.index(start), text.index(end)
    if j < i:
        raise VariantError(f"{what}: {end!r} comes before {start!r}")
    return text[:i] + new + text[j:]


def function_text(text: str, head: str, what: str) -> str:
    """The definition that starts at `head` (found once) through its
    closing brace at the start of a line."""
    n = text.count(head)
    if n != 1:
        raise VariantError(f"{what} holds {head!r} {n} times, not once")
    i = text.index(head)
    return text[i: text.index("\n}\n", i) + 3]


def committed(name: str) -> str:
    with open(os.path.join(kernels.CSRC, name)) as f:
        return f.read()


def emit_rung(text: str, hashed_key: bool) -> str:
    """emit_window of front.cu as emit_rung: the canonical k-mer (or its
    XXH64) stored as (hi, lo), no mod and no validity bits."""
    what = "front.cu emit_window"
    fn = function_text(text, "__device__ __forceinline__ void emit_window(",
                       what)
    fn = replace_once(fn, "void emit_window(", "void emit_rung(", what)
    fn = replace_span(fn, "  const u32 vbits", "  const u64 h = xxh64_8",
                      "", what)
    if not hashed_key:
        fn = replace_once(fn, "xxh64_8(fwd < rc ? fwd : rc)",
                          "(fwd < rc ? fwd : rc)", what)
    return replace_span(fn, "  u32 hi = (u32)(h >> 32);", "\n}\n",
                        "  a.idx_hi[at] = (u32)(h >> 32);\n"
                        "  a.idx_lo[at] = (u32)h;", what)


def rung_source(rung: str, text: str) -> str:
    """front.cu (`text`) cut to `rung`; m (and m2, which is m at another
    Bloom size) is the committed text itself."""
    what = "front.cu"
    if rung in ("m", "m2"):
        return text
    if rung == "s":
        return replace_span(text, ANCHOR_LOOP, ANCHOR_LOOP_END, LOOP_S, what)
    if rung == "l":
        text = replace_once(text, ANCHOR_STAGE_CODES, "", what)
        return replace_span(text, ANCHOR_LOOP, ANCHOR_LOOP_END, LOOP_L, what)
    if rung == "d":
        return replace_once(text, ANCHOR_EMIT_LOOP, "", what)
    if rung in ("c", "h"):
        fn = emit_rung(text, rung == "h")
        text = replace_once(text, ANCHOR_KERNEL, fn + "\n" + ANCHOR_KERNEL,
                            what)
        return replace_once(text, ANCHOR_EMIT_CALL,
                            "emit_rung(a, row + j, F, R, V, first + j);",
                            what)
    raise ValueError(f"unknown rung {rung!r}")


RUNG_LIBS = ("s", "d", "c", "h", "m", "l")  # m2 runs m's library


def variant_texts() -> dict:
    """{rung: the variant's full text (its rung source and the occupancy
    export)} of every library built; raises VariantError when the
    committed front.cu no longer holds an anchor once."""
    text = committed("front.cu")
    return {r: rung_source(r, text) + OCCUPANCY for r in RUNG_LIBS}


def start_builds(script: str, texts: dict, entry: str, occupancy: str):
    """Starts nvcc on every variant at once (kernels.build_variant, under
    build/variants/<script>/<rung>/); returns a function that waits for
    them and gives {rung: (entry point, occupancy export)}."""
    waits = {r: kernels.build_variant(
        f"{script}/{r}", t, kernels.CSRC, entry, kernels._SIGNATURES[entry])
        for r, t in texts.items()}
    out = {}

    def built() -> dict:
        for r, done in waits.items():
            if r not in out:
                fn = done()  # nvcc has written the library
                so = ctypes.CDLL(os.path.join(kernels.VARIANT_DIR, script, r,
                                              "lib.so"))
                out[r] = (fn, getattr(so, occupancy))
        return out
    return built


@contextlib.contextmanager
def routed(**entries):
    """kernels.lib() gives the port's library with `entries` (C entry
    points of a variant library, by name) in place of its own, so that the
    port's wrapper marshals and launches the variant exactly as it does
    its kernel. The launch counters count those launches under the
    kernel's name."""
    real = kernels.lib
    base = real()

    class Routed:
        def __getattr__(self, name):
            return entries[name] if name in entries else getattr(base, name)

    proxy = Routed()
    kernels.lib = lambda: proxy
    try:
        yield
    finally:
        kernels.lib = real


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take (chip_smoke.bound: bytes over
    3.35 TB/s or integer operations over 16.7 T/s, whichever is
    larger)."""
    ms, by, _, _ = chip_smoke.bound(nbytes, ops)
    return {"bound_ms": ms, "bound_by": by, "bytes": nbytes,
            "operations": ops}


def climb(rungs: dict, order, top: str, key: str = "device_ms") -> str:
    """Adds to each rung of `order` (cumulative) its delta from the rung
    below, its bound's delta, how far each is above its bound and its
    share of `top`; returns the rung whose own piece is furthest above
    its bound (None without timings)."""
    below = None
    furthest, worst = None, None
    for name in order:
        r = rungs[name]
        ms = r.get(key)
        if ms is None:
            below = r
            continue
        r["gap_ms"] = ms - r["bound_ms"]
        r["share_of_" + top] = ms / rungs[top][key] if rungs[top].get(key) \
            else None
        if below is None:
            r["delta_ms"], r["delta_bound_ms"] = ms, r["bound_ms"]
        else:
            r["delta_ms"] = ms - below[key]
            r["delta_bound_ms"] = r["bound_ms"] - below["bound_ms"]
        r["delta_gap_ms"] = r["delta_ms"] - r["delta_bound_ms"]
        if worst is None or r["delta_gap_ms"] > worst:
            furthest, worst = name, r["delta_gap_ms"]
        below = r
    return furthest


def climb_both(line: dict, rungs: dict, order, top: str, flushed: bool):
    """line["furthest"] from climb over the cumulative rungs, and
    line["furthest_flushed"] from their flushed readings when `flushed`
    (climbed on copies, so that the warm fields stay)."""
    line["furthest"] = climb(rungs, order, top)
    if flushed:
        line["furthest_flushed"] = climb(
            {k: dict(v) for k, v in rungs.items()}, order, top,
            "device_ms_flushed")


def device_ms(fn, reps: int, flush=None, suffix: str = "") -> dict:
    """{"device_ms<suffix>", "device_ops<suffix>"[,
    "device_ms<suffix>_suspect"]} of timers.device_profile."""
    p = timers.device_profile(fn, reps, flush, warn=log)
    out = {"device_ms" + suffix: p["device_ms"],
           "device_ops" + suffix: p.get("device_ops")}
    if "device_ms_suspect" in p:
        out[f"device_ms{suffix}_suspect"] = p["device_ms_suspect"]
    return out


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def front_meta(size_bits: int) -> step.StaticMeta:
    """The geometry K1 reads: k and the Bloom size (the rest is the
    finish's and unused here)."""
    return step.StaticMeta(k=bench_gpu.K, size_bits=size_bits, n_genes=0,
                           degree=0, pos_bits=0)


def workload_batch(b, wl: str):
    """The first packed batch (packed, vmask) of `wl`, no index built."""
    if wl == "txome":
        fasta, fastq = bench_gpu.gen_txome(bench_gpu.TXOME_GENES,
                                          bench_gpu.TXOME_READS)
        cfg = b.config("txome", fasta, fastq)
    else:
        m = bench_gpu.Main(b)
        cfg = b.config("panel", m.fasta, **m.inputs("panel"))
    return first_batches(cfg, 1)[0]


def rung_bounds(B: int, L: int, Ls: int) -> dict:
    """{rung: bound} at B reads of L bases, Ls windows each: the planar
    rows in (the code rows not for l), 4 bytes of length out, and per
    window 8 bytes of (hi, lo) from c on and 1 of win_valid in m."""
    n = B * Ls
    rows_in = B * (L // 4 + L // 8)
    out = {}
    for r, ops in OPS_A_WINDOW.items():
        nbytes = (B * (L // 8) if r == "l" else rows_in) + B * 4
        nbytes += {"c": 8, "h": 8, "m": 9, "m2": 9}.get(r, 0) * n
        out[r] = bound(nbytes, ops * n)
    return out


def long_batch(device):
    """64 random reads of 32768 bases with Ns (seed 15), planar."""
    B, L = LONG_SHAPE
    rng = np.random.default_rng(15)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < 0.01] = step.INVALID
    return step.pack_codes(torch.from_numpy(codes).to(device))


def run(device, wl: str, reps: int, warm_only: bool = False) -> dict:
    on_card = device.type == "cuda"
    texts = variant_texts()
    checks = {"variant_texts_built": True,
              "m_text_is_committed": rung_source("m", committed("front.cu"))
              == committed("front.cu")}
    built = start_builds("profile_front_torch", texts, "shkk_front",
                         "shkk_front_occupancy") if on_card else None
    b = bench_gpu.Bench(device, float("inf"))
    packed, vmask = workload_batch(b, wl)
    pk = torch.from_numpy(packed).to(device)
    vm = torch.from_numpy(vmask).to(device)
    B, L = pk.shape[0], pk.shape[1] * 4
    Ls = L - min(bench_gpu.K - 1, L - 1)
    meta, meta2 = front_meta(bench_gpu.bf_bits()), front_meta(MOD2_BITS)
    rungs = rung_bounds(B, L, Ls)
    line = {"workload": wl, "batch_size": B, "max_read_len": L,
            "windows": Ls, "k": meta.k, "size_bits": meta.size_bits,
            "mod_mode": step._mod_size_params(meta.size_bits)[0],
            "m2_size_bits": MOD2_BITS, "rungs": rungs}
    plain = step.front_end_plain(pk, vm, meta)
    plain2 = step.front_end_plain(pk, vm, meta2)
    if not on_card:
        bits = sum((vm >> i) & 1 for i in range(8)).sum(dim=1)
        checks["plain_lengths_count_valid_bases"] = torch.equal(
            plain[3], bits.to(torch.int32))
        checks["plain_m2_in_range"] = bool(
            (plain2[0].to(torch.int64) < MOD2_BITS >> 32).all()) and torch.equal(
            plain2[2], plain[2])
        line["checks"] = checks
        return line
    want = step.front_end(pk, vm, meta)
    want2 = step.front_end(pk, vm, meta2)
    checks["front_end_equals_plain"] = same(want, plain)
    flush = None if warm_only else timers.l2_flusher(device=device)
    libs = built()
    for r in ("s", "d", "c", "h", "m", "m2", "l"):
        fn, occ = libs["m" if r == "m2" else r]
        mt = meta2 if r == "m2" else meta
        blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
        kernels.check(occ(L, ctypes.byref(blocks), ctypes.byref(smem)),
                      f"occupancy of {r}")
        row = rungs[r]
        row.update(blocks_per_sm=blocks.value, smem_bytes=smem.value)
        with routed(shkk_front=fn):
            got = step.front_end(pk, vm, mt)
            call = (lambda mt=mt: step.front_end(pk, vm, mt))
            row.update(device_ms(call, reps))
            if flush is not None:
                row.update(device_ms(call, reps, flush, "_flushed"))
        if r == "m":
            checks["m_equals_front_end"] = same(got, want)
            checks["m_equals_plain"] = same(got, plain)
        elif r == "m2":
            checks["m2_equals_front_end"] = same(got, want2)
            checks["m2_equals_plain"] = same(got, plain2)
        elif r in ("d", "l"):
            checks[f"{r}_length_equals_front_end"] = torch.equal(got[3],
                                                                 want[3])
        log(f"{r}: {json.dumps({k: v for k, v in row.items() if 'ops' not in k})}")
    climb_both(line, rungs, CUMULATIVE, "m", flush is not None)
    for r, base in (("m2", "m"), ("l", "s")):
        rungs[r]["gap_ms"] = rungs[r]["device_ms"] - rungs[r]["bound_ms"]
        rungs[r]["vs_" + base + "_ms"] = (rungs[r]["device_ms"]
                                          - rungs[base]["device_ms"])
        rungs[r]["share_of_m"] = (rungs[r]["device_ms"]
                                  / rungs["m"]["device_ms"])
    lp, lv = long_batch(device)
    lmeta = front_meta(bench_gpu.bf_bits())
    checks["long_equals_plain"] = same(step.front_end(lp, lv, lmeta),
                                       step.front_end_plain(lp, lv, lmeta))
    line["long_reads"] = {"batch_size": LONG_SHAPE[0],
                          "max_read_len": LONG_SHAPE[1],
                          **device_ms(lambda: step.front_end(lp, lv, lmeta),
                                      reps)}
    line["checks"] = checks
    return line


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", choices=("txome", "panel"),
                    default="txome")
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
            print("profile_front_torch: no CUDA card; the rungs run on the "
                  "card (--cpu runs the plain versions)", file=sys.stderr)
            return 1
    device = torch.device(device)
    pe.size_workloads(args.reads, args.cache)
    line = run(device, args.workload, args.reps, args.warm_only)
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
