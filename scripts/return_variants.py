#!/usr/bin/env python3
"""Time variants of the sharded return (K7c, shard_return_kernel in
csrc/route.cu) and of the resident bucket match (P2,
csrc/resident_match.cu) of shark_tpu_torch on one CUDA card, in one
process, each on one allocation of the same inputs, beside what they are
held to.

    python3 scripts/return_variants.py [OTHER_CHECKOUT ...]

Every variant is built by nvcc into a library of its own under
build/variants/ and called through its C entry point, and is first
held to the plain version (exact); then all are timed back to back (20
launches between two CUDA events, L2 warm) in two rounds of alternating
order, and each is given its device time (chip_smoke.device_profile:
torch.profiler, held against the back-to-back time) and its CUDA-event
time (median of 7, L2 flushed).

K7c, on chip_smoke.py's 50,000-gene transcriptome index split into 8
shards on the card, at B = 8192 and 65536, L = 104: the replies K7b gives
to the slots K7a routes. Variants: this checkout's route.cu and each
OTHER_CHECKOUT's that differs; where a source has the one-thread-a-window
kernel that divides each window's flat index by Pn (the kernel before
the 2-D grid), that kernel on a 2-D grid (a block row a source, no
division); where it has the 2-D grid of 4 windows a thread, that kernel
with its reply loads through the read-only path without L1 allocation,
and where it has the knobs (commit 8217fec), with 2 chunks of 4 windows
a thread and with streaming loads of slot and owner. Each on the
contiguous [source, owner] replies, and on the path as the classifier
runs it: a kernel that takes strides reads the [owner, source] replies in
place, one that does not takes the exchange's contiguous copy first. The
copy itself is timed too, and the wrapper's host time per call.

P2, at experiments/resident_match.py's defaults (5,767,168 probes of a
16 MB entry16 table, lgB = 19): this checkout's resident_match.cu, each
OTHER_CHECKOUT's that differs, and, where the source has them, the kernel
without its L2 evict-last policy on the table loads, without its
streaming hints on rows, want and out, and without both, and, where it
has the knobs (commit 8217fec: two lanes a probe), at 1, 2 and 4 probes
a thread (4 also with a warp's outputs staged through shared memory so
that each store covers 512 contiguous bytes); beside a bare
streaming pass over the same bytes (16-byte loads of rows and want,
16-byte stores of 8 bytes a probe, with and without the streaming hints;
no table: timing only) and chip_smoke.py's bare 32-byte gather of the
valid probes' buckets (no streams), and the flushed, 64-byte-sector and
warm bounds.
"""

import ctypes
import functools
import os
import re
import shutil
import sys

import numpy as np
import torch

import probe_variants as pv
from probe_variants import cs, timers
from shark_tpu_torch import kernels
from shark_tpu_torch.classify import step
from shark_tpu_torch.experiments import resident_match as R
from shark_tpu_torch.io import native
from shark_tpu_torch.parallel import sharded_bf as sb
from shark_tpu_torch.utils.timers import cuda_ms

L = 104
SHAPES = (8192, 65536)
_VP, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# K7c before the 2-D grid: back, Pn, total, n, cap, owner, slot, tagv,
# payv, stream
OLD_RETURN = "long long total, int n,"
OLD_ARGS = [_VP, _L, _L, _I, _L, _VP, _VP, _VP, _VP, _VP]
GRID2D = (
    ("  const long long i = (long long)blockIdx.x * blockDim.x + "
     "threadIdx.x;\n  if (i >= total) return;",
     "  const u32 j = blockIdx.x * blockDim.x + threadIdx.x;\n"
     "  if (j >= (u32)Pn) return;\n"
     "  const long long i = (long long)blockIdx.y * Pn + j;"),
    ("back[((i / Pn) * n + owner[i]) * cap + sl]",
     "back[((long long)blockIdx.y * n + owner[i]) * cap + sl]"),
    ("shard_return_kernel<<<grid_for(total, kThreads), kThreads, 0,",
     "shard_return_kernel<<<dim3(grid_for(Pn, kThreads), "
     "(unsigned)(total / Pn)), kThreads, 0,"),
)
# the 2-D grid's knobs (commit 8217fec has the first two; the last is
# committed)
CHUNKS = "constexpr int kReturnChunks = 1;"
RETURN_STREAM = "#define SHKK_RETURN_STREAM 0"
RETURN_LOAD = '#define SHKK_RETURN_LOAD "ld.global.v2.u32"'
RETURN_EDITS = {
    "chunks2": ((CHUNKS, CHUNKS.replace("1;", "2;")),),
    "stream": ((RETURN_STREAM, RETURN_STREAM[:-1] + "1"),),
    "nc": ((RETURN_LOAD, RETURN_LOAD.replace(
        "ld.global", "ld.global.nc.L1::no_allocate")),),
}
# P2's knobs (commit 8217fec has all but the streaming hint; the
# streaming hint is committed)
PROBES = re.compile(r"constexpr int kProbes = (\d);")
TABLE_HINT = "#define SHKK_MATCH_TABLE_HINT 1"
STREAM_HINT = "#define SHKK_MATCH_STREAM_HINT 1"
STAGE = "#define SHKK_MATCH_STAGE 0"
PAIR = "#define SHKK_MATCH_PAIR 1"
MATCH_EDITS = {
    "no_evict_last": ((TABLE_HINT, TABLE_HINT[:-1] + "0"),),
    "no_stream_hints": ((STREAM_HINT, STREAM_HINT[:-1] + "0"),),
    "no_hints": ((TABLE_HINT, TABLE_HINT[:-1] + "0"),
                 (STREAM_HINT, STREAM_HINT[:-1] + "0")),
}
MATCH_ARGS = kernels._SIGNATURES["shkk_resident_match"]

# A bare streaming pass over P2's bytes, not a kernel of the port: four
# probes a thread, 16-byte loads of rows and want, two 16-byte stores of
# (rows, want) pairs; kCs picks the streaming (evict-first) forms.
STREAM_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>
template <bool kCs>
__global__ void stream_pass(const int4* __restrict__ rows,
                            const uint4* __restrict__ want, unsigned n4,
                            uint4* __restrict__ out) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n4) return;
  const int4 r = kCs ? __ldcs(rows + t) : rows[t];
  const uint4 w = kCs ? __ldcs(want + t) : want[t];
  const uint4 a = make_uint4((unsigned)r.x, w.x, (unsigned)r.y, w.y);
  const uint4 b = make_uint4((unsigned)r.z, w.z, (unsigned)r.w, w.w);
  if (kCs) {
    __stcs(out + 2 * t, a);
    __stcs(out + 2 * t + 1, b);
  } else {
    out[2 * t] = a;
    out[2 * t + 1] = b;
  }
}
extern "C" int shkk_stream_pass(const void* rows, const void* want,
                                long long n, void* out, int streaming,
                                void* stream) {
  const unsigned n4 = (unsigned)(n / 4);
  const unsigned grid = (n4 + 255) / 256;
  cudaStream_t st = (cudaStream_t)stream;
  if (streaming)
    stream_pass<true><<<grid, 256, 0, st>>>((const int4*)rows,
                                            (const uint4*)want, n4,
                                            (uint4*)out);
  else
    stream_pass<false><<<grid, 256, 0, st>>>((const int4*)rows,
                                             (const uint4*)want, n4,
                                             (uint4*)out);
  return (int)cudaGetLastError();
}
"""


def edited(text, edits):
    for a, b in edits:
        assert a in text, a
        text = text.replace(a, b)
    return text


def texts_of(name, others, edits_for):
    """{variant: (source text, include dir)}: this checkout's csrc/<name>,
    each OTHER_CHECKOUT's that differs, and each of those with the edits
    edits_for(text) names (those its text has)."""
    src, inc = pv.source(pv.OWN_ROOT, name)
    bases = {"committed": (src, inc)}
    for k, other in enumerate(others):
        text, oinc = pv.source(other, name)
        if text != src:
            bases[f"other{k}"] = (text, oinc)
    out = {}
    for base, (text, binc) in bases.items():
        out[base] = (text, binc)
        for edit, pairs in edits_for(text).items():
            out[f"{base}_{edit}"] = (edited(text, pairs), binc)
    return out


def return_edits(text):
    if OLD_RETURN in text:
        return {"grid2d": GRID2D}
    return {k: v for k, v in RETURN_EDITS.items()
            if all(a in text for a, _ in v)}


def match_edits(text):
    """The hints off, and the other probe counts a thread (4 also with
    its outputs staged through shared memory), where the text has them."""
    out = {k: v for k, v in MATCH_EDITS.items()
           if all(a in text for a, _ in v)}
    m = PROBES.search(text)
    if m is None:
        return out
    if PAIR in text:  # the pair kernel committed: the others by kProbes
        out = {f"pair_{k}": v for k, v in out.items()}
        unpair = ((PAIR, PAIR[:-1] + "0"),)
        for p in (1, 2, 4):
            out[f"p{p}"] = unpair + ((m.group(0), m.group(0).replace(
                m.group(1), str(p))),)
        out["p4_staged"] = out["p4"] + ((STAGE, STAGE[:-1] + "1"),)
        out["p1_no_hints"] = out["p1"] + MATCH_EDITS["no_hints"]
        return out
    for p in (1, 2, 4):
        probes = (m.group(0), m.group(0).replace(m.group(1), str(p)))
        if p != int(m.group(1)):
            out[f"p{p}"] = (probes,)
        if p == 4 and STAGE in text:
            out["p4_staged"] = (probes, (STAGE, STAGE[:-1] + "1"))
    return out


def return_variants(others):
    """{name: (build waiter, takes strides)} of K7c's variants."""
    out = {}
    for name, (text, inc) in texts_of("route.cu", others,
                                      return_edits).items():
        old = OLD_RETURN in text
        out[name] = (kernels.build_variant(
            f"return_{name}", text, inc, "shkk_shard_return",
            OLD_ARGS if old else kernels._SIGNATURES["shkk_shard_return"]),
            not old)
    return out


def match_variants(others):
    """{name: build waiter} of P2's variants and the bare streaming pass."""
    out = {name: kernels.build_variant(f"match_{name}", text, inc,
                                       "shkk_resident_match", MATCH_ARGS)
           for name, (text, inc) in texts_of("resident_match.cu", others,
                                             match_edits).items()}
    out["stream_pass"] = kernels.build_variant(
        "stream_pass", STREAM_SRC, pv.OWN_ROOT, "shkk_stream_pass",
        [_VP, _VP, _L, _VP, _I, _VP])
    return out


def return_caller(fn, strided):
    """(back [S, n, cap, 2], owner, slot) -> (tagv, payv) through one K7c
    variant; a variant without strides takes a contiguous back only."""
    def call(back, owner, slot):
        S, b, Ls = slot.shape
        Pn = b * Ls
        st = torch.cuda.current_stream().cuda_stream
        if strided:
            out = torch.empty((2, S, b, Ls), dtype=torch.uint32,
                              device=slot.device)
            rc = fn(back.data_ptr(), back.stride(0) // 2,
                    back.stride(1) // 2, S, Pn, owner.data_ptr(),
                    slot.data_ptr(), out.data_ptr(), st)
            assert rc == 0, rc
            return out[0], out[1]
        assert back.is_contiguous()
        tagv = torch.empty((S, b, Ls), dtype=torch.uint32, device=slot.device)
        payv = torch.empty_like(tagv)
        rc = fn(back.data_ptr(), Pn, S * Pn, back.shape[1], back.shape[2],
                owner.data_ptr(), slot.data_ptr(), tagv.data_ptr(),
                payv.data_ptr(), st)
        assert rc == 0, rc
        return tagv, payv
    return call


def txome_index():
    """(genes, index) of chip_smoke.py's transcriptome."""
    work = os.path.join(pv.OWN_ROOT, "build", "return_variants")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        genes = cs.txome_genes(np.random.default_rng(2026))
        fa = os.path.join(work, "genes.fa")
        cs.write_fasta(fa, genes, b"G")
        index = native.build_index_native(fa, cs.K, cs.BF_GB << 33,
                                          threads=os.cpu_count())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return genes, index


def host_us(fn):
    """Host time of one call, over 20 calls queued without a
    synchronisation (chip_smoke.queue_ms)."""
    return timers.queue_ms(fn)[1] * 1e3


def say_times(name, fn):
    """One variant's device, event (L2 flushed) and host times."""
    p = cs.device_profile(fn)
    dev = p["device_ms"]
    flag = "  device_ms_suspect" if "device_ms_suspect" in p else ""
    print(f"  {name}: device "
          f"{'not measured' if dev is None else f'{dev:.4f}'}, event "
          f"{cuda_ms(fn, reps=cs.REPS):.4f}, host {p['host_ms'] * 1e3:.1f} "
          f"us{flag}", flush=True)


def time_return(built, genes, index):
    """K7c's variants at B x L on the 8 shards' replies."""
    n = cs.SHARDS
    dev = torch.device("cuda", 0)
    sclf = sb.ShardedBFClassifier(index, max_winners=16, c=cs.C,
                                  devices=[dev] * n)
    tables = sclf.dix[dev]
    calls = {name: (return_caller(fn(), strided), strided)
             for name, (fn, strided) in built.items()}
    rng = np.random.default_rng(2028)
    for B in SHAPES:
        meta = step.StaticMeta.for_index(index, L, allow_wide=True)
        codes = torch.from_numpy(cs.codes_for_shape(
            rng, genes, B, L, single=cs.panel_reads)).to(dev)
        hi, lo, valid, _ = step.front_end(*step.pack_codes(codes), meta)
        wins = (t.view(n, B // n, -1) for t in (hi, lo, valid))
        cap = sclf._probe_cap(B // n, L)
        send, slot, owner, _ = sb.shard_route(*wins, n=n, wps=sclf.wps,
                                              wide=False, cap=cap)
        reply = sb.shard_probe(cs._transposed(send), tables.bf_rank,
                               tables.pay)
        back = cs._transposed(reply)
        view = reply.transpose(0, 1)
        want = sb.shard_return_plain(back, owner, slot)
        for name, (call, strided) in calls.items():
            cs.same(f"shard_return variant {name}", call(back, owner, slot),
                    want)
            if strided:
                cs.same(f"shard_return variant {name} in place",
                        call(view, owner, slot), want)
        print(f"return: {torch.cuda.get_device_name(0)}; B={B} L={L}, {n} "
              f"shards, cap {cap}, {slot.numel()} windows, "
              f"{int((slot >= 0).sum())} routed, replies "
              f"{reply.numel() * 4 / 1e6:.1f} MB; all variants exact; "
              f"back-to-back ms (L2 warm):", flush=True)

        def path(c, strided):
            if strided:
                return lambda: c(view, owner, slot)
            return lambda: c(cs._transposed(reply), owner, slot)
        pv.say_runs(pv.alternate(calls, {
            "contiguous": lambda v: lambda: v[0](back, owner, slot),
            "as run": lambda v: path(*v)}))
        for name, (c, strided) in calls.items():
            say_times(f"{name} contiguous", lambda c=c: c(back, owner, slot))
            say_times(f"{name} as run ({'in place' if strided else 'copy'}"
                      f" + kernel)", path(c, strided))
        say_times("exchange back (transpose(0, 1).contiguous())",
                  lambda: cs._transposed(reply))
        print(f"  host us a call: shard_return wrapper "
              f"{host_us(lambda: sb.shard_return(back, owner, slot)):.1f} "
              f"on the contiguous replies, "
              f"{host_us(lambda: sb.shard_return(view, owner, slot)):.1f} "
              f"in place; the exchange copy "
              f"{host_us(lambda: cs._transposed(reply)):.1f}", flush=True)
        del send, slot, owner, reply, back, view


def time_match(built):
    """P2's variants and the streaming pass at the experiment's
    defaults."""
    dev = torch.device("cuda", 0)
    host = R.build_inputs(R.N_BATCH, R.LGB)
    table = torch.from_numpy(host[0]).to(dev)
    bucket = torch.from_numpy(host[1]).to(dev)
    valid = torch.from_numpy(host[3]).to(dev)
    rows, want, t128 = (torch.from_numpy(a).to(dev)
                        for a in R.probe_inputs(*host))
    del host
    n = rows.numel()
    st = torch.cuda.current_stream().cuda_stream

    def caller(fn):
        def call():
            out = torch.empty((n, 2), dtype=torch.uint32, device=dev)
            rc = fn(rows.data_ptr(), want.data_ptr(), t128.data_ptr(), n,
                    out.data_ptr(), st)
            assert rc == 0, rc
            return out
        return call

    stream_fn = built.pop("stream_pass")()

    def stream_pass(streaming):
        def call():
            out = torch.empty((n, 2), dtype=torch.uint32, device=dev)
            rc = stream_fn(rows.data_ptr(), want.data_ptr(), n,
                           out.data_ptr(), streaming, st)
            assert rc == 0, rc
            return out
        return call
    calls = {name: caller(fn()) for name, fn in built.items()}
    plain = R.resident_match_plain(rows, want, t128)
    for name, call in calls.items():
        cs.same(f"resident_match variant {name}", [call()], [plain])
    cs.same("stream pass", [stream_pass(1)(), stream_pass(0)()],
            [torch.stack([rows.view(torch.uint32), want], 1)] * 2)
    b64 = bucket.to(torch.int64)[valid]
    touched = int(torch.unique(b64).numel())
    lines64 = int(torch.unique(b64 >> 1).numel())
    ms = lambda nbytes: nbytes / cs.PEAK_BYTES_S * 1e3  # noqa: E731
    print(f"resident match: {torch.cuda.get_device_name(0)}; {n} probes, "
          f"{int(valid.sum())} valid, {touched} buckets touched "
          f"({lines64} 64-byte lines); bounds ms: flushed "
          f"{ms(n * 16 + touched * 32):.4f}, in 64-byte sectors "
          f"{ms(n * 16 + lines64 * 64):.4f}, warm {ms(n * 16):.4f}; all "
          f"variants exact; back-to-back ms (L2 warm):", flush=True)
    calls["stream_pass_cs"] = stream_pass(1)
    calls["stream_pass_plain"] = stream_pass(0)
    # the bare 32-byte gather of the valid probes' buckets (chip_smoke's)
    gathers = cs.Gathers()
    bidx = bucket[valid]
    cs.same("gather32 of the buckets", [gathers.rows(table, bidx, 32)],
            [cs.xor_rows(table.view(torch.int32)[bidx.long()])])
    calls["gather32"] = lambda: gathers.rows(table, bidx, 32)
    pv.say_runs(pv.alternate(calls, {"warm": lambda c: c}))
    for name, c in calls.items():
        say_times(name, c)
        warm = cuda_ms(c, reps=cs.REPS, flush=False)
        print(f"  {name}: event, L2 warm {warm:.4f}", flush=True)
    fn = functools.partial(R.resident_match, rows, want, t128)
    print(f"  host us a call: resident_match wrapper {host_us(fn):.1f}",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this script times kernels on the card",
              file=sys.stderr)
        return 1
    native.rebuild()  # a library built on another host may not load here
    kernels.build(force=True)
    others = sys.argv[1:]
    returns = return_variants(others)  # every nvcc started here
    matches = match_variants(others)
    time_match(matches)
    genes, index = txome_index()
    time_return(returns, genes, index)
    return 0


if __name__ == "__main__":
    sys.exit(main())
