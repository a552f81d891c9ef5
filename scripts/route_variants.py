#!/usr/bin/env python3
"""Time variants of the sharded router (K7a, shard_route in csrc/route.cu)
and of the classic probe (K5, csrc/classic.cu) of shark_tpu_torch on one
CUDA card, in one process, each on one allocation of the same tables and
the same windows, beside what they are held to.

    python3 scripts/route_variants.py [OTHER_CHECKOUT ...]

Every variant is built by nvcc into a library of its own under
build/variants/ and called through its C entry point, and is first
held to the plain version (exact, unless it is marked timing only); then
all are timed back to back (20 launches between two CUDA events, L2 warm)
in two rounds of alternating order, and each is given its device time
(chip_smoke.device_profile: torch.profiler, held against the back-to-back
time, with its split into memsets and kernels) and the host time of one
call (chip_smoke.host_ms).

Both run on chip_smoke.py's 50,000-gene transcriptome index at B = 65536,
L = 104.

K7a: this checkout's route.cu at four block and tile shapes, with its
send entries staged before the look-back rather than after it, or stored
by each window rather than staged by owner, with ballots rather than
__match_any_sync, with an integer division rather than a multiply and
shift, with ptxas held to 3 or 4 blocks an SM, and cut for timing (no look-back,
no peers, no send or no slot and owner stores: wrong results), with the
registers ptxas gave each, and each OTHER_CHECKOUT's route.cu that
differs (such as the parent's count, scan and scatter launches after two
memsets), on the windows of the index split into 8 shards on the card at
chip_smoke.py's cap.

K5: this checkout's classic.cu, each OTHER_CHECKOUT's that differs, and
that one with its pay load skipped on a miss (timing only: a miss then
gives payload 0); the committed kernel on the same windows permuted so
that each block's 256 are sorted by Bloom word (the locality a sort
within a block would buy, without the sort's cost; exact on the permuted
windows); beside the bare two-level gather of K5's own rows
(chip_smoke.classic_floor) and the committed owner probe (K7b) on the
slots the 8 shards receive from the same windows.
"""

import ctypes
import re
import sys

import numpy as np
import torch

import probe_variants as pv
from probe_variants import cs, tff
from shark_tpu_torch import kernels
from shark_tpu_torch.classify import step
from shark_tpu_torch.classify.step import Classifier
from shark_tpu_torch.io import native
from shark_tpu_torch.parallel import sharded_bf as sb

B, L = 65536, 104
ROUNDS = re.compile(r"constexpr int kRounds = \d+;")
THREADS = re.compile(r"constexpr int kRouteThreads = \d+;")
# the router's entry point before it took one scratch buffer
OLD_ROUTE = "void* counts, void* offs"
# the classic probe before a miss skipped its pay load
OLD_PAY = "const uint2 pw = pay[rank];"
SKIP_PAY = "const uint2 pw = hit ? pay[rank] : make_uint2(0u, 0u);"
_VP, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PEERS = "__match_any_sync(0xffffffffu, o)"
BOUNDS = "__launch_bounds__(kRouteThreads) route_kernel("
STAGE = ("      stage[group[o] + r] = make_uint2(local[k], (u32)(key[k] >> 11) "
         "& 31u);\n      stage_owner[group[o] + r] = (unsigned short)o;\n")
LOOK_BACK = "  // look-back: a warp per owner"
EARLY = """  __syncthreads();
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    if (p0 + k * 32 >= Pn) break;
    const int o = (key[k] & 0x7FF) - 1;
    if (o >= 0) {
      const int r = wc[o] + (key[k] >> 16);
""" + STAGE + """    }
  }
"""
STAGED_LOOP = "for (int j = threadIdx.x; j < routed; j += kRouteThreads) {"
# the warp's peers from one ballot a bit of the owner, as many as n + 1
# needs, not __match_any_sync
BALLOTS = """__device__ __forceinline__ unsigned peers_of(int key, int bits) {
  unsigned peers = 0xffffffffu;
  for (int b = 0; b < bits; ++b) {
    const bool on = (key >> b) & 1;
    const unsigned m = __ballot_sync(0xffffffffu, on);
    peers &= on ? m : ~m;
  }
  return peers;
}

"""
EDITS = {
    "ballots": (("// Shared memory of a K7a block", BALLOTS
                 + "// Shared memory of a K7a block"),
                (PEERS, "peers_of(o + 1, 32 - __clz(n))")),
    # exact: ptxas held to 64 or 80 registers (4 or 3 blocks an SM)
    "min4blocks": ((BOUNDS, BOUNDS.replace("(kRouteThreads)",
                                           "(kRouteThreads, 4)")),),
    "min3blocks": ((BOUNDS, BOUNDS.replace("(kRouteThreads)",
                                           "(kRouteThreads, 3)")),),
    # exact: the send entries staged before the look-back, not after it
    "early": ((STAGE, ""), (LOOK_BACK, EARLY + LOOK_BACK)),
    # exact: each window stores its own send entry after the look-back (a
    # warp's entries of one owner form a run), nothing staged
    "unstaged": ((STAGE, "      if (sl >= 0)\n        send[(s * n + o) * cap + "
                         "slot] = make_uint2(local[k], (u32)(key[k] >> 11) "
                         "& 31u);\n"),
                 (STAGED_LOOP, STAGED_LOOP.replace("j < routed", "j < 0"))),
    # exact: the narrow owner by an integer division, not multiply-shift
    "divide": (("(int)(((u64)word_lo * magic) >> shift)", "w / (int)wps"),),
    # timing only (wrong slots): no look-back, each tile taking its slots
    # from kTile / n per earlier tile; every tile's count published as its
    # inclusive prefix; each lane its own group of peers
    "nolookback": (("for (int top = c - 1;; top -= 32) {",
                    "for (int top = -1;; top -= 32) {"),
                   ("if (lane == 0) first[o] = (int)excl;",
                    "if (lane == 0) first[o] = (int)excl + c * (kTile / n);")),
    "quick": (("(c == 0 ? kFlagPrefix : kFlagCount)", "kFlagPrefix"),),
    "nopeers": ((PEERS, "(1u << lane)"),),
    # timing only (outputs left unwritten): no send stores; no slot and
    # owner stores
    "nosend": (("if (slot < cap) dst[o * cap + slot] = stage[j];",
                "if (slot == -7) dst[0] = stage[j];"),),
    "noslot": (("    slot_out[i0 + k * 32] = sl;",
                "    if (sl == -7) slot_out[i0] = sl;"),
               ("    owner_out[i0 + k * 32] = o;",
                "    if (o == -7) owner_out[i0] = o;")),
}
EXACT = ("ballots", "min4blocks", "min3blocks", "early", "unstaged",
         "divide")


def route_source(src, threads, rounds, edits=()):
    """route.cu with a K7a block of `threads` threads, each taking
    `rounds` windows (a tile of threads * rounds, at least 2048), and the
    text edits of EDITS."""
    assert THREADS.search(src) and ROUNDS.search(src)
    text = THREADS.sub(f"constexpr int kRouteThreads = {threads};", src)
    text = ROUNDS.sub(f"constexpr int kRounds = {rounds};", text)
    for a, b in edits:
        assert a in text, a
        text = text.replace(a, b)
    return text


def route_variants(others):
    """{name: (build waiter, takes the old counts and offs, exact)}: this
    checkout's K7a at 256 threads x 16 windows (as committed), 256 x 8,
    512 x 8 and 128 x 32, and at 256 x 16 with each of EDITS; each
    OTHER_CHECKOUT's route.cu that differs."""
    src, inc = pv.source(pv.OWN_ROOT, "route.cu")
    texts = {f"t{t}_r{r}": (route_source(src, t, r), inc, True)
             for t, r in ((256, 16), (256, 8), (512, 8), (128, 32))}
    for name, edits in EDITS.items():
        texts[name] = (route_source(src, 256, 16, edits), inc,
                       name in EXACT)
    for k, other in enumerate(others):
        text, oinc = pv.source(other, "route.cu")
        if text != src:
            texts[f"other{k}"] = (text, oinc, True)
    out = {}
    for name, (text, inc, exact) in texts.items():
        old = OLD_ROUTE in text
        argtypes = [_VP, _VP, _VP, _I, _L, _I, _L, _I, _L, _VP, *(
            [_VP] if old else []), _VP, _VP, _VP, _VP, _VP]
        out[name] = (kernels.build_variant(
            f"route_k7a_{name}", text, inc, "shkk_shard_route", argtypes,
            flags=("-Xptxas", "-v")), old, exact)
    return out


def say_registers(names):
    """The registers and spills ptxas gave each variant's route_kernel."""
    for name in names:
        log = kernels.VARIANT_LOGS.get(f"route_k7a_{name}", "").splitlines()
        for i, ln in enumerate(log):
            if "route_kernel" in ln and "Compiling" in ln:
                info = [x.split("ptxas info    : ")[-1].strip()
                        for x in log[i + 1:i + 4]
                        if "registers" in x or "spill" in x]
                print(f"  {name}: {'; '.join(info)}", flush=True)


def classic_variants(others):
    """{name: (build waiter, exact)} of K5's variants: this checkout's
    classic.cu, each OTHER_CHECKOUT's that differs, and that one with its
    miss's pay load skipped (timing only) where it has one."""
    src, inc = pv.source(pv.OWN_ROOT, "classic.cu")
    texts = {"committed": (src, inc, True)}
    for k, other in enumerate(others):
        text, oinc = pv.source(other, "classic.cu")
        if text == src:
            continue
        texts[f"other{k}"] = (text, oinc, True)
        if OLD_PAY in text:
            texts[f"other{k}_skip_pay"] = (text.replace(OLD_PAY, SKIP_PAY),
                                           oinc, False)
    argtypes = kernels._SIGNATURES["shkk_classic"]
    return {name: (kernels.build_variant(f"classic_{name}", text, inc,
                                         "shkk_classic", argtypes), exact)
            for name, (text, inc, exact) in texts.items()}


def route_caller(fn, old, n, wps, cap):
    """(hi, lo, valid) [S, b, Ls] -> (send, slot, owner, overflow)
    through one K7a variant; the one-pass variants get the scratch of the
    smallest tile (8 windows a thread), which covers each of them."""
    def call(hi, lo, valid):
        S, b, Ls = lo.shape
        Pn = b * Ls
        dev = lo.device
        if old:
            nchunks = -(-Pn // 256)
            scratch = torch.empty((2, S * n * nchunks), dtype=torch.int32,
                                  device=dev)
            bufs = (scratch[0].data_ptr(), scratch[1].data_ptr())
        else:
            tiles = -(-Pn // (256 * 8))
            scratch = torch.empty((8 + 8 * S * tiles * n,),
                                  dtype=torch.uint8, device=dev)
            bufs = (scratch.data_ptr(),)
        send = torch.empty((S, n, cap, 2), dtype=torch.uint32, device=dev)
        slot = torch.empty((S, b, Ls), dtype=torch.int32, device=dev)
        owner = torch.empty_like(slot)
        overflow = torch.empty((S,), dtype=torch.int32, device=dev)
        rc = fn(hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), S, Pn, n,
                wps, 0, cap, *bufs, send.data_ptr(), slot.data_ptr(),
                owner.data_ptr(), overflow.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return send, slot, owner, overflow
    return call


def classic_caller(fn, bf_rank, pay):
    def call(hi, lo, valid):
        tagv = torch.empty_like(lo)
        payv = torch.empty_like(lo)
        rc = fn(hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), lo.numel(),
                bf_rank.data_ptr(), pay.data_ptr(), tagv.data_ptr(),
                payv.data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return tagv, payv
    return call


def say_device(calls, bind):
    """Each variant's device time, its split and its host time."""
    for name, c in calls.items():
        p = cs.device_profile(bind(c))
        ops = {k: round(v, 4) for k, v in (p.get("device_ops") or {}).items()}
        flag = "  device_ms_suspect" if "device_ms_suspect" in p else ""
        dev = p["device_ms"]
        print(f"  {name}: device "
              f"{'not measured' if dev is None else f'{dev:.4f}'} "
              f"{ops}, host {p['host_ms'] * 1e3:.1f} us{flag}", flush=True)


def say_allocations(swins, n, wps, cap):
    """The host time of the committed wrapper (sb.shard_route) beside
    that of its five output and scratch allocations alone."""
    S, b, Ls = swins[1].shape
    dev = swins[1].device
    lib = kernels.lib()

    def allocations():
        torch.empty((lib.shkk_shard_route_scratch(S, b * Ls, n),),
                    dtype=torch.uint8, device=dev)
        torch.empty((S, n, cap, 2), dtype=torch.uint32, device=dev)
        torch.empty((S, b, Ls), dtype=torch.int32, device=dev)
        torch.empty((S, b, Ls), dtype=torch.int32, device=dev)
        torch.empty((S,), dtype=torch.int32, device=dev)

    def wrapper():
        return sb.shard_route(*swins, n=n, wps=wps, wide=False, cap=cap)
    print(f"  host us a call (200 calls): shard_route "
          f"{tff.host_us(wrapper, 200):.1f}, its allocations alone "
          f"{tff.host_us(allocations, 200):.1f}", flush=True)


def block_sorted(hi, lo, valid, block=256):
    """The windows permuted so that each run of `block` is sorted by its
    Bloom word (invalid windows last)."""
    h32, lo32 = hi.view(torch.int32), lo.view(torch.int32)
    h = h32.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    lo64 = lo32.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    word = torch.where(valid.reshape(-1), (h << 27) | (lo64 >> 5), 1 << 40)
    pos = torch.arange(word.numel(), device=word.device)
    order = torch.sort((pos // block) * (1 << 41) + word).indices
    return [t.reshape(-1)[order].reshape(t.shape).view(dt) for t, dt in (
        (h32, torch.uint32), (lo32, torch.uint32), (valid, torch.bool))]


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this script times kernels on the card",
              file=sys.stderr)
        return 1
    native.rebuild()  # a library built on another host may not load here
    kernels.build(force=True)
    others = sys.argv[1:]
    routes = route_variants(others)  # every nvcc started here
    classics = classic_variants(others)
    genes, xclf = tff.txome_xl(cs)
    wins = tff.xl_windows(cs, xclf, genes, np.random.default_rng(2028), B, L)
    gathers = cs.Gathers()
    print(f"{torch.cuda.get_device_name(0)}; B={B} L={L}, "
          f"{wins[1].numel()} windows, {int(wins[2].sum())} valid",
          flush=True)

    # K7a --------------------------------------------------------------
    n = cs.SHARDS
    dev = torch.device("cuda", 0)
    sclf = sb.ShardedBFClassifier(xclf.index, max_winners=16, c=cs.C,
                                  devices=[dev] * n)
    wps, cap = sclf.wps, sclf._probe_cap(B // n, L)
    swins = [t.reshape(n, B // n, -1) for t in wins]
    want = sb.shard_route_plain(*swins, n=n, wps=wps, wide=False, cap=cap)
    calls = {name: route_caller(fn(), old, n, wps, cap)
             for name, (fn, old, _) in routes.items()}
    say_registers(calls)
    for name, call in calls.items():
        if routes[name][2]:
            cs.same(f"shard_route variant {name}", call(*swins), want)
    print(f"router: {n} shards, cap {cap}, overflow "
          f"{[int(x) for x in want[3].cpu()]}; variants exact but "
          f"{[k for k, v in routes.items() if not v[2]]} (timing only); "
          f"back-to-back ms (L2 warm):", flush=True)
    pv.say_runs(pv.alternate(calls, {"8 shards": lambda c: lambda: c(
        *swins)}))
    say_device(calls, lambda c: lambda: c(*swins))
    say_allocations(swins, n, wps, cap)
    recv = cs._transposed(want[0])
    tables = sclf.dix[dev]

    def k7b():
        return sb.shard_probe(recv, tables.bf_rank, tables.pay)
    del sclf, want

    # K5 ---------------------------------------------------------------
    cclf = Classifier(xclf.index, max_winners=16, c=cs.C, probe="classic")
    bf_rank, pay = cclf.dix.bf_rank, cclf.dix.pay
    swapped = block_sorted(*wins)
    calls = {name: classic_caller(fn(), bf_rank, pay)
             for name, (fn, _) in classics.items()}
    exact = {name: ok for name, (_, ok) in classics.items()}
    plain = step.probe_tags_plain(*wins, bf_rank, pay)
    for name, call in calls.items():
        if exact[name]:
            cs.same(f"probe_tags variant {name}", call(*wins), plain)
    cs.same("probe_tags on block-sorted windows",
            step.probe_tags(*swapped, bf_rank, pay),
            step.probe_tags_plain(*swapped, bf_rank, pay))
    print(f"classic probe: variants exact but "
          f"{[k for k, v in exact.items() if not v]} (timing only); "
          f"back-to-back ms (L2 warm):", flush=True)
    pv.say_runs(pv.alternate(calls, {"windows": lambda c: lambda: c(*wins)}))
    say_device(calls, lambda c: lambda: c(*wins))
    fl = cs.classic_floor((*wins, bf_rank, pay), gathers)
    print(f"  floors (event ms, device ms, back-to-back ms): committed on "
          f"block-sorted windows "
          f"{cs.timings(lambda: step.probe_tags(*swapped, bf_rank, pay))}, "
          f"{fl}, owner probe on the 8 shards' slots {cs.timings(k7b)}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
