#!/usr/bin/env python3
"""Time variants of the xl probe kernel (shark_tpu_torch/csrc/xl.cu)
against each other on one CUDA card, in one process, on one allocation of
the same table and the same windows.

    python3 scripts/xl_variants.py [OTHER_CHECKOUT]

Each variant is this checkout's csrc/xl.cu with its window group set to
1, 2 or 4 windows a thread (kWin) and its bucket loads plain (ld.global,
as committed) or through the read-only path without L1 allocation
(ld.global.nc.L1::no_allocate); OTHER_CHECKOUT's csrc/xl.cu (another
commit, such as the parent) is built as one more variant. Each is built by
nvcc into a library of its own under build/xl_variants/ and called
through its C entry point.
On chip_smoke.py's transcriptome index at B = 65536, L = 104, every
variant is first held to the plain version (exact), then timed back to
back (20 launches between two CUDA events, L2 warm) on the whole table and
with every bucket masked into the table's first 256 MB and 32 MB (those
two give wrong results: timing only), in two rounds of alternating order,
beside the bare 16-byte gather at the same buckets.
"""

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

OWN_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, OWN_ROOT)

import chip_smoke as cs  # noqa: E402
import time_front_finish as tff  # noqa: E402
from shark_tpu_torch import kernels  # noqa: E402
from shark_tpu_torch.classify import hashed  # noqa: E402
from shark_tpu_torch.io import native  # noqa: E402

timers = cs.own_timers()

B, L = 65536, 104
LOAD = "ld.global.v4.u32"
LOAD_NC = "ld.global.nc.L1::no_allocate.v4.u32"


def variant_sources(other):
    """{name: (xl.cu text, include dir)}."""
    own = os.path.join(kernels.CSRC, "xl.cu")
    with open(own) as f:
        src = f.read()
    assert re.search(r"constexpr int kWin = \d+;", src) and LOAD in src
    out = {}
    for win in (4, 2, 1):
        for load in ("nc", "plain"):
            text = re.sub(r"constexpr int kWin = \d+;",
                          f"constexpr int kWin = {win};", src)
            if load == "nc":
                text = text.replace(LOAD, LOAD_NC)
            out[f"w{win}_{load}"] = (text, kernels.CSRC)
    if other:
        ocsrc = os.path.join(os.path.abspath(other), "shark_tpu_torch", "csrc")
        with open(os.path.join(ocsrc, "xl.cu")) as f:
            out["other"] = (f.read(), ocsrc)
    return out


def build_variants(sources):
    """nvcc every variant at once; {name: shkk_probe_xl of its library}."""
    root = os.path.join(OWN_ROOT, "build", "xl_variants")
    procs = {}
    for name, (text, inc) in sources.items():
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        src, so = os.path.join(d, "xl.cu"), os.path.join(d, "libxl.so")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-shared", "-I", inc,
             "-o", so, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}\n{log}")
        fn = ctypes.CDLL(so).shkk_probe_xl
        fn.argtypes = kernels._SIGNATURES["shkk_probe_xl"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def caller(fn, dix, hmeta):
    """(idx_hi, idx_lo, win_valid) -> (tagv, payv) through one variant,
    with the wrapper's output layout."""
    def call(hi, lo, valid):
        n = lo.numel()
        n4 = (n + 3) & ~3
        out = torch.empty((n4 + n,), dtype=torch.uint32, device=lo.device)
        tagv, payv = out[:n].view(lo.shape), out[n4:].view(lo.shape)
        rc = fn(hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), n,
                dix.table.data_ptr(), hmeta.lgB, dix.side.data_ptr(),
                hmeta.side_lgB, int(hmeta.has_side),
                dix.side_stash.data_ptr(), dix.side_stash.shape[0],
                tagv.data_ptr(), payv.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return tagv, payv
    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this script times kernels on the card",
              file=sys.stderr)
        return 1
    native.rebuild()  # a library built on another host may not load here
    fns = build_variants(variant_sources(sys.argv[1] if len(sys.argv) > 1
                                         else None))
    gathers = cs.Gathers()
    genes, xclf = tff.txome_xl(cs)
    dix, hmeta = xclf.dix, xclf._hmeta
    hi, lo, valid = tff.xl_windows(cs, xclf, genes,
                                   np.random.default_rng(2025), B, L)
    want = hashed.probe_xl_plain(hi, lo, valid, dix.table, dix.side,
                                 dix.side_stash, hmeta)
    calls = {name: caller(fn, dix, hmeta) for name, fn in fns.items()}
    for name, call in calls.items():
        cs.same(f"probe_xl variant {name}", call(hi, lo, valid), want)
    bmask = (1 << hmeta.lgB) - 1
    lo64 = lo.to(torch.int64)
    footprints = {"full": lo}
    for tag, rows_log2 in (("256MB", 24), ("32MB", 21)):
        keep = min((1 << rows_log2) - 1, bmask)
        footprints[tag] = ((lo64 & ~bmask) | (lo64 & keep)).to(torch.uint32)
    bidx = (lo64 & bmask)[valid].to(torch.int32)
    print(f"{torch.cuda.get_device_name(0)}; B={B} L={L}, "
          f"{lo.numel()} windows, {bidx.numel()} valid; all variants exact; "
          f"back-to-back ms (L2 warm):", flush=True)
    names = list(calls)
    for tag, m in footprints.items():
        times = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                times[name].append(timers.back_to_back_ms(
                    lambda c=calls[name]: c(hi, m, valid)))
        print(f"  {tag:>5}: " + "  ".join(
            f"{name} {min(t):.4f}/{max(t):.4f}" for name, t in times.items()),
            flush=True)
    g16 = timers.back_to_back_ms(lambda: gathers.rows(dix.table, bidx, 16))
    print(f"  gather16 (whole table): {g16:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
