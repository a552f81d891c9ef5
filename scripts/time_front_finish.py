#!/usr/bin/env python3
"""Time the front end (K1) and the finish (K3) of shark_tpu_torch on one
CUDA card, kernel by kernel.

    python3 scripts/time_front_finish.py [CHECKOUT]

CHECKOUT is the root of the checkout whose kernels are timed (default: the
one holding this script), so that two commits can be held side by side in
one run on one card. On the homolog panel's index of chip_smoke.py (k 17,
2^33 Bloom bits), at B x L in {8192 x 104, 65536 x 104, 65536 x 208},
each kernel is first checked against its plain version, then printed:
its CUDA-event time as chip_smoke.py takes it (median of 7, L2 flushed),
the host time of one wrapper call (50 calls without a synchronisation),
and the device time of each kernel and memset the wrapper launches
(torch.profiler, L2 warm, mean of 7 calls).
"""

import functools
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from shark_tpu_torch import kernels  # noqa: E402
from shark_tpu_torch.classify import hashed, step  # noqa: E402
from shark_tpu_torch.classify.step import Classifier  # noqa: E402
from shark_tpu_torch.index.build import build_index  # noqa: E402
from shark_tpu_torch.utils.timers import cuda_ms  # noqa: E402

SHAPES = [(8192, 104), (65536, 104), (65536, 208)]
REPS = 7


def device_breakdown(fn):
    """{kernel name: device ms of one call}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0:
            out[e.key.split("(")[0].replace("(anonymous namespace)::", "")
                or e.key] = round(us / REPS / 1e3, 4)
    return out


def host_us(fn, n=50):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this script times the kernels on the card",
              file=sys.stderr)
        return 1
    kernels.build(force=True)
    kernels.lib()
    genes = cs.homolog_genes(np.random.default_rng(7))
    index = build_index([(f"H{g:05d}", s.tobytes())
                         for g, s in enumerate(genes)], cs.K, cs.BF_GB << 33)
    clf = Classifier(index, max_winners=16, c=cs.C)
    timer = functools.partial(cuda_ms, reps=REPS)
    rng = np.random.default_rng(2024)
    print(f"{ROOT}: {torch.cuda.get_device_name(0)}")
    for B, L in SHAPES:
        meta, thresh = clf._geometry(L)
        codes = torch.from_numpy(cs.codes_for_shape(rng, genes, B, L)).cuda()
        packed, vmask = step.pack_codes(codes)
        front = functools.partial(step.front_end, packed, vmask, meta)
        k1 = front()
        cs.same("front_end", k1, step.front_end_plain(packed, vmask, meta))
        hi, lo, valid, length = k1
        tagv, payv = hashed.probe_hashed(hi, lo, valid, clf.dix.table,
                                         clf.dix.stash, clf._hmeta)
        kw = dict(rows3=clf.dix.rows3, ext_mat=clf.dix.ext_mat, meta=meta,
                  max_winners=16, L=L, has_rows=clf._hmeta.has_rows)
        finish = functools.partial(step.finish_from_tags, tagv, payv, length,
                                   thresh, **kw)
        cs.same("finish_from_tags", finish()[:3],
                step.finish_from_tags_plain(tagv, payv, length, thresh,
                                            **kw)[:3])
        for name, fn in (("front", front), ("finish", finish)):
            print(f"B={B} L={L} {name}: event_ms={timer(fn):.4f} "
                  f"host_us={host_us(fn):.1f} device_ms={device_breakdown(fn)}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
