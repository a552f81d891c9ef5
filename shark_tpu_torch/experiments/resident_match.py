"""P2 on the card: the entry16 bucket match against a table held on chip.

The counterpart of bench/pallas_vmem_match.py. The entry16 hashed table
(u32 [2^lgB, 8]: 8 slots of meta16 << 16 | pay16 per bucket, meta16 =
tag << 14 | 14-bit key) is reshaped to table128 [2^lgB / 16, 128], 16
buckets per 512-byte row. A probe carries rows = bucket >> 4 and want =
key | (bucket & 15) << 14, or 0xFFFFFFFF when it is invalid; it returns
(tv, p0 | p1 << 16): the largest tag over matching slots, the pay of the
first and the sum of the pays of the later ones. At lgB = 19 the table
is 16 MB, which fits in the card's 50 MB L2: the harness measures the
match rate from a table resident there, beside the production form
(gather the bucket, then match: match_gather).

Run:  python -m shark_tpu_torch.experiments.resident_match [--cpu]

It runs one production batch (65536 reads x 88 windows = 5,767,168
probes) on the CUDA card and raises without one unless --cpu is given,
which runs the plain version on 2048 x 8 probes and stops after the
check.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from shark_tpu_torch import kernels
from shark_tpu_torch.classify.step import gather_u32, resolve_device
from shark_tpu_torch.utils.timers import cuda_ms

CHUNK = 2048  # the probe count is a multiple of this (the Pallas grid step)
LGB = 19  # 2^19 buckets: a 16 MB table, the production single-end geometry
N_BATCH = CHUNK * 2816  # one production batch, 65536 * 88 probes
N_CPU = CHUNK * 8
INVALID = 0xFFFFFFFF


def _check(rows, want, table128) -> None:
    if table128.dim() != 2 or table128.shape[1] != 128:
        raise ValueError(f"table128 shape {tuple(table128.shape)}, "
                         "expected [2^lgB / 16, 128]")
    if rows.dim() != 1 or rows.shape != want.shape or rows.shape[0] % CHUNK:
        raise ValueError(f"rows {tuple(rows.shape)} and want "
                         f"{tuple(want.shape)}: one dimension, equal, a "
                         f"multiple of {CHUNK} long")


def _match(slots: torch.Tensor, key: torch.Tensor, ok: torch.Tensor):
    """The 8-slot match of int64 slots [n, 8] against int64 keys [n]
    where ok [n]: (tv, p0 | p1 << 16) as u32 [n, 2]."""
    meta = slots >> 16
    pay = slots & 0xFFFF
    tag = meta >> 14
    m = ((meta & 0x3FFF) == key[:, None]) & (tag != 0) & ok[:, None]
    slot = torch.arange(8, device=slots.device)
    fs = torch.where(m, slot, 8).amin(1, keepdim=True)
    zero = torch.zeros_like(pay)
    p0 = torch.where(m & (slot == fs), pay, zero).sum(1)
    p1 = torch.where(m & (slot > fs), pay, zero).sum(1)
    tv = torch.where(m, tag, zero).amax(1)
    return torch.stack([tv, (p0 | (p1 << 16)) & 0xFFFFFFFF], 1).to(
        torch.uint32)


def resident_match_plain(rows, want, table128):
    """Plain version of P2, in int64: bucket g = (want >> 14) & 15 of row
    rows[j]; a want >= 2^18 (the invalid sentinel) matches nothing, as
    the Pallas kernel's 18-bit compare never equals it."""
    w = want.to(torch.int64)
    bucket = rows.to(torch.int64) * 16 + ((w >> 14) & 15)
    slots = gather_u32(table128.view(-1, 8), bucket)
    return _match(slots, w & 0x3FFF, w < (1 << 18))


def resident_match(rows: torch.Tensor, want: torch.Tensor,
                   table128: torch.Tensor) -> torch.Tensor:
    """P2: (tv, p0 | p1 << 16) as u32 [n, 2] for i32 rows [n] (bucket >>
    4), u32 want [n] and u32 table128 [2^lgB / 16, 128], n a multiple of
    CHUNK. CUDA tensors run csrc/resident_match.cu; CPU tensors the plain
    version."""
    _check(rows, want, table128)
    if not rows.is_cuda:
        return resident_match_plain(rows, want, table128)
    dev = rows.device
    kernels.require(rows, "rows", torch.int32, 1, dev)
    kernels.require(want, "want", torch.uint32, 1, dev)
    kernels.require(table128, "table128", torch.uint32, 2, dev)
    n = rows.shape[0]
    out = torch.empty((n, 2), dtype=torch.uint32, device=dev)
    rc = kernels.lib().shkk_resident_match(
        rows.data_ptr(), want.data_ptr(), table128.data_ptr(), n,
        out.data_ptr(), kernels.stream(dev))
    kernels.check(rc, "resident_match")
    kernels.LAUNCHES.add("resident_match")
    return out


def match_gather(table, bucket, rest, valid):
    """The production form (bench/pallas_vmem_match.py xla_match, the
    entry16 branch of the hashed probe): gather u32 table [2^lgB, 8] at
    bucket, then match rest where valid."""
    slots = gather_u32(table, bucket.to(torch.int64))
    return _match(slots, rest.to(torch.int64), valid)


def build_inputs(n: int, lgB: int, seed: int = 0):
    """The harness's table and probes (bench/pallas_vmem_match.py:139-162)
    as numpy: table u32 [2^lgB, 8], bucket i32 [n], rest u32 [n] (14
    bits), valid bool [n]. About half the probes get a planted match, a
    quarter of those a second one in the next slot."""
    rng = np.random.default_rng(seed)
    n_buckets = 1 << lgB
    table = rng.integers(0, 1 << 32, size=(n_buckets, 8), dtype=np.uint64)
    table = table.astype(np.uint32)
    bucket = rng.integers(0, n_buckets, size=n, dtype=np.int64).astype(
        np.int32)
    rest = rng.integers(0, 1 << 14, size=n, dtype=np.int64).astype(np.uint32)
    valid = rng.random(n) < 0.97
    hit = np.flatnonzero(rng.random(n) < 0.5)
    s = rng.integers(0, 7, size=hit.size)
    t = rng.integers(1, 4, size=hit.size).astype(np.uint32)
    meta16 = ((t << 14) | rest[hit]).astype(np.uint32) << 16
    table[bucket[hit], s] = meta16 | rng.integers(
        0, 1 << 16, size=hit.size).astype(np.uint32)
    dbl = rng.random(hit.size) < 0.25
    table[bucket[hit[dbl]], s[dbl] + 1] = meta16[dbl] | rng.integers(
        0, 1 << 16, size=int(dbl.sum())).astype(np.uint32)
    return table, bucket, rest, valid


def probe_inputs(table, bucket, rest, valid):
    """The kernel's operands (bench/pallas_vmem_match.py:169-173) as
    numpy: rows i32 [n], want u32 [n], table128 (a view of table)."""
    rows = (bucket >> 4).astype(np.int32)
    want = np.where(valid, rest | ((bucket.astype(np.uint32) & 15) << 14),
                    INVALID).astype(np.uint32)
    return rows, want, table.reshape(-1, 128)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain version on 2048 x 8 probes and "
                         "stop after the check")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    n = N_CPU if args.cpu else N_BATCH
    host = build_inputs(n, LGB)
    table, bucket, rest, valid = (torch.from_numpy(a).to(dev) for a in host)
    rows, want, table128 = (torch.from_numpy(a).to(dev)
                            for a in probe_inputs(*host))

    ref = match_gather(table, bucket, rest, valid)
    got = resident_match(rows, want, table128)
    if not torch.equal(got.cpu(), ref.cpu()):
        raise RuntimeError("resident_match differs from gather+match")
    hit = (ref[:, 0].view(torch.int32) != 0).double().mean().item()
    print(f"resident match == gather+match on {n} probes ({hit:.2f} hit "
          f"rate, {dev.type})", flush=True)
    if args.cpu:
        return 0

    for name, fn, flush in (
        ("gather+match", lambda: match_gather(table, bucket, rest, valid),
         True),
        ("resident match, L2 flushed",
         lambda: resident_match(rows, want, table128), True),
        ("resident match, L2 warm",
         lambda: resident_match(rows, want, table128), False),
    ):
        ms = cuda_ms(fn, flush=flush)
        print(f"{name}: {ms:9.4f} ms  {n / ms / 1e3:8.1f} M probes/s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
