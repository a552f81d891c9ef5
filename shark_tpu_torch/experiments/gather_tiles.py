"""P1 on the card: the per-probe 512-byte tile gather.

The counterpart of bench/pallas_probe.py. The table holds rows of two
u32 (8 bytes), shaped [rows / 64, 128] so that each row lies in a
512-byte tile; a probe gathers the whole tile of its row, and the two
lanes (idx & 63) * 2 and + 1 of that tile are the row. The harness
measures the rate of random 512-byte gathers from a table far past the
L2 (1 GiB at its defaults), beside the library's row gather table[idx].

Run:  python -m shark_tpu_torch.experiments.gather_tiles [n_log2] [rows_log2]
          [--cpu]

n_log2 (default 20) sets 2^n probes, rows_log2 (default 27) 2^rows rows
of 8 bytes. It runs on the CUDA card and raises without one unless --cpu
is given, which runs the plain version and stops after the check.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from shark_tpu_torch import kernels
from shark_tpu_torch.classify.step import resolve_device
from shark_tpu_torch.utils.timers import cuda_ms

CHUNK = 1024  # the probe count is a multiple of this (the Pallas grid step)
TILE = 128  # u32 lanes of a tile: 64 rows of 2


def _check(table_tiles: torch.Tensor, idx: torch.Tensor) -> None:
    if table_tiles.dim() != 2 or table_tiles.shape[1] != TILE:
        raise ValueError(f"table_tiles shape {tuple(table_tiles.shape)}, "
                         f"expected [rows / 64, {TILE}]")
    if idx.dim() != 1 or idx.shape[0] % CHUNK:
        raise ValueError(f"idx shape {tuple(idx.shape)}: one dimension, a "
                         f"multiple of {CHUNK} long")


def gather_tiles_plain(table_tiles: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """Plain version of P1: table_tiles[idx >> 6], the shift in int64,
    the gather on the int32 view of the u32 table."""
    tile = idx.to(torch.int64) >> 6
    return table_tiles.view(torch.int32)[tile].view(torch.uint32)


def gather_tiles(table_tiles: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P1: out[j] = table_tiles[idx[j] >> 6] (u32 [n, 128]) for u32
    table_tiles [rows / 64, 128] and i32 idx [n] in [0, rows), n a
    multiple of CHUNK. CUDA tensors run csrc/gather_tiles.cu; CPU tensors
    the plain version."""
    _check(table_tiles, idx)
    if not idx.is_cuda:
        return gather_tiles_plain(table_tiles, idx)
    dev = idx.device
    kernels.require(table_tiles, "table_tiles", torch.uint32, 2, dev)
    kernels.require(idx, "idx", torch.int32, 1, dev)
    n = idx.shape[0]
    out = torch.empty((n, TILE), dtype=torch.uint32, device=dev)
    rc = kernels.lib().shkk_gather_tiles(
        table_tiles.data_ptr(), idx.data_ptr(), n, out.data_ptr(),
        kernels.stream(dev))
    kernels.check(rc, "gather_tiles")
    kernels.LAUNCHES.add("gather_tiles")
    return out


def rows_of_tiles(tiles: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The probed rows (u32 [n, 2]) taken out of their tiles: lanes
    (idx & 63) * 2 and + 1."""
    within = (idx.to(torch.int64) & 63) * 2
    t = tiles.view(torch.int32)
    j = torch.arange(idx.shape[0], device=idx.device)
    return torch.stack([t[j, within], t[j, within + 1]], 1).view(torch.uint32)


def make_inputs(n_log2: int, rows_log2: int, seed: int = 0):
    """The harness's arrays (bench/pallas_probe.py:101-107) as numpy:
    table u32 [rows, 2], table_tiles u32 [rows / 64, 128] (a view of
    table) and idx i32 [2^n_log2] in [0, rows)."""
    rows = 1 << rows_log2
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 1 << 32, size=(rows, 2), dtype=np.uint64
                         ).astype(np.uint32)
    idx = rng.integers(0, rows, size=1 << n_log2, dtype=np.int64
                       ).astype(np.int32)
    return table, table.reshape(rows // 64, TILE), idx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_log2", nargs="?", type=int, default=20)
    ap.add_argument("rows_log2", nargs="?", type=int, default=27)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain version and stop after the check")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    table_h, _, idx_h = make_inputs(args.n_log2, args.rows_log2)
    n = idx_h.shape[0]
    table = torch.from_numpy(table_h).to(dev)
    tiles = table.view(-1, TILE)
    idx = torch.from_numpy(idx_h).to(dev)
    table32 = table.view(torch.int32)

    # the tiles and the rows taken out of them against table[idx], on a
    # prefix (bench/pallas_probe.py:115-126)
    nv = min(n, CHUNK * 8)
    got = gather_tiles(tiles, idx[:nv])
    want_tiles = gather_tiles_plain(tiles, idx[:nv])
    want_rows = table32[idx[:nv].to(torch.int64)].view(torch.uint32)
    if not (torch.equal(got.cpu(), want_tiles.cpu())
            and torch.equal(rows_of_tiles(got, idx[:nv]).cpu(),
                            want_rows.cpu())):
        raise RuntimeError("gather_tiles differs from table[idx]")
    print(f"gather_tiles matches table[idx] on {nv} probes "
          f"({dev.type})", flush=True)
    if args.cpu:
        return 0

    idx64 = idx.to(torch.int64)
    for name, fn in (("table[idx]", lambda: table32[idx64]),
                     ("gather_tiles", lambda: gather_tiles(tiles, idx))):
        ms = cuda_ms(fn)
        print(f"{name}: {ms:9.4f} ms  {n / ms / 1e3:8.1f} M rows/s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
