"""kernels.roofline_pct: the least time the classify step's stages need
for the batches of the profiled passes (portbench/stage_counts.py: front
end, probe of the layout's rows, finish, and the pair stream where it
launched), over the summed time of every kernel the trace records in that
stretch. Each pass runs the sample's batches and one warm-up batch of
invalid windows. Nothing without kernels in the trace, or for a layout
the counts do not know."""

import math
import sys

import torch

from portbench import stage_counts
from portbench.reference import shark as ref


def windows_per_read(ctx):
    """Valid probe windows of each fused read of the sample."""
    k = ctx.cell.shark_params()["k"]
    out = []
    block = 1 << 17
    for first in range(0, len(ctx.sample), block):
        rows = slice(first, min(first + block, len(ctx.sample)))
        codes = torch.from_numpy(ctx.sample.codes(rows)).to(ctx.device)
        out.append(ref.kmers(codes, k)[1].sum(1).cpu())
    return torch.cat(out).tolist()


def read(ctx):
    t, layout = ctx.trace, ctx.setup.get("layout")
    if not t or t["kernel_s"] <= 0 or layout not in stage_counts.ROW_BYTES:
        return None
    cfg = ctx.cfg
    B, L, W = cfg.batch_size, ctx.read_len, cfg.max_winners
    rows = ctx.setup.get("table_rows")
    per_read = windows_per_read(ctx)
    n = len(per_read)
    per_pass = stage_counts.batch(layout, B, L, 0, rows, W)  # warm-up batch
    for first in range(0, n, B):
        per_pass += stage_counts.batch(layout, B, L,
                                       sum(per_read[first:first + B]), rows, W)
    passes = sum(p.get("profiled", False) for p in ctx.window_passes)
    least = passes * per_pass + (ctx.launches or {}).get("pairs", 0) * (
        stage_counts.pairs(B, W))
    want = passes * (math.ceil(n / B) + 1)
    got = (ctx.launches or {}).get("front", want)
    if got != want:
        print(f"[portbench] kernels.roofline_pct: {got} front-end launches "
              f"in the profiled passes, {want} batches counted",
              file=sys.stderr)
    return 100.0 * least / t["kernel_s"]
