"""The least time each stage of the classify step needs on one H100, from
the batch's shapes, keyed by algorithm stage and not by kernel: a change
that fuses, splits or renames kernels is held to the same work.

A stage's least time is the larger of its bytes over the card's HBM rate
and its integer operations over the card's INT32 rate. Each input byte is
read once and each output byte written once; bytes that pass from one
stage to the next through memory are not counted, since the algorithm does
not need them. The operation counts per probe window are those the port's
kernel bounds were held to (chip_smoke.py's front end, probes, finish and
pair stream).
"""

from __future__ import annotations

import math
from typing import Optional

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3. Integer work: 132 SMs x
# 64 INT32 lanes x 1.98 GHz boost clock.
PEAK_BYTES_S = 3.35e12
PEAK_INT_OPS_S = 132 * 64 * 1.98e9

# a probe window's row of the layout's table, and its operations
ROW_BYTES = {"hashed": 32, "xl": 16, "classic": 16}
PROBE_OPS = {"hashed": 4 * 8 + 10, "xl": 4 * 4 + 10, "classic": 12}
FRONT_OPS = 50  # 2-bit decode, rolling k-mer and its reverse, XXH64, modulo
FINISH_OPS = 10  # a probe's tag and gene folded into the read's best
PAIR_OPS = 3  # a winner slot's test and write


def least_s(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_INT_OPS_S)


def front(batch: int, read_len: int, windows: int) -> float:
    """Planar 2-bit bases and the validity mask in; addresses go on."""
    return least_s(batch * read_len * 3 / 8, FRONT_OPS * windows)


def probe(layout: str, windows: int, table_rows: Optional[int]) -> float:
    """Each distinct table row the windows touch read once: for a hashed
    table of `table_rows` rows, the expected count of distinct rows under
    uniform addresses; else one a window."""
    rows = (table_rows * -math.expm1(-windows / table_rows)
            if table_rows else windows)
    return least_s(rows * ROW_BYTES[layout], PROBE_OPS[layout] * windows)


def finish(batch: int, windows: int, max_winners: int) -> float:
    """The packed verdict (8 bytes) and the winner list out."""
    return least_s(batch * (8 + 4 * max_winners), FINISH_OPS * windows)


def pairs(batch: int, max_winners: int) -> float:
    """The verdicts' counts in; every winner slot tested."""
    return least_s(batch * 4, PAIR_OPS * batch * max_winners)


def batch(layout: str, batch_size: int, read_len: int, windows: int,
          table_rows: Optional[int], max_winners: int) -> float:
    """Front end, probe and finish of one batch with `windows` valid
    probe windows."""
    return (front(batch_size, read_len, windows)
            + probe(layout, windows, table_rows)
            + finish(batch_size, windows, max_winners))
