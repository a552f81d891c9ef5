"""Hashed-probe-table classify path: ONE bucket load per window.

PyTorch counterpart of shark_tpu/classify/hashed.py, the probe of the main
path for gene panels. The table is keyed directly on the BLOOM POSITION
p = XXH64(kmer) % size (reference semantics: bloomfilter.h:88). Exactness
is preserved by construction: the table stores p itself (split as bucket =
low bits, rest = remaining bits), so membership answers are identical to
the bit-vector's — including reference hash-collision behavior, since
colliding k-mers share p and therefore share the entry.

  bucket b = p & (n_buckets - 1)
  row      = table[b]
  entry    = (meta = tag<<tag_shift | p>>lgB,  payload)
             entry16: when p>>lgB fits 14 bits, 4-byte entries, one per
             u32 word (meta16 << 16 | payload16; degree-2 and row entries
             span two adjacent words), a [n_buckets, 8] u32 table.
             entry8: otherwise 8-byte entries (tag<<30 | rest, 32-bit
             payload) stored planar, [n_buckets, 2, 8].
             tag 0 empty; 1 = one gene; 2 = TWO genes (payload g0|g1<<16);
             3 = payload = index into the compacted deg>=3 row table

Entries that overflow a bucket's 8 slots go to a small stash compared
against every probe. The table builders are numpy copies of shark_tpu's,
so both packages build identical tables.

Past the table budget (transcriptome scale) the xl layout (build_hashed_xl)
keeps one bucket load per window: [n_buckets, 4] u32 buckets of entry16
words with a 13-bit rest, bit 13 of slot 0's meta16 flagging a bucket that
overflowed, and the overflowed entries in a small entry8 SIDE table (with
its own stash), read only by windows of a flagged bucket that matched
nothing in it. The xl layout has no main stash.

K2, the probe (probe_hashed), runs csrc/probe.cu on a CUDA tensor and its
plain PyTorch version on a CPU tensor; K6, the xl probe with its side
resolve (probe_xl), runs csrc/xl.cu or its plain version likewise.
step.Classifier composes K1 -> K2 or K6 -> K3.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from shark_tpu_torch import kernels
from shark_tpu_torch.classify.step import (
    TAG_D1,
    TAG_D2,
    TAG_ROW,
    gather_u32,
    pack_rows_u32,
    require_windows,
    to_device,
)
from shark_tpu_torch.index.structure import SharkIndex

BUCKET_SLOTS = 8
STASH_CAP = 256
SMALL_STASH = 64  # cap when shrinking below the natural bucket count
STASH_MIN = 32
# shark_tpu's table budget (a TPU gather-rate cliff); kept for bit parity
MAX_TABLE_BYTES = 64 << 20
MAX_BUCKETS = MAX_TABLE_BYTES // (8 * BUCKET_SLOTS)

# The GB-scale "xl" layout: 16-byte buckets of XL_SLOTS entry16 words with
# a 13-bit rest; bit XL_FLAG_BIT of slot 0's word flags an overflowed
# bucket, whose spills live in the side table (at most XL_SIDE_STASH_CAP
# side-stash rows). XL_SIDE_CAP is shark_tpu's per-read compaction width
# of the side lookup, a cost switch that changes no result; it stays for
# the probe-table cache key.
XL_SLOTS = 4
XL_REST_BITS = 13
XL_FLAG_BIT = 29
XL_SIDE_CAP = 8
XL_SIDE_STASH_CAP = 128
XL_MAX_LGB = 30


class HashedDeviceIndex(NamedTuple):
    # entry16: uint32[n_buckets, slots] (meta16<<16 | pay16 per word);
    # entry8:  uint32[n_buckets, 2, BUCKET_SLOTS] (w0 plane, w1 plane);
    # xl:      uint32[n_buckets, XL_SLOTS] (entry16 words, 13-bit rest,
    #          flag bit; spills resolve through `side`/`side_stash`)
    table: torch.Tensor
    stash: torch.Tensor  # uint32[S, 4]: pos_lo, pos_hi, tag, payload
    rows3: torch.Tensor  # uint32[max(n_deg3,1), ceil((D3+1)/2)] packed rows
    ext_mat: Optional[torch.Tensor] = None  # uint16[n_ovf, ext3_w]
    side: Optional[torch.Tensor] = None  # xl: uint32[2^side_lgB, 2, 8]
    side_stash: Optional[torch.Tensor] = None  # xl: uint32[S2, 4]
    # stash rows before its trailing padding rows (stash_rows_before_pad)
    stash_rows: Optional[int] = None


@dataclass(frozen=True)
class HashedMeta:
    lgB: int  # log2(n_buckets)
    has_rows: bool  # any degree >= 3 entry exists
    entry16: bool = False  # 4-byte entries (one u32 word each) vs 8-byte
    slots: int = BUCKET_SLOTS  # entry slots per bucket (entry16: 4 or 8)
    xl: bool = False  # GB-scale 16-byte-row layout with a side table
    side_lgB: int = 0  # log2 bucket count of the xl side table
    has_side: bool = False  # any xl spill exists


def _set_bit_positions(
    index: SharkIndex, threads: Optional[int] = None
) -> np.ndarray:
    """Ascending positions of set Bloom bits (uint64), aligned with CSR
    rank order.

    The native parallel scan does this at memory bandwidth; the numpy
    fallback is a chunked little-endian unpackbits, an order of magnitude
    slower at transcriptome scale (shark_tpu's docs/PERF.md "XL build
    cost")."""
    from shark_tpu_torch.io.native import set_positions_native

    got = set_positions_native(
        np.ascontiguousarray(index.bf_words),
        int(index.n_set_bits),
        threads=threads,
    )
    if got is not None:
        return got
    import sys as _sys

    if _sys.byteorder != "little":
        # the u8-view + bitorder="little" trick below maps byte order
        # into bit positions and is only correct on little-endian hosts
        # (every supported host); the native path above is endian-safe
        raise NotImplementedError(
            "pure-Python set-bit extraction requires a little-endian host"
        )
    bw = index.bf_words
    n = int(index.n_set_bits)
    out = np.empty(n, np.uint64)
    u8 = bw.view(np.uint8)
    CH = 1 << 24  # bytes per chunk (128 MB of unpacked bools)
    o = 0
    for s in range(0, u8.size, CH):
        bits = np.unpackbits(u8[s : s + CH], bitorder="little")
        nz = np.flatnonzero(bits)
        out[o : o + nz.size] = nz.astype(np.uint64) + np.uint64(s * 8)
        o += nz.size
    assert o == n, (o, n)
    return out


def _entry_streams(index: SharkIndex, threads: Optional[int] = None):
    """(pos, tag, payload, has_rows, deg): one (tag, payload) entry per set
    Bloom position in CSR rank order — the shared input of every hashed
    table layout. Tag semantics per step.TAG_*; tag-3 payloads index the
    COMPACTED deg>=3 row table (build_rows3), not the global CSR rank."""
    pos = _set_bit_positions(index, threads=threads)
    deg = np.diff(index.offsets).astype(np.int64)
    off = index.offsets[:-1].astype(np.int64)
    gene_ids = np.asarray(index.gene_ids)
    first_gene = gene_ids[np.minimum(off, gene_ids.size - 1)].astype(np.uint32)

    tag = np.where(deg == 1, TAG_D1, np.where(deg == 2, TAG_D2, TAG_ROW))
    payload = first_gene.copy()
    d2 = deg == 2
    if d2.any():
        payload[d2] |= gene_ids[off[d2] + 1].astype(np.uint32) << 16
    d3 = deg >= 3
    if d3.any():
        from shark_tpu_torch.classify.step import rows3_payload

        payload[d3] = rows3_payload(index)  # rows3 index (+ gid bits)
    return pos, tag, payload, bool(d3.any()), deg


def _demand_bincount(pos: np.ndarray, need, lgB: int) -> np.ndarray:
    """Per-bucket slot-word demand (int64[2^lgB]). Integer bincounts,
    deg>=2 entries (rare) counted by a second small bincount: cheaper than
    one float-weighted bincount."""
    b = (pos & np.uint64((1 << lgB) - 1)).astype(np.int64)
    d = np.bincount(b, minlength=1 << lgB)
    if need is not None:
        extra = b[need == 2]
        if extra.size:
            d = d + np.bincount(extra, minlength=1 << lgB)
    return d


def build_hashed_index(
    index: SharkIndex,
    prefer_small: bool = True,
    allow16: bool = True,
    threads: Optional[int] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray, HashedMeta]]:
    """(table, stash, meta) or None if this index should use the classic
    path (stash overflow at the table-size cap, or rank capacity).

    Bucket layouts, tried in shark_tpu's order (its selection policy and
    the 64 MB table cap were tuned for the TPU's gather engine; the port
    keeps them so both packages build identical tables):

    - entry16 (one u32 word per entry: tag<<14|rest in the high half,
      payload16 low): [n_buckets, slots] with slots = 4, then 8; a
      degree-2 or row entry takes TWO adjacent words (payload halves).
      Needs rest = p >> lgB to fit 14 bits.
    - entry8 (64-byte planar buckets): 8-byte entries (tag<<30|rest,
      payload32). Needs rest to fit 30 bits.

    The spill stash is compared against every probe, so candidates are
    accepted only while it stays tiny.
    prefer_small=False pins the natural entry8 bucket count (A/B control).
    """
    n_set = index.n_set_bits
    if n_set == 0:
        meta = HashedMeta(lgB=6, has_rows=False)
        return (
            np.zeros((64, 2, BUCKET_SLOTS), np.uint32),
            _pad_stash(np.empty((0, 4), np.uint32)),
            meta,
        )
    if n_set >= 1 << 31:
        return None  # int32 gene_mat addressing for TAG_ROW ranks

    pos, tag, payload, has_rows, deg = _entry_streams(index, threads=threads)
    assert pos.size == n_set

    need16 = np.where(deg == 1, 1, 2).astype(np.int64)
    slots16 = int(need16.sum())

    candidates = []  # (entry16, slots, lgB, is_last_of_family)
    if allow16 and prefer_small:
        # 8 slots/bucket only, as in shark_tpu
        for slots in (8,):
            lg_cap = int(np.log2(MAX_TABLE_BYTES // (4 * slots)))
            lg_nat = min(max(6, int(np.ceil(np.log2(slots16)))), lg_cap)
            fam = [
                c
                for c in range(max(6, lg_nat - 3), lg_nat + 1)
                if index.size_bits <= (1 << c) << 14
            ]
            if fam:
                candidates += [(True, slots, c, c == fam[-1]) for c in fam]
    lg_nat8 = min(
        max(6, int(np.ceil(np.log2(n_set)))),
        int(np.log2(MAX_BUCKETS)),
    )
    lo8 = max(6, lg_nat8 - 3) if prefer_small else lg_nat8
    fam8 = [
        c
        for c in range(lo8, lg_nat8 + 1)
        if index.size_bits <= (1 << c) << 30
    ]
    candidates += [(False, BUCKET_SLOTS, c, c == fam8[-1]) for c in fam8]

    for entry16, slots, lgB, last in candidates:
        need = need16 if entry16 else None
        limit = STASH_CAP if (last and not entry16) else SMALL_STASH
        # cheap slot-demand bound before the exact pack
        demand = _demand_bincount(pos, need, lgB)
        if int((demand - slots).clip(min=0).sum()) > 2 * limit + 2:
            continue
        built = _pack_table(pos, tag, payload, need, lgB, entry16, slots)
        if built is None:
            continue
        table, stash_rows = built
        if stash_rows.shape[0] > limit:
            continue
        return (
            table,
            _pad_stash(stash_rows),
            HashedMeta(
                lgB=lgB, has_rows=has_rows, entry16=entry16, slots=slots
            ),
        )
    return None


def build_hashed_xl(
    index: SharkIndex,
    lgB: Optional[int] = None,
    side_lgB: Optional[int] = None,
    threads: Optional[int] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, HashedMeta]]:
    """(table, side, side_stash, meta) for the GB-scale one-load layout,
    or None when the classic path should be used instead (shark_tpu
    hashed.build_hashed_xl, which builds the same arrays).

    Sizing: buckets hold XL_SLOTS u32 words; entry slot demand is 1 word
    per degree-1 entry and 2 for degree>=2 (payload halves, like entry16).
    The natural bucket count puts ~1-2 demand words per 4-slot bucket, so
    the spill mass stays near 1.5% of entries; the spills go to a SIDE
    entry8 table read only by windows of a flagged bucket that matched
    nothing there. `lgB`/`side_lgB` pin the geometries (tests)."""
    n_set = index.n_set_bits
    if n_set == 0 or n_set >= 1 << 31:
        return None
    lg_min = max(
        6, int(np.ceil(np.log2(index.size_bits))) - XL_REST_BITS
    )
    if lg_min > XL_MAX_LGB:
        return None  # bloom too large for 13-bit rest at any bucket count
    spill_cap = max(n_set // 64, 1024)
    decline_cap = max(n_set // 8, 4096)

    def _cands(demand: int):
        """Bucket-count candidates (shared by the native and numpy
        builds so their selection policy cannot desynchronize)."""
        if lgB is not None:
            cs = [lgB]
        else:
            lg_nat = int(np.ceil(np.log2(max(demand, 2))))
            cs = sorted(
                {
                    min(max(c, lg_min), XL_MAX_LGB)
                    for c in (lg_nat - 1, lg_nat)
                }
            )
        # bit 13 of meta16 is the overflow flag, so rest must fit 13 bits
        # strictly at EVERY candidate (lg_min guarantees it for the auto
        # ones; this guards a pinned lgB, which would otherwise bleed rest
        # bits into the flag/tag fields)
        assert (int(index.size_bits) - 1) >> cs[0] < (
            1 << XL_REST_BITS
        ), cs[0]
        return cs

    from shark_tpu_torch.io import native as _native

    if _native.available():
        # native pack: entry streams + bucket fill in one C++ pass. The
        # candidate is chosen by the ACTUAL spill count at each geometry
        # (try-pack) instead of the numpy path's word-demand bound; both
        # are exact, but the auto-picked lgB can differ by 1 between them.
        from shark_tpu_torch.classify.step import rows3_payload

        deg = np.diff(index.offsets)
        has_rows = bool((deg >= 3).any())
        d3pay = (
            rows3_payload(index) if has_rows else np.zeros(0, np.uint32)
        )
        demand = 2 * n_set - int(np.count_nonzero(deg == 1))
        del deg
        cands = _cands(demand)
        table = spill = None
        for c in cands:
            cap = decline_cap if c == cands[-1] else 2 * spill_cap
            res = _native.pack_xl_native(
                index, d3pay, c, XL_SLOTS, True, cap, threads=threads
            )
            if res is not None:
                table, spill, lgB = res[0], res[1], c
                break
        if table is None:
            return None  # every candidate spilled past the decline cap
    else:
        pos, tag, payload, has_rows, deg = _entry_streams(
            index, threads=threads
        )
        need = np.where(deg == 1, 1, 2).astype(np.int64)
        demand = int(need.sum())
        cands = _cands(demand)
        if len(cands) > 1:
            # choose the bucket count from a cheap slot-demand bound (one
            # bincount per candidate) so the exact pack runs once: the
            # smallest whose overflow bound stays ~1.5%
            for c in cands:
                demand_c = _demand_bincount(pos, need, c)
                bound = int((demand_c - XL_SLOTS).clip(min=0).sum())
                if bound <= 2 * spill_cap or c == cands[-1]:
                    cands = [c]
                    break
        lgB = cands[0]
        assert int(pos.max(initial=0)) >> lgB < (1 << XL_REST_BITS), lgB
        table, spill = _pack_table(
            pos, tag, payload, need, lgB, True, XL_SLOTS
        )
        if spill.shape[0] > decline_cap:
            return None  # degenerate distribution; classic path is safer

    n_sp = spill.shape[0]
    if n_sp:
        # flag every overflowed bucket (bit 13 of slot-0's meta16): probes
        # that miss in a flagged bucket must consult the side table
        spos = _stash_positions(spill)
        sbuck = (spos & np.uint64((1 << lgB) - 1)).astype(np.int64)
        table[np.unique(sbuck), 0] |= np.uint32(1 << XL_FLAG_BIT)

        lg2_min = max(6, int(np.ceil(np.log2(index.size_bits))) - 30)
        lg2 = side_lgB if side_lgB is not None else max(
            lg2_min, int(np.ceil(np.log2(max(n_sp, 2)))) - 2
        )
        side = None
        for c2 in range(lg2, min(lg2 + 8, XL_MAX_LGB + 1)):
            s, st = _pack_table(
                spos, spill[:, 2].astype(np.int64), spill[:, 3], None, c2,
                False,
            )
            if st.shape[0] <= XL_SIDE_STASH_CAP:
                side, side_stash_rows, lg2 = s, st, c2
                break
            if side_lgB is not None:
                return None  # pinned geometry cannot absorb its spills
        if side is None:
            return None
    else:
        lg2 = 6
        side = np.zeros((1 << lg2, 2, BUCKET_SLOTS), np.uint32)
        side_stash_rows = np.empty((0, 4), np.uint32)

    meta = HashedMeta(
        lgB=lgB,
        has_rows=has_rows,
        entry16=True,
        slots=XL_SLOTS,
        xl=True,
        side_lgB=lg2,
        has_side=n_sp > 0,
    )
    return table, side, _pad_stash(side_stash_rows), meta


def _stash_positions(rows: np.ndarray) -> np.ndarray:
    """uint64 positions from stash-layout rows (pos_lo, pos_hi, ...)."""
    return rows[:, 0].astype(np.uint64) | (
        rows[:, 1].astype(np.uint64) << np.uint64(32)
    )


def _pack_table(
    pos: np.ndarray,
    tag: np.ndarray,
    payload: np.ndarray,
    need: Optional[np.ndarray],  # slots per entry (None = all 1, entry8)
    lgB: int,
    entry16: bool,
    slots: int = BUCKET_SLOTS,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(table, stash_rows) for one (layout, bucket-count) candidate.

    Host-cost discipline (shark_tpu's docs/PERF.md "XL build cost"): sort
    ONE u32 key and gather only the three arrays the fill needs
    (bucket/need are re-derived elementwise, cheaper than random gathers),
    and the per-bucket slot offsets come from one maximum.accumulate
    instead of a flatnonzero + concatenates + np.repeat."""
    n_set = pos.size
    n_buckets = 1 << lgB
    bucket = (pos & np.uint64(n_buckets - 1)).astype(np.uint32)
    order = np.argsort(bucket, kind="stable")
    pos_s = pos[order]
    tag_s = tag[order].astype(np.uint32)
    pay_s = payload[order]
    bucket_s = (pos_s & np.uint64(n_buckets - 1)).astype(np.int64)
    if need is not None:
        # need is always where(deg==1, 1, 2) and tag is TAG_D1 iff deg==1
        # (build_hashed_index/_xl), so re-derive instead of gathering.
        # Check the contract on the WHOLE array: a caller violating it
        # between sampled entries would silently build a wrong table, and
        # the full vectorized compare is cheap next to the pack itself.
        assert (
            (need == 1) == (tag == TAG_D1)
        ).all(), "need/tag contract violated"
        need_s = np.where(tag_s == TAG_D1, 1, 2).astype(np.int64)
    else:
        need_s = np.ones(n_set, np.int64)
    csum = np.cumsum(need_s)
    start = csum - need_s  # nondecreasing
    is_first = np.empty(n_set, bool)
    if n_set:
        is_first[0] = True
        is_first[1:] = bucket_s[1:] != bucket_s[:-1]
    base = np.maximum.accumulate(np.where(is_first, start, 0))
    slot = start - base  # first slot offset within the bucket
    in_table = slot + need_s <= slots
    spill = np.flatnonzero(~in_table)

    rest = (pos_s >> np.uint64(lgB)).astype(np.uint32)
    tb = bucket_s[in_table]
    ts = slot[in_table]
    if entry16:
        assert int(rest.max(initial=0)) < (1 << 14)
        # one u32 word per entry: meta16 (tag<<14|rest) high, payload16 low
        table = np.zeros((n_buckets, slots), dtype=np.uint32)
        meta16 = ((tag_s << 14) | rest).astype(np.uint32) << 16
        table[tb, ts] = meta16[in_table] | (pay_s[in_table] & 0xFFFF)
        two = in_table & (need_s == 2)
        table[bucket_s[two], slot[two] + 1] = meta16[two] | (
            pay_s[two] >> 16
        )
    else:
        table = np.zeros((n_buckets, 2, BUCKET_SLOTS), dtype=np.uint32)
        table[tb, 0, ts] = (tag_s[in_table] << 30) | rest[in_table]
        table[tb, 1, ts] = pay_s[in_table]

    stash = np.empty((spill.size, 4), dtype=np.uint32)
    stash[:, 0] = (pos_s[spill] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    stash[:, 1] = (pos_s[spill] >> np.uint64(32)).astype(np.uint32)
    stash[:, 2] = tag_s[spill]
    stash[:, 3] = pay_s[spill]
    return table, stash


def _pad_stash(stash: np.ndarray) -> np.ndarray:
    """Pad to the next power of two >= STASH_MIN with rows that can never
    match a real probe (pos_hi of a real position is < 2^4)."""
    n = max(STASH_MIN, 1 << int(np.ceil(np.log2(max(1, stash.shape[0])))))
    pad = np.full((n - stash.shape[0], 4), 0xFFFFFFFF, np.uint32)
    return np.vstack([stash, pad]) if stash.size else pad


def stash_rows_before_pad(stash: np.ndarray) -> int:
    """The count of stash rows before its trailing rows of 0xFFFFFFFF in
    all four words (the rows _pad_stash appends): what K2 reads."""
    real = np.flatnonzero((stash != 0xFFFFFFFF).any(axis=1))
    return int(real[-1]) + 1 if real.size else 0


def empty_stash() -> np.ndarray:
    """The padded stash of a layout without one (xl): no row can match."""
    return _pad_stash(np.empty((0, 4), np.uint32))


def hashed_device_index(
    table: np.ndarray,
    stash: np.ndarray,
    rows3: np.ndarray,
    ext_mat: Optional[np.ndarray],
    hmeta,
    device,
    side: Optional[np.ndarray] = None,
    side_stash: Optional[np.ndarray] = None,
) -> Tuple[HashedDeviceIndex, HashedMeta]:
    """Device tables from the numpy arrays exactly as build_hashed_index /
    build_hashed_xl and build_rows3 (of either package) built them. `hmeta`
    is a HashedMeta of either package, or a dict of its fields. An xl
    table comes with its `side` and `side_stash`. rows3 may come as u16
    rows (shark_tpu's placeholder for a row-free index) and is packed two
    fields per u32 word, the kernels' layout."""
    if not isinstance(hmeta, dict):
        hmeta = {f.name: getattr(hmeta, f.name) for f in fields(HashedMeta)}
    hmeta = HashedMeta(**hmeta)
    if hmeta.xl and (side is None or side_stash is None):
        raise ValueError("an xl table needs its side table and side stash")
    if rows3.dtype == np.uint16:
        rows3 = pack_rows_u32(rows3)
    u32 = np.uint32
    dix = HashedDeviceIndex(
        table=to_device(table, device, u32),
        stash=to_device(stash, device, u32),
        rows3=to_device(rows3, device, u32),
        ext_mat=to_device(ext_mat, device, np.uint16),
        side=to_device(side, device, u32),
        side_stash=to_device(side_stash, device, u32),
        stash_rows=stash_rows_before_pad(np.asarray(stash)),
    )
    return dix, hmeta


def _bucket_rest(lo, hi, lgB: int):
    """(bucket, rest) of int64 positions (lo, hi) in a 2^lgB-bucket table;
    rest wraps to 32 bits as the u32 arithmetic of the kernels does."""
    rest = (lo >> lgB) | ((hi << (32 - lgB)) & 0xFFFFFFFF)
    return lo & ((1 << lgB) - 1), rest


def _match16(row, rest, valid, rest_mask: int):
    """entry16 lanes (int64 words [..., slots]): a degree-2 or row entry
    spans two adjacent words, so up to two lanes match; payload = first
    match's low half | (sum of later matches) << 16, tag = max tag.
    Returns (tag, pay, any lane matched)."""
    slots = row.shape[-1]
    zero = torch.zeros((), dtype=torch.int64, device=row.device)
    meta_l = row >> 16
    pay_l = row & 0xFFFF
    lane_tag = meta_l >> 14
    m = ((meta_l & rest_mask) == rest[..., None]) & (lane_tag != 0) \
        & valid[..., None]
    iota = torch.arange(slots, device=row.device)
    fs = torch.where(m, iota, slots).min(dim=-1, keepdim=True).values
    p0 = torch.where(m & (iota == fs), pay_l, zero).sum(dim=-1)
    p1 = torch.where(m & (iota > fs), pay_l, zero).sum(dim=-1)
    tagv = torch.where(m, lane_tag, zero).max(dim=-1).values
    return tagv, p0 | (p1 << 16), m.any(dim=-1)


def _match8(row, rest, valid):
    """entry8 lanes (planar int64 [..., 2, 8]): at most one lane matches,
    so tag and payload are masked sums."""
    zero = torch.zeros((), dtype=torch.int64, device=row.device)
    w0 = row[..., 0, :]
    w1 = row[..., 1, :]
    lane_tag = w0 >> 30
    m = ((w0 & 0x3FFFFFFF) == rest[..., None]) & (lane_tag != 0) \
        & valid[..., None]
    return (torch.where(m, lane_tag, zero).sum(dim=-1),
            torch.where(m, w1, zero).sum(dim=-1))


def _add_stash(lo, hi, valid, stash, tagv, payv):
    """Add every stash row (pos_lo, pos_hi, tag, payload) whose full
    position equals the window's, one row at a time (at most one can
    match a position; the sum is shark_tpu's masked sum)."""
    zero = torch.zeros((), dtype=torch.int64, device=lo.device)
    st = stash.to(torch.int64)
    for s in range(st.shape[0]):
        hit = (lo == st[s, 0]) & (hi == st[s, 1]) & valid
        tagv = tagv + torch.where(hit, st[s, 2], zero)
        payv = payv + torch.where(hit, st[s, 3], zero)
    return tagv, payv


def _u32(tagv, payv):
    mask = 0xFFFFFFFF
    return (tagv & mask).to(torch.uint32), (payv & mask).to(torch.uint32)


def probe_hashed_plain(idx_hi, idx_lo, win_valid, table, stash, hmeta):
    """Plain version of K2 in int64 (shark_tpu hashed.py:563-644)."""
    lo = idx_lo.to(torch.int64)
    hi = idx_hi.to(torch.int64)
    bucket, rest = _bucket_rest(lo, hi, hmeta.lgB)
    row = gather_u32(table, bucket)
    if hmeta.entry16:
        tagv, payv, _ = _match16(row, rest, win_valid, 0x3FFF)
    else:
        tagv, payv = _match8(row, rest, win_valid)
    return _u32(*_add_stash(lo, hi, win_valid, stash, tagv, payv))


def _check_stash(stash, name, cap, dev):
    kernels.require(stash, name, torch.uint32, 2, dev)
    if stash.shape[1] != 4 or stash.shape[0] > cap:
        raise ValueError(f"{name} shape {tuple(stash.shape)}")


def probe_hashed(
    idx_hi: torch.Tensor,  # u32[B, Ls]
    idx_lo: torch.Tensor,  # u32[B, Ls]
    win_valid: torch.Tensor,  # bool[B, Ls]
    table: torch.Tensor,
    stash: torch.Tensor,
    hmeta: HashedMeta,
    stash_rows: Optional[int] = None,
):
    """K2: Bloom positions -> (tagv u32[B, Ls], payv u32[B, Ls]) through
    one bucket of the entry16 or entry8 table plus the stash. CUDA tensors
    run csrc/probe.cu, which reads the first `stash_rows` rows of the
    stash and counts the rest, which must be padding rows (0xFFFFFFFF in
    all four words), without reading them; None takes the count from the
    stash (HashedDeviceIndex.stash_rows holds it; here it costs a copy to
    the host). CPU tensors run the plain version."""
    if hmeta.xl:
        raise ValueError("an xl table is probed by probe_xl")
    if not idx_lo.is_cuda:
        return probe_hashed_plain(idx_hi, idx_lo, win_valid, table, stash,
                                  hmeta)
    dev = require_windows(idx_hi, idx_lo, win_valid)
    if hmeta.entry16:
        kernels.require(table, "table", torch.uint32, 2, dev)
        if table.shape[1] != hmeta.slots or hmeta.slots % 4:
            raise ValueError(f"entry16 table of {table.shape[1]} slots")
    else:
        kernels.require(table, "table", torch.uint32, 3, dev)
        if tuple(table.shape[1:]) != (2, BUCKET_SLOTS):
            raise ValueError(f"entry8 table shape {tuple(table.shape)}")
    if table.shape[0] != 1 << hmeta.lgB:
        raise ValueError("table rows != 2**lgB")
    _check_stash(stash, "stash", STASH_CAP, dev)
    if stash_rows is None:
        stash_rows = stash_rows_before_pad(stash.cpu().numpy())
    if not 0 <= stash_rows <= stash.shape[0]:
        raise ValueError(f"stash_rows {stash_rows} of {stash.shape[0]}")
    # both outputs are views of one allocation (unbind costs less host
    # time than slicing a flat one)
    tagv, payv = torch.empty((2, *idx_lo.shape), dtype=torch.uint32,
                             device=dev).unbind(0)
    rc = kernels.lib().shkk_probe(
        idx_hi.data_ptr(), idx_lo.data_ptr(), win_valid.data_ptr(),
        idx_lo.numel(), table.data_ptr(), hmeta.lgB, int(hmeta.entry16),
        hmeta.slots, stash.data_ptr(), stash.shape[0], stash_rows,
        tagv.data_ptr(), payv.data_ptr(), kernels.stream(dev))
    kernels.check(rc, "probe")
    kernels.LAUNCHES.add("probe")
    return tagv, payv


def xl_side_resolve_plain(lo, hi, need_side, tagv, payv, side, side_stash,
                          hmeta):
    """Plain version of K6's side resolve (shark_tpu hashed.py:662
    _xl_side_resolve), in int64: every need_side window (valid, flagged
    bucket, no lane matched in the main row) takes the (tag, payload) of
    the entry8 side bucket plus the side stash, overwriting its (0, 0)
    even when the side misses too. Only those windows are gathered; the
    values are those of both of shark_tpu's branches (compacted and full
    width)."""
    sel = need_side.nonzero(as_tuple=True)
    slo, shi = lo[sel], hi[sel]
    bucket2, rest2 = _bucket_rest(slo, shi, hmeta.side_lgB)
    every = torch.ones_like(slo, dtype=torch.bool)
    t, p = _match8(gather_u32(side, bucket2), rest2, every)
    t, p = _add_stash(slo, shi, every, side_stash, t, p)
    tagv = tagv.clone()
    payv = payv.clone()
    tagv[sel] = t
    payv[sel] = p
    return tagv, payv


def probe_xl_plain(idx_hi, idx_lo, win_valid, table, side, side_stash, hmeta):
    """Plain version of K6 in int64 (shark_tpu hashed.py:568-594): the
    entry16 match of one 16-byte bucket with a 13-bit rest mask (the flag
    in bit 13 of slot 0's meta never breaks a slot-0 match), then the side
    resolve. The xl layout compares no main stash (hashed.py:629-633)."""
    lo = idx_lo.to(torch.int64)
    hi = idx_hi.to(torch.int64)
    bucket, rest = _bucket_rest(lo, hi, hmeta.lgB)
    row = gather_u32(table, bucket)
    tagv, payv, matched = _match16(
        row, rest, win_valid, (1 << XL_REST_BITS) - 1)
    if hmeta.has_side:
        flagged = ((row[..., 0] >> XL_FLAG_BIT) & 1) == 1
        need_side = win_valid & flagged & ~matched
        tagv, payv = xl_side_resolve_plain(
            lo, hi, need_side, tagv, payv, side, side_stash, hmeta)
    return _u32(tagv, payv)


def probe_xl(
    idx_hi: torch.Tensor,  # u32[B, Ls]
    idx_lo: torch.Tensor,  # u32[B, Ls]
    win_valid: torch.Tensor,  # bool[B, Ls]
    table: torch.Tensor,  # u32[2^lgB, 4]
    side: torch.Tensor,  # u32[2^side_lgB, 2, 8]
    side_stash: torch.Tensor,  # u32[S2, 4]
    hmeta: HashedMeta,
):
    """K6: Bloom positions -> (tagv u32[B, Ls], payv u32[B, Ls]) through
    one xl bucket, and the side table for windows of a flagged bucket that
    matched nothing. CUDA tensors run csrc/xl.cu; CPU tensors the plain
    version."""
    if not hmeta.xl:
        raise ValueError("probe_xl takes an xl table")
    if not idx_lo.is_cuda:
        return probe_xl_plain(idx_hi, idx_lo, win_valid, table, side,
                              side_stash, hmeta)
    dev = require_windows(idx_hi, idx_lo, win_valid)
    kernels.require(table, "table", torch.uint32, 2, dev)
    if tuple(table.shape) != (1 << hmeta.lgB, XL_SLOTS):
        raise ValueError(f"xl table shape {tuple(table.shape)}")
    kernels.require(side, "side", torch.uint32, 3, dev)
    if tuple(side.shape) != (1 << hmeta.side_lgB, 2, BUCKET_SLOTS):
        raise ValueError(f"side table shape {tuple(side.shape)}")
    _check_stash(side_stash, "side_stash", XL_SIDE_STASH_CAP, dev)
    # both outputs are views of one allocation, each 16-byte aligned
    n = idx_lo.numel()
    n4 = (n + 3) & ~3
    out = torch.empty((n4 + n,), dtype=torch.uint32, device=dev)
    tagv = out[:n].view(idx_lo.shape)
    payv = out[n4:].view(idx_lo.shape)
    rc = kernels.lib().shkk_probe_xl(
        idx_hi.data_ptr(), idx_lo.data_ptr(), win_valid.data_ptr(),
        n, table.data_ptr(), hmeta.lgB, side.data_ptr(),
        hmeta.side_lgB, int(hmeta.has_side), side_stash.data_ptr(),
        side_stash.shape[0], tagv.data_ptr(), payv.data_ptr(),
        kernels.stream(dev))
    kernels.check(rc, "probe_xl")
    kernels.LAUNCHES.add("probe_xl")
    return tagv, payv
