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
so both packages build identical tables; the GB-scale xl layout
(build_hashed_xl) is not in the port yet, and Classifier raises where
shark_tpu would select it.

K2, the probe (probe_hashed), runs csrc/probe.cu on a CUDA tensor and its
plain PyTorch version on a CPU tensor; classify_kernel_hashed_packed
composes K1 -> K2 -> K3.
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
    StaticMeta,
    finish_from_tags,
    front_end,
    pack_codes,
    pack_rows_u32,
)
from shark_tpu_torch.index.structure import SharkIndex

BUCKET_SLOTS = 8
STASH_CAP = 256
SMALL_STASH = 64  # cap when shrinking below the natural bucket count
STASH_MIN = 32
# shark_tpu's table budget (a TPU gather-rate cliff); kept for bit parity
MAX_TABLE_BYTES = 64 << 20
MAX_BUCKETS = MAX_TABLE_BYTES // (8 * BUCKET_SLOTS)

# shark_tpu's GB-scale "xl" layout constants. The layout is not ported;
# the constants are part of the probe-table cache key.
XL_SLOTS = 4
XL_REST_BITS = 13
XL_FLAG_BIT = 29
XL_SIDE_CAP = 8
XL_SIDE_STASH_CAP = 128
XL_MAX_LGB = 30


class HashedDeviceIndex(NamedTuple):
    # entry16: uint32[n_buckets, slots] (meta16<<16 | pay16 per word);
    # entry8:  uint32[n_buckets, 2, BUCKET_SLOTS] (w0 plane, w1 plane)
    table: torch.Tensor
    stash: torch.Tensor  # uint32[S, 4]: pos_lo, pos_hi, tag, payload
    rows3: torch.Tensor  # uint32[max(n_deg3,1), ceil((D3+1)/2)] packed rows
    ext_mat: Optional[torch.Tensor] = None  # uint16[n_ovf, ext3_w]


@dataclass(frozen=True)
class HashedMeta:
    lgB: int  # log2(n_buckets)
    has_rows: bool  # any degree >= 3 entry exists
    entry16: bool = False  # 4-byte entries (one u32 word each) vs 8-byte
    slots: int = BUCKET_SLOTS  # entry slots per bucket (entry16: 4 or 8)
    xl: bool = False  # shark_tpu's xl layout (not ported)
    side_lgB: int = 0
    has_side: bool = False


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


def hashed_device_index(
    table: np.ndarray,
    stash: np.ndarray,
    rows3: np.ndarray,
    ext_mat: Optional[np.ndarray],
    hmeta,
    device,
) -> Tuple[HashedDeviceIndex, HashedMeta]:
    """Device tables from the numpy arrays exactly as build_hashed_index
    and build_rows3 (of either package) built them. `hmeta` is a
    HashedMeta of either package, or a dict of its fields. rows3 may come
    as u16 rows (shark_tpu's placeholder for a row-free index) and is
    packed two fields per u32 word, the kernels' layout."""
    if not isinstance(hmeta, dict):
        hmeta = {f.name: getattr(hmeta, f.name) for f in fields(HashedMeta)}
    hmeta = HashedMeta(**hmeta)
    if hmeta.xl:
        from shark_tpu_torch.config import not_ported

        raise not_ported("the xl probe layout", "xl probe")
    if rows3.dtype == np.uint16:
        rows3 = pack_rows_u32(rows3)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    dix = HashedDeviceIndex(
        table=put(table, np.uint32),
        stash=put(stash, np.uint32),
        rows3=put(rows3, np.uint32),
        ext_mat=put(ext_mat, np.uint16) if ext_mat is not None else None,
    )
    return dix, hmeta


def probe_hashed_plain(idx_hi, idx_lo, win_valid, table, stash, hmeta):
    """Plain version of K2 in int64 (shark_tpu hashed.py:563-644)."""
    lo = idx_lo.to(torch.int64)
    hi = idx_hi.to(torch.int64)
    lgB = hmeta.lgB
    bucket = lo & ((1 << lgB) - 1)
    rest = (lo >> lgB) | ((hi << (32 - lgB)) & 0xFFFFFFFF)
    row = table.to(torch.int64)[bucket]
    valid = win_valid[..., None]
    zero = torch.zeros((), dtype=torch.int64, device=lo.device)
    if hmeta.entry16:
        meta_l = row >> 16  # [..., slots]
        pay_l = row & 0xFFFF
        lane_tag = meta_l >> 14
        m = ((meta_l & 0x3FFF) == rest[..., None]) & (lane_tag != 0) & valid
        iota = torch.arange(hmeta.slots, device=lo.device)
        fs = torch.where(m, iota, hmeta.slots).min(dim=-1, keepdim=True).values
        p0 = torch.where(m & (iota == fs), pay_l, zero).sum(dim=-1)
        p1 = torch.where(m & (iota > fs), pay_l, zero).sum(dim=-1)
        tagv = torch.where(m, lane_tag, zero).max(dim=-1).values
        payv = p0 | (p1 << 16)
    else:
        w0 = row[..., 0, :]
        w1 = row[..., 1, :]
        lane_tag = w0 >> 30
        m = ((w0 & 0x3FFFFFFF) == rest[..., None]) & (lane_tag != 0) & valid
        tagv = torch.where(m, lane_tag, zero).sum(dim=-1)
        payv = torch.where(m, w1, zero).sum(dim=-1)
    # stash rows: full-position compare, one row at a time (at most one
    # can match a position; the sum is shark_tpu's masked sum)
    st = stash.to(torch.int64)
    for s in range(st.shape[0]):
        hit = (lo == st[s, 0]) & (hi == st[s, 1]) & win_valid
        tagv = tagv + torch.where(hit, st[s, 2], zero)
        payv = payv + torch.where(hit, st[s, 3], zero)
    mask = 0xFFFFFFFF
    return (tagv & mask).to(torch.uint32), (payv & mask).to(torch.uint32)


def probe_hashed(
    idx_hi: torch.Tensor,  # u32[B, Ls]
    idx_lo: torch.Tensor,  # u32[B, Ls]
    win_valid: torch.Tensor,  # bool[B, Ls]
    table: torch.Tensor,
    stash: torch.Tensor,
    hmeta: HashedMeta,
):
    """K2: Bloom positions -> (tagv u32[B, Ls], payv u32[B, Ls]) through
    one bucket of the entry16 or entry8 table plus the stash. CUDA tensors
    run csrc/probe.cu; CPU tensors the plain version."""
    if hmeta.xl:
        from shark_tpu_torch.config import not_ported

        raise not_ported("the xl probe layout", "xl probe")
    if not idx_lo.is_cuda:
        return probe_hashed_plain(idx_hi, idx_lo, win_valid, table, stash,
                                  hmeta)
    dev = idx_lo.device
    kernels.require(idx_hi, "idx_hi", torch.uint32, idx_lo.dim(), dev)
    kernels.require(idx_lo, "idx_lo", torch.uint32, idx_lo.dim(), dev)
    kernels.require(win_valid, "win_valid", torch.bool, idx_lo.dim(), dev)
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
    kernels.require(stash, "stash", torch.uint32, 2, dev)
    if stash.shape[1] != 4 or stash.shape[0] > STASH_CAP:
        raise ValueError(f"stash shape {tuple(stash.shape)}")
    tagv = torch.empty_like(idx_lo)
    payv = torch.empty_like(idx_lo)
    rc = kernels.lib().shkk_probe(
        idx_hi.data_ptr(), idx_lo.data_ptr(), win_valid.data_ptr(),
        idx_lo.numel(), table.data_ptr(), hmeta.lgB, int(hmeta.entry16),
        hmeta.slots, stash.data_ptr(), stash.shape[0], tagv.data_ptr(),
        payv.data_ptr(), kernels.stream(dev))
    kernels.check(rc, "probe")
    kernels.LAUNCHES.add("probe")
    return tagv, payv


def classify_kernel_hashed_packed(
    dix: HashedDeviceIndex,
    thresh: torch.Tensor,
    packed: torch.Tensor,  # u8[B, L/4]
    vmask: torch.Tensor,  # u8[B, L/8]
    *,
    meta: StaticMeta,
    hmeta: HashedMeta,
    max_winners: int,
):
    """K1 -> K2 -> K3: planar reads -> (packed i32[B], winners i32[B, W],
    best_cov i32[B], length i32[B]), bit-exact with shark_tpu's
    classify_kernel_hashed_packed."""
    L = packed.shape[1] * 4
    idx_hi, idx_lo, win_valid, length = front_end(packed, vmask, meta)
    tagv, payv = probe_hashed(
        idx_hi, idx_lo, win_valid, dix.table, dix.stash, hmeta
    )
    return finish_from_tags(
        tagv, payv, length, thresh,
        rows3=dix.rows3, ext_mat=dix.ext_mat, meta=meta,
        max_winners=max_winners, L=L, has_rows=hmeta.has_rows,
    )


def classify_kernel_hashed(
    dix: HashedDeviceIndex,
    thresh: torch.Tensor,
    codes: torch.Tensor,  # u8[B, L], L % 8 == 0
    *,
    meta: StaticMeta,
    hmeta: HashedMeta,
    max_winners: int,
):
    """Byte codes -> verdicts, through the planar packing of the main
    path (pack_codes) and classify_kernel_hashed_packed."""
    packed, vmask = pack_codes(codes)
    return classify_kernel_hashed_packed(
        dix, thresh, packed, vmask, meta=meta, hmeta=hmeta,
        max_winners=max_winners,
    )
