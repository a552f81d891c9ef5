"""The classify step: planar reads -> per-read verdicts, on the device.

PyTorch counterpart of shark_tpu/classify/step.py. Per batch of padded
reads [B, L] it computes:

  1. K1, the front end (front_end): canonical k-mer, XXH64 and Bloom
     position of every probe window, and each read's length;
  2. the probe of the index's layout, per window a (tag, payload): K2
     through the hashed bucket table (classify/hashed.py probe_hashed),
     K6 through the xl table and its side table (hashed.py probe_xl), or
     K5 through the classic (word, rank) and pay rows (probe_tags);
  3. K3, the finish (finish_from_tags): the sort-based segmented coverage
     reduction to winners and one packed int32 verdict per read;
  4. K4, extract_pairs: the winners of tie-heavy batches as one sorted
     (row << 16 | gene) stream, for the host drain.

The reference accumulates, per (read, gene), cov += min(k, pos - last)
sequentially over k-mer positions (ReadAnalyzer.hpp:56-86). That recurrence
equals the size of the union of k-length intervals ending at the gene's hit
positions, which is order-free: sort the (gene, pos) hit pairs of each read,
then within each equal-gene segment the contribution of a hit is
min(k, pos_i - pos_{i-1}) and the segment head contributes k. Winners are
the argmax segments by lexicographic (cov, hits) with ties kept, exactly as
the reference's std::map scan (ReadAnalyzer.hpp:90-102). The cov >= c*len
emission threshold reads a host-precomputed integer table thresh[len] =
min{cov : (float64)cov >= c * (float64)len}, bit-exact with the reference's
double compare (ReadAnalyzer.hpp:104).

Every kernel wrapper here takes the device of its tensors at its word: a
CUDA tensor launches the hand-written CUDA kernel (csrc/*.cu) or raises; a
CPU tensor runs the kernel's plain PyTorch version, which is also what the
CPU tests hold against shark_tpu and what chip_smoke.py holds the kernels
against on the card. The host-side table builders are numpy copies of
shark_tpu's, so both packages build identical tables.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from shark_tpu_torch import kernels
from shark_tpu_torch.index.structure import SharkIndex
from shark_tpu_torch.ops.kmers import INVALID, canonical_kmers_torch
from shark_tpu_torch.ops.xxh64 import shr64, xxh64_torch
from shark_tpu_torch.utils.timers import span

# Largest supported Bloom filter per device: word indices must fit int32.
MAX_SIZE_BITS = 1 << 36  # 8 GiB of bit-vector

# Gene-row capping (transcriptome scale). Rows are (deg, slot_0..slot_{D-1})
# uint16; a row whose true degree exceeds D keeps its first D-2 genes
# inline and stores a 32-bit extension-row index in its last two slots.
# D is the smallest power of two >= max degree whose table fits the byte
# budget; the cap + extension path engages ONLY when the budget forces it.
GENE_D_CHOICES = (8, 16, 32, 64)
GENE_MAT_BUDGET = 4 << 30  # primary row-table byte budget
EXT_MAX_W = 64  # extension-row width cap; reads past it recompute on host
EXT_CAP2 = 16  # max extension-escaping windows per read before host redo

# shark_tpu's batch-level compaction of deg>=3 row windows: a cost switch
# of its finish that changes no verdict. The CUDA finish builds only the
# valid keys of each read and has no use for it; the names stay so that
# both packages spell the same constants.
ROW_COMPACT_MIN_D = 8
ROW_CAP = 16

# Impure-read sub-batch widths of the group fast path (see
# finish_from_tags): a batch with at most FIX_CAP2 = min(B, max(FIX_CAP,
# B // FIX_DIV2)) impure row-hitting reads, FIX_CAP = min(B, max(64,
# B // FIX_DIV)), gives its pure reads GROUP verdicts; a heavier batch
# gives every read its full verdict. These tiers decide verdict bits, so
# they are shark_tpu's values exactly.
FIX_DIV = 64
FIX_DIV2 = 16

# Probe-result tags, shared by every probe front-end:
#   0 = miss; 1 = one gene (payload g); 2 = two genes (payload g0|g1<<16);
#   3 = degree>=3, payload = row index into the COMPACTED deg>=3 row table
TAG_D1 = 1
TAG_D2 = 2
TAG_ROW = 3

# Packed verdict layout (bits of one int32 per read).
PACK_GENE_BITS = 16            # winner gene id (uint16 capacity)
PACK_NW_SHIFT = 16
PACK_NW_BITS = 5               # n_winners, saturating at 31
PACK_EMIT_SHIFT = 21           # cov >= c*len flag
PACK_OVF_SHIFT = 22            # device result incomplete; host must redo
PACK_GRP_SHIFT = 23            # gene field holds a GROUP id (group_info);
#                                the host expands members via GeneGroups

# Sentinel padding of the compacted extra-winner pair stream.
PAIR_SENTINEL = 0xFFFFFFFF

# Keys in the plain finish that are no gene: sorts after every real key
_NO_KEY = 1 << 62


@dataclass(frozen=True)
class StaticMeta:
    """Compile-time parameters of the classify computation."""

    k: int
    size_bits: int
    n_genes: int
    degree: int  # FULL row geometry: gene slots per all-degrees row
    pos_bits: int  # bits reserved for the position in a sort key
    ext_w: int = 0  # extension-row width (0 = no rows overflow the cap)
    degree3: int = 1  # COMPACTED deg>=3 row geometry (rows3 tables)
    ext3_w: int = 0
    # > 0 when TAG_ROW payloads carry (gid << rows_bits) | rows3_index,
    # enabling the tie-heavy group fast path (group_info)
    rows_bits: int = 0

    @classmethod
    def for_index(
        cls, index: SharkIndex, max_len: int, allow_wide: bool = False
    ) -> "StaticMeta":
        """`allow_wide` is set by the sharded-BF path, whose (hi, lo) limb
        router (parallel.sharded_bf.shard_owner_local) lifts the int32
        front end's 2^36-bit ceiling; single-chip kernels keep the
        guard."""
        if index.size_bits > MAX_SIZE_BITS and not allow_wide:
            raise ValueError(
                "Bloom filter too large for single-device int32 addressing; "
                "use the sharded-BF mode"
            )
        pos_bits = max(1, int(np.ceil(np.log2(max(2, max_len)))))
        # +1: the group fast path scores deduped gene sets as one pseudo
        # gene id == n_genes, which must also fit the 31-bit sort keys
        if ((index.n_genes + 1) << pos_bits) >= (1 << 31):
            raise ValueError("n_genes * max_len exceeds 31-bit sort keys")
        degree, ext_w = index_geometry(index)
        degree3, ext3_w = index_geometry3(index)
        gi = group_info(index)
        return cls(
            k=index.k,
            size_bits=index.size_bits,
            n_genes=index.n_genes,
            degree=degree,
            pos_bits=pos_bits,
            ext_w=ext_w,
            degree3=degree3,
            ext3_w=ext3_w,
            rows_bits=gi[2] if gi is not None else 0,
        )



def row_geometry(deg: np.ndarray) -> Tuple[int, int]:
    """(inline gene slots D, extension width) from a degree histogram;
    powers of two to bound recompilation.

    D covers all but a <= 1e-4 TAIL of rows; tail rows keep D-2 genes
    inline and spill to the extension table. The tail exists in real
    indexes because two k-mers colliding on one Bloom position MERGE
    their gene lists (reference semantics, bloomfilter.h:61-75): an
    8-member family core colliding with anything becomes a deg 9+ row,
    and sizing D = pow2(max_deg) for those few rows doubles every row
    AND the finish sort width. The tail threshold is row-count-based
    (not sample-based) but safe: tail windows resolve through the exact
    device ext path (EXT_CAP2 per read), not host redo, so even a
    sample concentrated on tail rows only pays the small ext gather.
    Degrees common in the index (true families) always sit below the
    1e-4 boundary and stay inline."""
    return _row_geometry_impl(deg, tail_rule=True)


def row_geometry_full(deg: np.ndarray) -> Tuple[int, int]:
    """Geometry for paths that cannot reach an extension table at query
    time (the sharded-BF reply rows): D = pow2(max degree) up to the
    inline cap, ext only when a cap forces it (those rows
    host-recompute)."""
    return _row_geometry_impl(deg, tail_rule=False)


def _row_geometry_impl(deg: np.ndarray, tail_rule: bool) -> Tuple[int, int]:
    n_set = deg.size
    if n_set == 0:
        return 1, 0
    max_deg = int(deg.max())
    # hard inline cap: keys_from_gm unrolls D full [B, Ls] key lanes and a
    # ~D*Ls-wide finish sort, so D past GENE_D_CHOICES' ceiling is a
    # compile/HBM blowup (a 1000-member family would otherwise demand
    # D=1024). Degrees past the cap route through the extension table —
    # or, beyond ext_w/EXT_CAP2 (and always on the no-ext sharded path),
    # the exact host-recompute escape.
    D_full = min(
        1 << int(np.ceil(np.log2(max(1, max_deg)))), GENE_D_CHOICES[-1]
    )
    D = D_full
    if tail_rule:
        # floor of 32 rows: a real shared region (a ~300bp family core is
        # ~284 rows) always exceeds it and stays inline; isolated
        # collision-merged rows (a handful per index) fall under it and
        # take the ext path. A sub-32-row true repeat would ext-escape
        # too — exact either way, worst case a few host redos per batch.
        tail_budget = max(32, n_set // 10000)
        for cand in (4, 8, 16, 32, 64):
            if cand >= D_full:
                break
            if int(np.count_nonzero(deg > cand)) <= tail_budget:
                D = cand
                break
    # byte budget on the row table (transcriptome scale)
    while D > GENE_D_CHOICES[0] and n_set * (D + 1) * 2 > GENE_MAT_BUDGET:
        D >>= 1
    if D >= max_deg:
        return D, 0
    resid = max_deg - (D - 2)
    ext_w = 1 << int(np.ceil(np.log2(max(1, resid))))
    return D, min(ext_w, EXT_MAX_W)


def index_geometry(index: SharkIndex) -> Tuple[int, int]:
    """Cached FULL row geometry of an index (all set bits, no-ext rule;
    used by the sharded-BF path whose routed rows cover every degree).
    The histogram scan costs a pass over offsets; every consumer must
    agree on one answer."""
    geom = index.__dict__.get("_row_geometry")
    if geom is None:
        geom = row_geometry_full(np.diff(index.offsets))
        index.__dict__["_row_geometry"] = geom
    return geom


class GeneGroups(NamedTuple):
    """Deduped gene-SETS of the deg>=3 rows, CSR layout: members of group
    g are flat[offsets[g]:offsets[g+1]] (ascending gene ids, as stored).
    The host expands group verdicts through this instead of fetching (or
    recomputing) per-member winner lists."""

    offsets: np.ndarray  # int64[n_gids + 1]
    flat: np.ndarray  # uint16[total]

    @property
    def n_gids(self) -> int:
        return self.offsets.size - 1


def group_info(index: SharkIndex):
    """(gid int64[n_deg3_rows], GeneGroups, rows_bits) for the tie-heavy
    fast path, or None when the index cannot carry group ids.

    Many deg>=3 rows share one gene SET (a family's shared core is ~L-k+1
    rows with identical member lists, reference semantics: every core
    k-mer maps to the whole family, bloomfilter.h:61-75). A read whose
    hits are all rows of ONE set ties across exactly that set, so the
    kernel can score the set once as a pseudo-gene and the host expands
    members from here — instead of D3 full-width key lanes per window
    (the key redundancy of homolog panels).

    The TAG_ROW payload then carries (gid << rows_bits) | rows3_index.
    Returns None when the split doesn't fit 32 bits (transcriptome-scale
    row counts), or gids/genes exceed the packed 16-bit verdict field."""
    cached = index.__dict__.get("_group_info", "unset")
    if cached != "unset":
        return cached
    info = _group_info_impl(index)
    index.__dict__["_group_info"] = info
    return info


def _group_info_impl(index: SharkIndex):
    deg = np.diff(index.offsets).astype(np.int64)
    d3rows = np.flatnonzero(deg >= 3)
    n3 = d3rows.size
    if n3 == 0 or index.n_genes >= (1 << 16):
        return None
    rows_bits = max(1, int(np.ceil(np.log2(max(n3, 2)))))
    gid_cap = min(1 << (32 - rows_bits), 1 << 16)
    off = index.offsets[:-1].astype(np.int64)
    gene_ids = np.asarray(index.gene_ids)
    gid = np.empty(n3, np.int64)
    uniq_sets = []
    next_gid = 0
    for d in np.unique(deg[d3rows]):
        sel = np.flatnonzero(deg[d3rows] == d)
        rows = d3rows[sel]
        mat = gene_ids[off[rows][:, None] + np.arange(int(d))[None, :]]
        uniq, inv = np.unique(mat, axis=0, return_inverse=True)
        gid[sel] = next_gid + inv
        next_gid += uniq.shape[0]
        uniq_sets.append(uniq)
        if next_gid > gid_cap:
            return None
    offsets = np.concatenate(
        [[0]]
        + [np.full(u.shape[0], u.shape[1], np.int64) for u in uniq_sets]
    ).cumsum()
    flat = np.concatenate([u.reshape(-1) for u in uniq_sets]).astype(
        np.uint16
    )
    return gid, GeneGroups(offsets=offsets, flat=flat), rows_bits


def rows3_payload(index: SharkIndex) -> np.ndarray:
    """uint32 TAG_ROW payloads, one per deg>=3 set bit in CSR rank order:
    the compacted rows3 index, with (gid << rows_bits) OR'd in when the
    index carries group ids (group_info) — both probe front-ends
    (shark_tpu's build_pay and the hashed _entry_streams) must agree bit
    for bit."""
    deg = np.diff(index.offsets)
    n3 = int(np.count_nonzero(deg >= 3))
    ridx = np.arange(n3, dtype=np.uint32)
    gi = group_info(index)
    if gi is not None:
        gid, _, rows_bits = gi
        ridx |= gid.astype(np.uint32) << np.uint32(rows_bits)
    return ridx


def index_geometry3(index: SharkIndex) -> Tuple[int, int]:
    """Cached geometry of the COMPACTED deg>=3 row table (rows3). The
    single-chip kernels resolve deg<=2 probes inline from tag/payload
    words and gather wide rows only for deg>=3 k-mers, so the wide table
    holds just those rows — at transcriptome scale about 1% of set
    bits."""
    geom = index.__dict__.get("_row_geometry3")
    if geom is None:
        deg = np.diff(index.offsets)
        geom = row_geometry(deg[deg >= 3])
        index.__dict__["_row_geometry3"] = geom
    return geom


def emit_threshold_table(c: float, max_len: int) -> np.ndarray:
    """thresh[l] = smallest integer cov with (float64)cov >= c*l, matching
    the reference's double compare (ReadAnalyzer.hpp:104) exactly."""
    l = np.arange(max_len + 1, dtype=np.float64)
    # float64 ceil IS "smallest integer cov with cov >= c*l" (fuzz-verified
    # against the scalar float64 compare across random (c, l))
    return np.ceil(c * l).astype(np.int64).astype(np.int32)


def build_gene_rows(
    deg: np.ndarray,
    gene_flat: np.ndarray,
    ext: bool,
    geometry: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(degree, slots) rows from per-row degrees + concatenated gene lists.

    Rows with deg <= D hold all genes inline. When the index has rows past
    GENE_INLINE_CAP, overflow rows keep their first D-2 genes inline and
    slots D-2, D-1 hold the (lo, hi) halves of an index into the returned
    extension matrix, whose rows carry genes D-2..min(deg, D-2+ext_w)-1.
    `ext=False` (sharded shards: no extension table rides the all_to_all)
    leaves those slots zero — the kernel flags such reads for exact host
    recompute instead."""
    n_set = deg.size
    D, ext_w = geometry or row_geometry(deg)
    gene_mat = np.zeros((max(n_set, 1), D + 1), dtype=np.uint16)
    ext_mat = None
    if not n_set:
        return gene_mat, None
    offsets = np.concatenate([[0], np.cumsum(deg)])
    gene_mat[:, 0] = deg
    inline = np.minimum(deg, D) if ext_w == 0 else np.where(
        deg > D, D - 2, deg
    )
    rows = np.repeat(np.arange(n_set), inline)
    cols = _ragged_cols(inline)
    gene_mat[rows, cols + 1] = gene_flat[
        np.repeat(offsets[:-1], inline) + cols
    ]
    if ext_w:
        ovf = np.flatnonzero(deg > D)
        if ext and ovf.size:
            eidx = np.arange(ovf.size, dtype=np.uint32)
            gene_mat[ovf, D - 1] = (eidx & 0xFFFF).astype(np.uint16)
            gene_mat[ovf, D] = (eidx >> 16).astype(np.uint16)
            ext_mat = np.zeros((ovf.size, ext_w), dtype=np.uint16)
            take = np.minimum(deg[ovf] - (D - 2), ext_w)
            erows = np.repeat(np.arange(ovf.size), take)
            ecols = _ragged_cols(take)
            ext_mat[erows, ecols] = gene_flat[
                np.repeat(offsets[:-1][ovf] + (D - 2), take) + ecols
            ]
    return gene_mat, ext_mat


def _ragged_cols(counts: np.ndarray) -> np.ndarray:
    """[0..c0-1, 0..c1-1, ...] for per-row counts."""
    total = int(counts.sum())
    ends = np.cumsum(counts)
    return np.arange(total, dtype=np.int64) - np.repeat(
        ends - counts, counts
    )


def pack_rows_u32(gm16: np.ndarray) -> np.ndarray:
    """[n, F] u16 rows -> [n, ceil(F/2)] u32 (field 2j low half, 2j+1
    high half of word j), the rows3 layout the finish reads."""
    n, F = gm16.shape
    W = (F + 1) // 2
    padded = np.zeros((n, 2 * W), dtype=np.uint16)
    padded[:, :F] = gm16
    return (
        padded[:, 0::2].astype(np.uint32)
        | (padded[:, 1::2].astype(np.uint32) << 16)
    )


def build_rows3(
    index: SharkIndex, ext: bool = True
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Compacted (degree, slots) rows for deg>=3 set bits only (+ extension
    matrix), addressed by the tag-3 payload of shark_tpu's build_pay /
    build_hashed_index. Rows are PACKED two u16 fields per u32 word
    (pack_rows_u32)."""
    deg = np.diff(index.offsets).astype(np.int64)
    d3 = deg >= 3
    geometry = index_geometry3(index)
    if not d3.any():
        return pack_rows_u32(
            np.zeros((1, geometry[0] + 1), dtype=np.uint16)
        ), None
    gene_flat = np.asarray(index.gene_ids)[np.repeat(d3, deg)]
    gm16, ext_mat = build_gene_rows(
        deg[d3], gene_flat, ext, geometry=geometry
    )
    return pack_rows_u32(gm16), ext_mat


class DeviceIndex(NamedTuple):
    """The classic probe's tables (shark_tpu step.DeviceIndex)."""

    bf_rank: torch.Tensor  # u32[n_words, 2]: (Bloom word, rank before it)
    pay: torch.Tensor  # u32[max(n_set, 1), 2]: build_pay rows
    rows3: torch.Tensor  # u32[max(n_deg3, 1), ceil((D3+1)/2)] packed rows
    ext_mat: Optional[torch.Tensor] = None  # u16[n_ovf, ext3_w]


def build_pay(index: SharkIndex) -> np.ndarray:
    """uint32[max(n_set,1), 2] tag/payload rows, one per set bit in CSR
    rank order: word0 = tag<<30 | first_gene (tags 1/2), word1 = second
    gene (tag 2) or the row's index into the compacted rows3 table
    (tag 3)."""
    deg = np.diff(index.offsets).astype(np.int64)
    n_set = deg.size
    pay = np.zeros((max(n_set, 1), 2), dtype=np.uint32)
    if not n_set:
        return pay
    off = index.offsets[:-1].astype(np.int64)
    gene_ids = np.asarray(index.gene_ids)
    first_gene = gene_ids[np.minimum(off, max(gene_ids.size - 1, 0))].astype(
        np.uint32
    )
    tag = np.where(
        deg == 1, TAG_D1, np.where(deg == 2, TAG_D2, TAG_ROW)
    ).astype(np.uint32)
    d2 = deg == 2
    d3 = deg >= 3
    pay[:, 0] = (tag << 30) | np.where(d3, 0, first_gene)
    w1 = np.zeros(n_set, np.uint32)
    if d2.any():
        w1[d2] = gene_ids[off[d2] + 1].astype(np.uint32)
    if d3.any():
        w1[d3] = rows3_payload(index)  # rows3 index (+ gid bits)
    pay[:, 1] = w1
    return pay


def build_device_index(
    index: SharkIndex,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Host-side construction of the classic DeviceIndex arrays (numpy):
    (bf_rank, pay, rows3, ext_mat)."""
    n_words = index.bf_words.size
    bf_rank = np.empty((n_words, 2), dtype=np.uint32)
    bf_rank[:, 0] = index.bf_words
    bf_rank[:, 1] = index.word_rank
    pay = build_pay(index)
    rows3, ext_mat = build_rows3(index)
    return bf_rank, pay, rows3, ext_mat


def gather_u32(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows table[idx] of a u32 table, widened to int64 only after the
    gather (a GB-scale table is never copied whole). The gather runs on
    the int32 view, which every device indexes."""
    return table.view(torch.int32)[idx].to(torch.int64) & 0xFFFFFFFF


def to_device(a: Optional[np.ndarray], device, dtype=None):
    """A host table on `device` (None stays None)."""
    if a is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


# ---------------------------------------------------------------------------
# Device selection
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card (cuda:0) unless
    the caller names one. With no card and no explicit request this
    raises; it never carries on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "shark_tpu_torch runs on a CUDA device and none is available; "
            "ask for the CPU explicitly (device='cpu', or --backend cpu on "
            "the command line) to run the plain PyTorch versions"
        )
    return torch.device("cuda", 0)


# ---------------------------------------------------------------------------
# K1: the front end
# ---------------------------------------------------------------------------


def _mod_size_params(size_bits: int) -> Tuple[int, int]:
    """(mode, argument) of hash % size for the size's form, shared by the
    kernel and the plain version (shark_tpu step._mod_size). The CLI sizes
    are multiples of 2**33 bits (argument_parser.hpp:133), so size =
    m * 2**32 and hash % size = (hi % m) * 2**32 + lo; power-of-two sizes
    reduce to a mask."""
    if size_bits & (size_bits - 1) == 0:
        if size_bits <= (1 << 32):
            return 0, (size_bits - 1 if size_bits < (1 << 32) else 0xFFFFFFFF)
        return 1, (size_bits >> 32) - 1
    if size_bits % (1 << 32) == 0:
        return 2, size_bits >> 32
    raise ValueError(
        "Bloom size must be a power of two or a multiple of 2**32 bits"
    )


def _fastmod_magic(d: int) -> int:
    """The 64-bit magic number with which the front end kernel reduces a
    32-bit hash word modulo d (1 <= d < 2**32), mod_mode 2:
    a % d == ((magic * a mod 2**64) * d) >> 64 for every 32-bit a
    (Lemire, Kaser and Kurz, "Faster remainder by direct computation",
    2019). For d = 1 the magic wraps to 0, which gives 0."""
    return (((1 << 64) - 1) // d + 1) & ((1 << 64) - 1)


def _mod_size(h: torch.Tensor, size_bits: int):
    """u64 hash bits (int64) -> (idx_hi, idx_lo) as int64 in [0, 2**32)."""
    mode, arg = _mod_size_params(size_bits)
    hi = shr64(h, 32)
    lo = h & 0xFFFFFFFF
    if mode == 0:
        return torch.zeros_like(hi), lo & arg
    if mode == 1:
        return hi & arg, lo
    return hi % arg, lo


def unpack_codes(packed: torch.Tensor, vmask: torch.Tensor) -> torch.Tensor:
    """(2-bit codes u8[B, L/4], validity bits u8[B, L/8]) -> byte codes
    u8[B, L]. PLANAR layout: byte j of a packed row holds the bases at
    positions j, j+L/4, j+2L/4, j+3L/4 (one 2-bit plane per position
    quarter), and likewise 8 planes for the validity bits."""
    c = torch.cat([(packed >> (2 * r)) & 3 for r in range(4)], dim=1)
    v = torch.cat([(vmask >> r) & 1 for r in range(8)], dim=1)
    return torch.where(v == 1, c, torch.full_like(c, INVALID))


def planar(codes, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 [B, L] byte codes -> pack_codes' (packed, vmask) on `device`,
    L padded with invalid bases to a multiple of 8 for the planar packing
    (no verdict changes: window positions, lengths and thresholds are the
    unpadded read's)."""
    codes = torch.as_tensor(codes).to(device)
    B, L = codes.shape
    if L % 8:
        pad = torch.full((B, 8 - L % 8), INVALID, dtype=torch.uint8,
                         device=device)
        codes = torch.cat([codes, pad], dim=1)
    return pack_codes(codes)


def pack_codes(codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Byte codes u8[B, L] (L % 8 == 0) -> the planar (packed, vmask) pair
    that unpack_codes inverts."""
    B, L = codes.shape
    if L % 8:
        raise ValueError(f"planar packing needs L % 8 == 0 (L = {L})")
    valid = codes < INVALID
    c = torch.where(valid, codes, torch.zeros_like(codes)).view(B, 4, L // 4)
    v = valid.to(torch.uint8).view(B, 8, L // 8)
    packed = torch.zeros((B, L // 4), dtype=torch.uint8, device=codes.device)
    vmask = torch.zeros((B, L // 8), dtype=torch.uint8, device=codes.device)
    for r in range(4):
        packed |= c[:, r] << (2 * r)
    for r in range(8):
        vmask |= v[:, r] << r
    return packed, vmask


def bloom_positions(codes: torch.Tensor, meta: "StaticMeta"):
    """codes u8[B, L] -> (idx_hi u32[B, Ls], idx_lo u32[B, Ls], win_valid
    bool[B, Ls]) with Ls = L - min(k-1, L-1): column j addresses the window
    ending at position j + min(k-1, L-1). Plain version of the front end
    (shark_tpu step.bloom_positions)."""
    k = meta.k
    canon, win_valid = canonical_kmers_torch(codes, k)
    s = min(k - 1, codes.shape[1] - 1)
    hi, lo = _mod_size(xxh64_torch(canon[:, s:]), meta.size_bits)
    return hi.to(torch.uint32), lo.to(torch.uint32), win_valid[:, s:]


def front_end_plain(packed: torch.Tensor, vmask: torch.Tensor, meta):
    codes = unpack_codes(packed, vmask)
    idx_hi, idx_lo, win_valid = bloom_positions(codes, meta)
    length = (codes < INVALID).sum(dim=1, dtype=torch.int32)
    return idx_hi, idx_lo, win_valid, length


def front_end(packed: torch.Tensor, vmask: torch.Tensor, meta: "StaticMeta"):
    """K1: planar reads (u8[B, L/4], u8[B, L/8]) -> (idx_hi u32[B, Ls],
    idx_lo u32[B, Ls], win_valid bool[B, Ls], length i32[B]).
    CUDA tensors run csrc/front.cu (reads over 16384 bases through its
    long-read kernel); CPU tensors the plain version."""
    B, L4 = packed.shape
    L = 4 * L4
    if vmask.shape != (B, L // 8):
        raise ValueError(f"vmask shape {tuple(vmask.shape)} != {(B, L // 8)}")
    if not packed.is_cuda:
        return front_end_plain(packed, vmask, meta)
    if L % 8 or L < 8:
        raise ValueError(
            f"the front end kernel takes L >= 8, L % 8 == 0 (L = {L})")
    dev = packed.device
    kernels.require(packed, "packed", torch.uint8, 2, dev)
    kernels.require(vmask, "vmask", torch.uint8, 2, dev)
    mode, arg = _mod_size_params(meta.size_bits)
    magic = _fastmod_magic(arg) if mode == 2 else 0
    Ls = L - min(meta.k - 1, L - 1)
    # the four outputs are views of one allocation
    n = B * Ls
    words = torch.empty((2 * n + B + (n + 3) // 4,), dtype=torch.int32,
                        device=dev)
    idx_hi = words[:n].view(torch.uint32).view(B, Ls)
    idx_lo = words[n: 2 * n].view(torch.uint32).view(B, Ls)
    length = words[2 * n: 2 * n + B]
    win_valid = words[2 * n + B:].view(torch.bool)[:n].view(B, Ls)
    lib = kernels.lib()
    rc = lib.shkk_front(
        packed.data_ptr(), vmask.data_ptr(), B, L, meta.k, mode, arg, magic,
        idx_hi.data_ptr(), idx_lo.data_ptr(), win_valid.data_ptr(),
        length.data_ptr(), kernels.stream(dev),
    )
    kernels.check(rc, "front")
    kernels.LAUNCHES.add("front")
    return idx_hi, idx_lo, win_valid, length


# ---------------------------------------------------------------------------
# K3: the finish
# ---------------------------------------------------------------------------


def _score_keys(key_mat, n_genes, length, thresh, row_ovf, *, k, W, L, pb):
    """Plain finish_from_keys: int64 keys [B, K] (gene << pb | pos; a key
    whose gene is >= n_genes is no key) -> (packed, winners, best_cov)."""
    B = key_mat.shape[0]
    dev = key_mat.device
    if key_mat.shape[1] == 0:
        key_mat = torch.full((B, 1), _NO_KEY, dtype=torch.int64, device=dev)
    skey = torch.sort(key_mat, dim=1).values
    gene = skey >> pb
    pos = skey & ((1 << pb) - 1)
    valid = gene < n_genes
    edge = lambda v: torch.full((B, 1), v, dtype=torch.int64, device=dev)
    prev_gene = torch.cat([edge(-1), gene[:, :-1]], dim=1)
    prev_pos = torch.cat([edge(0), pos[:, :-1]], dim=1)
    next_gene = torch.cat([gene[:, 1:], edge(-2)], dim=1)
    seg_start = valid & (gene != prev_gene)
    seg_end = valid & (gene != next_gene)
    zero = torch.zeros_like(skey)
    contrib = torch.where(
        valid,
        torch.where(seg_start, torch.full_like(skey, k),
                    torch.clamp(pos - prev_pos, max=k)),
        zero,
    )
    ones = valid.to(torch.int64)

    def seg_sum(x):
        csum = torch.cumsum(x, dim=1)
        base = torch.cummax(torch.where(seg_start, csum - x, zero), dim=1)
        return csum - base.values

    M = L + 1
    combined = torch.where(seg_end, seg_sum(contrib) * M + seg_sum(ones), zero)
    best = combined.max(dim=1).values
    winner = seg_end & (combined == best[:, None]) & (best[:, None] > 0)
    n_winners = winner.sum(dim=1)
    wkey = torch.where(winner, gene, torch.full_like(gene, _NO_KEY))
    swin = torch.sort(wkey, dim=1).values[:, :W]
    if swin.shape[1] < W:
        swin = torch.cat(
            [swin, torch.full((B, W - swin.shape[1]), _NO_KEY,
                              dtype=torch.int64, device=dev)], dim=1)
    winners = torch.where(swin != _NO_KEY, swin, torch.full_like(swin, -1))
    best_cov = best // M
    th = thresh.to(torch.int64)[torch.clamp(length.to(torch.int64), 0, L)]
    emit = (best_cov >= th).to(torch.int64)
    nw_sat = torch.clamp(n_winners, max=(1 << PACK_NW_BITS) - 1)
    packed = (
        torch.clamp(winners[:, 0], min=0)
        | (nw_sat << PACK_NW_SHIFT)
        | (emit << PACK_EMIT_SHIFT)
        | (row_ovf.to(torch.int64) << PACK_OVF_SHIFT)
    )
    return (packed.to(torch.int32), winners.to(torch.int32),
            best_cov.to(torch.int32))


def fix_caps(B: int) -> Tuple[int, int]:
    """(FIX_CAP, FIX_CAP2) of a batch of B reads (shark_tpu step.py:1043)."""
    fix_cap = min(B, max(64, B // FIX_DIV))
    return fix_cap, min(B, max(fix_cap, B // FIX_DIV2))


def finish_from_tags_plain(tagv, payv, length, thresh, *, rows3, ext_mat,
                           meta, max_winners, L, has_rows, n_fix=None,
                           fix_cap2=None):
    """Plain version of the finish, in int64. Every read gets its full
    verdict (direct keys, rows3 genes, extension genes); then, when the
    index carries group ids and the batch has at most FIX_CAP2 impure
    row-hitting reads, pure reads get their GROUP verdict instead. That
    is the verdict every branch of shark_tpu's finish_from_tags gives
    (its row-free, compact-row and sub-batch branches only change cost).
    `n_fix`, `fix_cap2`: the whole batch's count and cap when these reads
    are one part of it (finish_group_count)."""
    B, Ls = tagv.shape
    dev = tagv.device
    t = tagv.to(torch.int64)
    p = payv.to(torch.int64)
    pb = meta.pos_bits
    pos = (torch.arange(Ls, device=dev, dtype=torch.int64) + (L - Ls))
    pos = pos[None, :].expand(B, Ls)
    none = torch.full_like(t, _NO_KEY)
    direct = (t == TAG_D1) | (t == TAG_D2)
    keys = [
        torch.where(direct, ((p & 0xFFFF) << pb) | pos, none),
        torch.where(t == TAG_D2, ((p >> 16) << pb) | pos, none),
    ]
    row_ovf = torch.zeros((B,), dtype=torch.bool, device=dev)
    rb = meta.rows_bits
    is_row = (t == TAG_ROW) if has_rows else torch.zeros_like(direct)
    if has_rows:
        D, ext_w = meta.degree3, meta.ext3_w
        r3 = rows3.to(torch.int64)
        ridx = torch.where(is_row, p & ((1 << rb) - 1) if rb else p,
                           torch.zeros_like(p))
        rw = r3[torch.clamp(ridx, max=r3.shape[0] - 1)]  # [B, Ls, W3]

        def field(rows, i):
            w = rows[..., i >> 1]
            return (w >> 16) if (i & 1) else (w & 0xFFFF)

        deg = torch.where(is_row, field(rw, 0), torch.zeros_like(p))
        over = deg > D
        for d in range(D):
            ok = is_row & (deg > d)
            if ext_w and d >= D - 2:
                ok &= ~over
            keys.append(torch.where(ok, (field(rw, 1 + d) << pb) | pos, none))
        if ext_w:
            needy = is_row & over
            if ext_mat is None:
                row_ovf = needy.any(dim=1)
            else:
                cap2 = min(EXT_CAP2, Ls)
                col = torch.arange(Ls, device=dev).expand(B, Ls)
                scol_s = torch.sort(
                    torch.where(needy, col, torch.full_like(col, Ls)), dim=1
                ).values[:, :cap2]
                svalid = scol_s < Ls
                scol = torch.clamp(scol_s, max=Ls - 1)
                rw2 = torch.gather(
                    rw, 1, scol[..., None].expand(B, cap2, rw.shape[2])
                )
                erow = field(rw2, D - 1) | (field(rw2, D) << 16)
                em = ext_mat.to(torch.int64)
                eg = em[torch.where(svalid, erow, torch.zeros_like(erow))]
                resid = torch.where(svalid, field(rw2, 0) - (D - 2),
                                    torch.zeros_like(erow))
                spos = torch.gather(pos, 1, scol)
                for d in range(ext_w):
                    keys.append(torch.where(
                        svalid & (resid > d), (eg[..., d] << pb) | spos,
                        torch.full_like(spos, _NO_KEY)))
                row_ovf = (needy.sum(dim=1) > EXT_CAP2) | (
                    needy & (deg - (D - 2) > ext_w)).any(dim=1)
    score = dict(k=meta.k, W=max_winners, L=L, pb=pb)
    packed, winners, best_cov = _score_keys(
        torch.cat(keys, dim=1), meta.n_genes, length, thresh, row_ovf,
        **score)
    grp, gmax = _group_reads(t, p, has_rows, rb, n_fix, fix_cap2)
    if bool(grp.any()):
        sel = torch.nonzero(grp).flatten()
        gkeys = torch.where(is_row[sel],
                            (meta.n_genes << pb) | pos[sel], none[sel])
        gp, gw, gc = _score_keys(
            gkeys, meta.n_genes + 1, length[sel], thresh,
            row_ovf[sel], **score)
        emit = (gp >> PACK_EMIT_SHIFT) & 1
        packed[sel] = (
            torch.clamp(gmax[sel], min=0).to(torch.int32)
            | (1 << PACK_NW_SHIFT) | (emit << PACK_EMIT_SHIFT)
            | (1 << PACK_GRP_SHIFT))
        winners[sel] = gw
        best_cov[sel] = gc
    return packed, winners, best_cov, length


def _group_reads(t, p, has_rows, rb, n_fix=None, fix_cap2=None):
    """(bool[B]: the pure reads that take their GROUP verdict, int64[B]:
    each read's largest group id over its row windows, or -1) of int64 tags
    and payloads. Group verdicts need group ids in the payloads (rb > 0)
    and a batch with at most FIX_CAP2 impure row-hitting reads. `n_fix`
    (a one-element tensor) and `fix_cap2`: that count and that cap of the
    whole batch when these rows are one part of it; by default the rows'
    own."""
    B = t.shape[0]
    if not (has_rows and rb):
        return torch.zeros((B,), dtype=torch.bool, device=t.device), None
    pure, gmax, need_fix = _group_flags(t, p, rb)
    count = int(need_fix.sum()) if n_fix is None else int(n_fix.sum())
    if count > (fix_caps(B)[1] if fix_cap2 is None else fix_cap2):
        pure = torch.zeros_like(pure)
    return pure, gmax


def _group_flags(t, p, rb):
    """(pure, largest group id, impure row-hitting) per read: the group
    pass of the finish."""
    is_row = t == TAG_ROW
    direct = (t == TAG_D1) | (t == TAG_D2)
    gid = p >> rb
    gmax = torch.where(is_row, gid, torch.full_like(gid, -1)).max(dim=1).values
    gmin = torch.where(is_row, gid, torch.full_like(gid, 0x7FFFFFFF))
    any_row = is_row.any(dim=1)
    pure = any_row & ~direct.any(dim=1) & (gmax == gmin.min(dim=1).values)
    return pure, gmax, any_row & ~pure


# Keys a read may have on the CUDA finish's warp path (csrc/finish.cu
# kWarpCap); a read with more takes the block path.
FINISH_WARP_CAP = 256


def finish_heavy_reads_plain(tagv, payv, *, rows3, ext_mat, meta, L,
                             has_rows):
    """bool[B]: the reads that the CUDA finish hands to its block path.
    A read goes there when it has more than FINISH_WARP_CAP keys (direct
    genes, the inline genes of its rows, or one pseudo-gene key per row
    window when it takes its group verdict), or when, without that group
    verdict, one of its rows is past the inline width and the index has an
    extension table. The verdicts are the same on either path; this is
    what the card tests and chip_smoke.py hold the kernel's count to."""
    t = tagv.to(torch.int64)
    p = payv.to(torch.int64)
    nk = ((t == TAG_D1) | (t == TAG_D2)).sum(dim=1) + (t == TAG_D2).sum(dim=1)
    if not has_rows:
        return nk > FINISH_WARP_CAP
    D = meta.degree3
    rb = meta.rows_bits
    is_row = t == TAG_ROW
    r3 = rows3.to(torch.int64)
    ridx = torch.clamp(p & ((1 << rb) - 1) if rb else p, max=r3.shape[0] - 1)
    deg = torch.where(is_row, r3[torch.where(is_row, ridx, 0), 0] & 0xFFFF, 0)
    if ext_mat is not None and meta.ext3_w > 0:
        needy = (is_row & (deg > D)).any(dim=1)
        inline = torch.where(deg > D, 0, deg)
    else:
        needy = torch.zeros_like(is_row[:, 0])
        inline = torch.clamp(deg, max=D)
    grp, _ = _group_reads(t, p, has_rows, rb)
    nk = nk + torch.where(grp, is_row.sum(dim=1), inline.sum(dim=1))
    return (nk > FINISH_WARP_CAP) | (needy & ~grp)


_FINISH_STATE = threading.local()


def finish_heavy_count() -> int:
    """The number of reads that the calling thread's last CUDA finish sent
    to its block path (synchronises with the card)."""
    return int(_FINISH_STATE.work[1])


def finish_from_tags(
    tagv: torch.Tensor,  # u32[B, Ls]: 0 miss / TAG_D1 / TAG_D2 / TAG_ROW
    payv: torch.Tensor,  # u32[B, Ls]: genes or rows3 index (see TAG_*)
    length: torch.Tensor,  # i32[B]
    thresh: torch.Tensor,  # i32[L+1]
    *,
    rows3: torch.Tensor,  # u32[max(n_deg3,1), ceil((D3+1)/2)] packed rows
    ext_mat: Optional[torch.Tensor],  # u16[n_ovf, ext3_w]
    meta: "StaticMeta",
    max_winners: int,
    L: int,
    has_rows: bool,
    n_fix: Optional[torch.Tensor] = None,
    fix_cap2: Optional[int] = None,
):
    """K3: (tag, payload) per window -> (packed i32[B], winners i32[B, W],
    best_cov i32[B], length i32[B]). CUDA tensors run csrc/finish.cu (a
    batch-wide group pass, one warp per read, then a block per read too
    heavy for a warp); CPU tensors the plain version. For one part of a
    batch split over devices, `n_fix` (i32[1] on this device: the whole
    batch's impure row-hitting reads, summed by finish_group_count) and
    `fix_cap2` (the whole batch's FIX_CAP2) give the part the batch's
    group choice."""
    if not tagv.is_cuda:
        return finish_from_tags_plain(
            tagv, payv, length, thresh, rows3=rows3, ext_mat=ext_mat,
            meta=meta, max_winners=max_winners, L=L, has_rows=has_rows,
            n_fix=n_fix, fix_cap2=fix_cap2)
    dev = tagv.device
    B, Ls = tagv.shape
    W = max_winners
    for name, x, dt, nd in (
        ("tagv", tagv, torch.uint32, 2), ("payv", payv, torch.uint32, 2),
        ("length", length, torch.int32, 1), ("thresh", thresh, torch.int32, 1),
        ("rows3", rows3, torch.uint32, 2),
    ):
        kernels.require(x, name, dt, nd, dev)
    if payv.shape != (B, Ls) or length.shape != (B,) or thresh.shape != (L + 1,):
        raise ValueError("finish_from_tags: inconsistent input shapes")
    D, ext_w = meta.degree3, meta.ext3_w
    if has_rows and rows3.shape[1] < (D + 2) // 2:
        raise ValueError("rows3 narrower than the index geometry")
    if ext_mat is not None:
        kernels.require(ext_mat, "ext_mat", torch.uint16, 2, dev)
        if ext_mat.shape[1] != ext_w:
            raise ValueError("ext_mat width != ext3_w")
    if n_fix is not None:
        kernels.require(n_fix, "n_fix", torch.int32, 1, dev)
        if n_fix.numel() != 1:
            raise ValueError("n_fix must hold one count")
    # the outputs are views of one allocation, and so is the kernel's
    # work, at these int32 offsets: its counters (n_fix of the group pass,
    # the block path's list length; zeroed by the kernel's entry point) at
    # 0, the list at 2, each read's largest group id at B + 2 and its group
    # flags (bytes) at 2B + 2
    out = torch.empty((B * (W + 2),), dtype=torch.int32, device=dev)
    packed, best_cov = out[:B], out[B: 2 * B]
    winners = out[2 * B:].view(B, W)
    work = torch.empty((2 + 2 * B + (B + 3) // 4,), dtype=torch.int32,
                       device=dev)
    counters = work.data_ptr()
    groups = bool(has_rows and meta.rows_bits)
    # keys of one block-path read: <= max(D, 2) per window plus the
    # extension genes, and at least the 256 keys its warps sort at a time
    has_ext = has_rows and ext_mat is not None and ext_w > 0
    kmax = max(D if has_rows else 0, 2) * Ls + (EXT_CAP2 * ext_w if has_ext else 0)
    key_cap = max(_FINISH_CHUNK, 1 << max(0, (kmax - 1).bit_length()))
    # the block path's grid (the kernel trims it to what fits on the card)
    grid = B
    scratch = None
    if key_cap * 8 > _FINISH_SMEM_MAX:
        # wide geometries: keys in a global scratch slice per block, with
        # a grid of a few blocks per SM looping over the list
        grid = min(B, _FINISH_SCRATCH_GRID)
        scratch = torch.empty((grid, 2 * key_cap), dtype=torch.uint32,
                              device=dev)
    rc = kernels.lib().shkk_finish(
        tagv.data_ptr(), payv.data_ptr(), length.data_ptr(),
        thresh.data_ptr(), rows3.data_ptr(), rows3.shape[0], rows3.shape[1],
        D, kernels.ptr(ext_mat if has_ext else None), ext_w if has_ext else 0,
        B, Ls, L, meta.k, meta.pos_bits, meta.n_genes, meta.rows_bits, W,
        int(has_rows), int(groups), counters + 4 * (2 * B + 2),
        counters + 4 * (B + 2), counters,
        fix_caps(B)[1] if fix_cap2 is None else fix_cap2,
        kernels.ptr(n_fix), key_cap, grid,
        kernels.ptr(scratch), counters + 8, packed.data_ptr(),
        winners.data_ptr(), best_cov.data_ptr(), kernels.stream(dev))
    kernels.check(rc, "finish")
    kernels.LAUNCHES.add("finish")
    _FINISH_STATE.work = work
    return packed, winners, best_cov, length


def finish_group_count(tagv: torch.Tensor, payv: torch.Tensor,
                       n_fix: torch.Tensor, *, meta: "StaticMeta",
                       has_rows: bool) -> None:
    """K3's group pass alone, for one part of a batch split over devices:
    adds the part's impure row-hitting reads to `n_fix` (i32[1] on this
    device, zeroed once for the whole batch). Nothing to count when the
    index has no group ids. CUDA tensors run csrc/finish.cu's group pass;
    CPU tensors the plain one."""
    if not (has_rows and meta.rows_bits):
        return
    if not tagv.is_cuda:
        _, _, need_fix = _group_flags(tagv.to(torch.int64),
                                      payv.to(torch.int64), meta.rows_bits)
        n_fix += need_fix.sum().to(torch.int32)
        return
    dev = tagv.device
    for name, x, dt, nd in (
        ("tagv", tagv, torch.uint32, 2), ("payv", payv, torch.uint32, 2),
        ("n_fix", n_fix, torch.int32, 1),
    ):
        kernels.require(x, name, dt, nd, dev)
    B, Ls = tagv.shape
    if payv.shape != (B, Ls) or n_fix.numel() != 1:
        raise ValueError("finish_group_count: inconsistent input shapes")
    # the pass's per-read flags (bytes) and largest group ids, unused here
    work = torch.empty((B + (B + 3) // 4,), dtype=torch.int32, device=dev)
    rc = kernels.lib().shkk_finish_count(
        tagv.data_ptr(), payv.data_ptr(), B, Ls, meta.rows_bits,
        work.data_ptr() + 4 * B, work.data_ptr(), n_fix.data_ptr(),
        kernels.stream(dev))
    kernels.check(rc, "finish_count")
    kernels.LAUNCHES.add("finish")


# shared memory the block path's keys may take per block (keys + scores,
# 8 bytes a key), the grid of its global-scratch mode, and the keys each of
# its warps sorts in registers (csrc/finish.cu kChunk)
_FINISH_SMEM_MAX = 96 * 1024
_FINISH_SCRATCH_GRID = 1056
_FINISH_CHUNK = 256


# ---------------------------------------------------------------------------
# K4: the winner-pair stream
# ---------------------------------------------------------------------------


def _pairs_check(winners: torch.Tensor) -> None:
    if winners.shape[0] > 65536:
        # the read index rides the key's high 16 bits; a larger batch
        # would alias read 65536 onto read 0
        raise ValueError("extract_pairs requires batch size <= 65536")


def extract_pairs_plain(packed: torch.Tensor, winners: torch.Tensor, cap: int):
    _pairs_check(winners)
    B, W = winners.shape
    p = packed.to(torch.int64)
    nw = (p >> PACK_NW_SHIFT) & ((1 << PACK_NW_BITS) - 1)
    emit = ((p >> PACK_EMIT_SHIFT) & 1) == 1
    ovf = ((p >> PACK_OVF_SHIFT) & 1) == 1
    grp = ((p >> PACK_GRP_SHIFT) & 1) == 1
    sat = (1 << PACK_NW_BITS) - 1
    need = emit & (nw >= 1) & (nw <= W) & (nw < sat) & ~ovf & ~grp
    slot = torch.arange(W, device=packed.device)[None, :]
    valid = need[:, None] & (slot < nw[:, None])
    row = torch.arange(B, device=packed.device, dtype=torch.int64)[:, None]
    key = (row << 16) | (winners.to(torch.int64) & 0xFFFFFFFF)
    keys = torch.where(valid, key, torch.full_like(key, PAIR_SENTINEL))
    out = torch.sort(keys.reshape(-1)).values
    return out[: min(cap, out.shape[0])].to(torch.uint32)


def extract_pairs(packed: torch.Tensor, winners: torch.Tensor, cap: int):
    """K4: every winner of each emitted read (1 <= nw <= W, nw < 31, not
    overflowed, not a group verdict) as one ascending u32 (row << 16 |
    gene) stream, 0xFFFFFFFF padded, min(cap, B*W) long (shark_tpu
    step.extract_pairs). The pair (row 65535, gene 65535) encodes to the
    sentinel itself; callers slice by the exact pair count, so that stays
    exact. CUDA tensors run csrc/pairs.cu; CPU tensors the plain sort."""
    _pairs_check(winners)
    if not packed.is_cuda:
        return extract_pairs_plain(packed, winners, cap)
    dev = packed.device
    B, W = winners.shape
    kernels.require(packed, "packed", torch.int32, 1, dev)
    kernels.require(winners, "winners", torch.int32, 2, dev)
    if packed.shape[0] != B:
        raise ValueError("packed and winners disagree on the batch size")
    out_len = min(cap, B * W)
    out = torch.empty((out_len,), dtype=torch.uint32, device=dev)
    rc = kernels.lib().shkk_pairs(
        packed.data_ptr(), winners.data_ptr(), B, W, out.data_ptr(),
        out_len, kernels.stream(dev))
    kernels.check(rc, "pairs")
    kernels.LAUNCHES.add("pairs")
    return out


# ---------------------------------------------------------------------------
# K5: the classic probe
# ---------------------------------------------------------------------------


def require_windows(idx_hi, idx_lo, win_valid) -> torch.device:
    """Validate a probe kernel's window inputs (K1's outputs); returns
    their device."""
    dev = idx_lo.device
    kernels.require(idx_hi, "idx_hi", torch.uint32, idx_lo.dim(), dev)
    kernels.require(idx_lo, "idx_lo", torch.uint32, idx_lo.dim(), dev)
    kernels.require(win_valid, "win_valid", torch.bool, idx_lo.dim(), dev)
    return dev


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values in [0, 2**32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def probe_rank_plain(bf_rank, word_idx, bit_off, win_valid):
    """Bloom membership and exact CSR rank from one (word, rank) row per
    window, in int64 (shark_tpu step.probe_rank). Returns (rank, hit);
    rank is 0 where there is no hit."""
    wr = gather_u32(bf_rank, word_idx)
    w = wr[..., 0]
    hit = (((w >> bit_off) & 1) == 1) & win_valid
    low = (torch.ones_like(bit_off) << bit_off) - 1
    rank = (wr[..., 1] + _popcount32(w & low)) & 0xFFFFFFFF
    return torch.where(hit, rank, torch.zeros_like(rank)), hit


def decode_pay_words(w0: torch.Tensor, w1: torch.Tensor):
    """(tag, payload) of a build_pay row's two words, as int64 (shark_tpu
    step.decode_pay_words). Zeroed words decode to tag 0 = miss."""
    tagv = w0 >> 30
    payv = torch.where(
        tagv == TAG_ROW, w1, (w0 & 0xFFFF) | ((w1 & 0xFFFF) << 16)
    )
    return tagv, payv


def probe_tags_plain(idx_hi, idx_lo, win_valid, bf_rank, pay):
    """Plain version of K5 (shark_tpu step.probe_tags on the word/bit
    addresses of hash_positions). A miss reads pay row 0 and zeroes only
    its first word, so its payload is (pay[0, 1] & 0xFFFF) << 16, as in
    shark_tpu."""
    lo = idx_lo.to(torch.int64)
    word_idx = (idx_hi.to(torch.int64) << 27) | (lo >> 5)
    rank, hit = probe_rank_plain(bf_rank, word_idx, lo & 31, win_valid)
    pw = gather_u32(pay, rank)
    w0 = torch.where(hit, pw[..., 0], torch.zeros_like(rank))
    tagv, payv = decode_pay_words(w0, pw[..., 1])
    return tagv.to(torch.uint32), payv.to(torch.uint32)


def probe_tags(
    idx_hi: torch.Tensor,  # u32[B, Ls]
    idx_lo: torch.Tensor,  # u32[B, Ls]
    win_valid: torch.Tensor,  # bool[B, Ls]
    bf_rank: torch.Tensor,  # u32[n_words, 2]
    pay: torch.Tensor,  # u32[max(n_set, 1), 2]
):
    """K5, the classic probe: Bloom positions -> (tagv u32[B, Ls], payv
    u32[B, Ls]) through a (word, rank) row and a pay row per window. CUDA
    tensors run csrc/classic.cu; CPU tensors the plain version."""
    if not idx_lo.is_cuda:
        return probe_tags_plain(idx_hi, idx_lo, win_valid, bf_rank, pay)
    dev = require_windows(idx_hi, idx_lo, win_valid)
    for name, t in (("bf_rank", bf_rank), ("pay", pay)):
        kernels.require(t, name, torch.uint32, 2, dev)
        if t.shape[1] != 2:
            raise ValueError(f"{name} shape {tuple(t.shape)}")
    tagv = torch.empty_like(idx_lo)
    payv = torch.empty_like(idx_lo)
    rc = kernels.lib().shkk_classic(
        idx_hi.data_ptr(), idx_lo.data_ptr(), win_valid.data_ptr(),
        idx_lo.numel(), bf_rank.data_ptr(), pay.data_ptr(), tagv.data_ptr(),
        payv.data_ptr(), kernels.stream(dev))
    kernels.check(rc, "classic")
    kernels.LAUNCHES.add("classic")
    return tagv, payv


# ---------------------------------------------------------------------------
# The classifier
# ---------------------------------------------------------------------------


class Classifier:
    """Holds the device-resident index tables and runs the classify step.

    Probe-path selection (`probe`), shark_tpu's rule: None (auto) uses the
    hashed bucket table (classify/hashed.py) when it builds within its
    table and stash budgets (gene panels), else the xl layout (16-byte
    buckets with a spill side table, transcriptome scale), else the classic
    two-load probe (K5). "hashed" tries hashed, then xl; "xl" forces xl;
    "classic" forces classic. A forced layout that cannot be built raises
    ValueError. `self.probe` names the layout taken."""

    def __init__(
        self,
        index: SharkIndex,
        max_winners: int = 16,
        c: float = 0.6,
        device=None,
        probe: Optional[str] = None,
        probe_opts: Optional[dict] = None,
    ):
        """`device`: None = the CUDA card (raises without one), or e.g.
        "cpu" for the plain PyTorch versions. `probe_opts`: "threads" (host
        table-build parallelism), "cache_dir" (on-disk packed-table cache,
        classify/table_cache.py) and, with probe="xl" only, "lgB" and
        "side_lgB" (pinned xl table geometries)."""
        from shark_tpu_torch.classify import hashed

        if probe not in (None, "hashed", "xl", "classic"):
            raise ValueError(f"unknown probe {probe!r}")
        opts = dict(probe_opts or {})
        build_threads = opts.pop("threads", None)
        xl_lgB = opts.pop("lgB", None)
        xl_side_lgB = opts.pop("side_lgB", None)
        cache_dir = opts.pop("cache_dir", None)
        if opts:
            raise ValueError(f"unknown probe_opts: {sorted(opts)}")
        if (xl_lgB is not None or xl_side_lgB is not None) and probe != "xl":
            raise ValueError("lgB/side_lgB probe_opts require probe='xl'")
        self.index = index
        self.max_winners = max_winners
        self.c = c
        self.device = resolve_device(device)
        # deduped deg>=3 gene sets for the tie-heavy group fast path; the
        # host expands group verdicts (PACK_GRP) through this
        gi = group_info(index)
        self.groups = gi[1] if gi is not None else None
        built = built_xl = None
        if probe != "classic":
            geom = dict(lgB=xl_lgB, side_lgB=xl_side_lgB)
            cached = None
            if cache_dir:
                from shark_tpu_torch.classify.table_cache import (
                    load_tables,
                    save_tables_async,
                )

                cached = load_tables(cache_dir, index, probe, **geom)
            if cached is not None:
                kind, arrays = cached
                if kind == "hashed":
                    built = arrays
                else:
                    built_xl = arrays
            else:
                if probe != "xl":
                    built = hashed.build_hashed_index(
                        index, threads=build_threads)
                if built is None:
                    built_xl = hashed.build_hashed_xl(
                        index, threads=build_threads, **geom)
                if cache_dir and (built is not None or built_xl is not None):
                    save_tables_async(
                        cache_dir, index, probe,
                        "hashed" if built is not None else "xl",
                        built if built is not None else built_xl, **geom)
            if built is None and built_xl is None and probe is not None:
                raise ValueError(
                    f"{probe} probe table not buildable for this index "
                    "(table budget / stash overflow); use probe='classic'"
                )
        if built is not None or built_xl is not None:
            if built is not None:
                table, stash, hmeta = built
                side = side_stash = None
                self.probe = "hashed"
            else:
                table, side, side_stash, hmeta = built_xl
                stash = hashed.empty_stash()  # the xl layout has none
                self.probe = "xl"
            rows3, ext_mat = (
                build_rows3(index)
                if hmeta.has_rows
                else (np.zeros((1, 1), np.uint32), None)
            )
            self.dix, self._hmeta = hashed.hashed_device_index(
                table, stash, rows3, ext_mat, hmeta, self.device,
                side=side, side_stash=side_stash,
            )
            self._has_rows = self._hmeta.has_rows
        else:
            bf_rank, pay, rows3, ext_mat = build_device_index(index)
            self._has_rows = bool((np.diff(index.offsets) >= 3).any())
            self.dix = DeviceIndex(
                *(to_device(a, self.device)
                  for a in (bf_rank, pay, rows3, ext_mat)))
            self._hmeta = None
            self.probe = "classic"
        self._meta = {}
        self._thresh = {}

    def _geometry(self, L: int):
        meta = self._meta.get(L)
        if meta is None:
            meta = StaticMeta.for_index(self.index, L)
            self._meta[L] = meta
            self._thresh[L] = torch.from_numpy(
                emit_threshold_table(self.c, L)
            ).to(self.device)
        return meta, self._thresh[L]

    def __call__(self, codes):
        """codes: uint8 [B, L] -> (packed, winners, best_cov, length) on
        the device (asynchronous on a card). L is padded with invalid
        bases to a multiple of 8 for the planar packing; that changes no
        verdict (window positions, lengths and thresholds are those of the
        unpadded read)."""
        return self.call_packed(*planar(codes, self.device))

    def call_packed(self, packed, vmask):
        """packed u8[B, L/4] + validity u8[B, L/8] -> result tuple. The
        copy to the card is the pass's span "h2d", the launches the rest
        of the call (K1, the probe, K3 queued) its span "launch"."""
        packed, vmask = self.upload(packed, vmask)
        with span("launch"):
            return self.finish(self.tags_on_device(packed, vmask))

    def upload(self, packed, vmask):
        """The planar reads moved to this classifier's device (span
        "h2d")."""
        with span("h2d"):
            return (torch.as_tensor(packed).to(self.device, non_blocking=True),
                    torch.as_tensor(vmask).to(self.device, non_blocking=True))

    def tags(self, packed, vmask):
        """K1 and the layout's probe (K2, K6 or K5): planar reads, moved to
        this classifier's device -> (tagv, payv, length, L), the finish's
        inputs."""
        return self.tags_on_device(*self.upload(packed, vmask))

    def tags_on_device(self, packed, vmask):
        """tags() of planar reads already on this classifier's device."""
        L = packed.shape[1] * 4
        meta, _ = self._geometry(L)
        idx_hi, idx_lo, win_valid, length = front_end(packed, vmask, meta)
        dix = self.dix
        if self.probe == "classic":
            tagv, payv = probe_tags(idx_hi, idx_lo, win_valid, dix.bf_rank,
                                    dix.pay)
        else:
            from shark_tpu_torch.classify import hashed

            if self._hmeta.xl:
                tagv, payv = hashed.probe_xl(
                    idx_hi, idx_lo, win_valid, dix.table, dix.side,
                    dix.side_stash, self._hmeta)
            else:
                tagv, payv = hashed.probe_hashed(
                    idx_hi, idx_lo, win_valid, dix.table, dix.stash,
                    self._hmeta, dix.stash_rows)
        return tagv, payv, length, L

    def group_count(self, tags, n_fix) -> None:
        """Adds the impure row-hitting reads of `tags` (one part of a batch)
        to n_fix (i32[1] on this device): finish_group_count."""
        tagv, payv, _, L = tags
        finish_group_count(tagv, payv, n_fix, meta=self._geometry(L)[0],
                           has_rows=self._has_rows)

    def finish(self, tags, n_fix=None, fix_cap2=None):
        """K3 on tags(...)'s output -> (packed i32[B], winners i32[B, W],
        best_cov i32[B], length i32[B]), bit-exact with shark_tpu's
        classify kernels. `n_fix`, `fix_cap2`: the whole batch's group
        count and cap when these reads are one part of it."""
        tagv, payv, length, L = tags
        meta, thresh = self._geometry(L)
        return finish_from_tags(
            tagv, payv, length, thresh, rows3=self.dix.rows3,
            ext_mat=self.dix.ext_mat, meta=meta,
            max_winners=self.max_winners, L=L, has_rows=self._has_rows,
            n_fix=n_fix, fix_cap2=fix_cap2)
