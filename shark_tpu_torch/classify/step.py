"""The classify step: planar reads -> per-read verdicts, on the device.

PyTorch counterpart of shark_tpu/classify/step.py. Per batch of padded
reads [B, L] it computes:

  1. K1, the front end (front_end): canonical k-mer, XXH64 and Bloom
     position of every probe window, and each read's length;
  2. K2, the probe (classify/hashed.py probe_hashed): per window a
     (tag, payload) from the hashed bucket table;
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

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from shark_tpu_torch import kernels
from shark_tpu_torch.index.structure import SharkIndex
from shark_tpu_torch.ops.kmers import INVALID, canonical_kmers_torch
from shark_tpu_torch.ops.xxh64 import shr64, xxh64_torch

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
    CUDA tensors run csrc/front.cu; CPU tensors the plain version."""
    B, L4 = packed.shape
    L = 4 * L4
    if vmask.shape != (B, L // 8):
        raise ValueError(f"vmask shape {tuple(vmask.shape)} != {(B, L // 8)}")
    if not packed.is_cuda:
        return front_end_plain(packed, vmask, meta)
    dev = packed.device
    kernels.require(packed, "packed", torch.uint8, 2, dev)
    kernels.require(vmask, "vmask", torch.uint8, 2, dev)
    mode, arg = _mod_size_params(meta.size_bits)
    Ls = L - min(meta.k - 1, L - 1)
    idx_hi = torch.empty((B, Ls), dtype=torch.uint32, device=dev)
    idx_lo = torch.empty((B, Ls), dtype=torch.uint32, device=dev)
    win_valid = torch.empty((B, Ls), dtype=torch.bool, device=dev)
    length = torch.empty((B,), dtype=torch.int32, device=dev)
    lib = kernels.lib()
    rc = lib.shkk_front(
        packed.data_ptr(), vmask.data_ptr(), B, L, meta.k, mode, arg,
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
                           meta, max_winners, L, has_rows):
    """Plain version of the finish, in int64. Every read gets its full
    verdict (direct keys, rows3 genes, extension genes); then, when the
    index carries group ids and the batch has at most FIX_CAP2 impure
    row-hitting reads, pure reads get their GROUP verdict instead. That
    is the verdict every branch of shark_tpu's finish_from_tags gives
    (its row-free, compact-row and sub-batch branches only change cost)."""
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
    if has_rows and rb:
        gid = p >> rb
        gmax = torch.where(is_row, gid, torch.full_like(gid, -1)).max(dim=1)
        gmin = torch.where(is_row, gid, torch.full_like(gid, 0x7FFFFFFF))
        any_row = is_row.any(dim=1)
        pure = (any_row & ~direct.any(dim=1)
                & (gmax.values == gmin.min(dim=1).values))
        n_fix = int((any_row & ~pure).sum())
        if n_fix <= fix_caps(B)[1] and bool(pure.any()):
            sel = torch.nonzero(pure).flatten()
            gkeys = torch.where(is_row[sel],
                                (meta.n_genes << pb) | pos[sel], none[sel])
            gp, gw, gc = _score_keys(
                gkeys, meta.n_genes + 1, length[sel], thresh,
                row_ovf[sel], **score)
            emit = (gp >> PACK_EMIT_SHIFT) & 1
            packed[sel] = (
                torch.clamp(gmax.values[sel], min=0).to(torch.int32)
                | (1 << PACK_NW_SHIFT) | (emit << PACK_EMIT_SHIFT)
                | (1 << PACK_GRP_SHIFT))
            winners[sel] = gw
            best_cov[sel] = gc
    return packed, winners, best_cov, length


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
):
    """K3: (tag, payload) per window -> (packed i32[B], winners i32[B, W],
    best_cov i32[B], length i32[B]). CUDA tensors run csrc/finish.cu (a
    batch-wide group pass, then one block per read); CPU tensors the plain
    version."""
    if not tagv.is_cuda:
        return finish_from_tags_plain(
            tagv, payv, length, thresh, rows3=rows3, ext_mat=ext_mat,
            meta=meta, max_winners=max_winners, L=L, has_rows=has_rows)
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
    packed = torch.empty((B,), dtype=torch.int32, device=dev)
    winners = torch.empty((B, W), dtype=torch.int32, device=dev)
    best_cov = torch.empty((B,), dtype=torch.int32, device=dev)
    groups = bool(has_rows and meta.rows_bits)
    lib = kernels.lib()
    stream = kernels.stream(dev)
    flags = gmax = n_fix = None
    if groups:
        flags = torch.empty((B,), dtype=torch.uint8, device=dev)
        gmax = torch.empty((B,), dtype=torch.int32, device=dev)
        n_fix = torch.zeros((1,), dtype=torch.int32, device=dev)
        rc = lib.shkk_finish_groups(
            tagv.data_ptr(), payv.data_ptr(), B, Ls, meta.rows_bits,
            flags.data_ptr(), gmax.data_ptr(), n_fix.data_ptr(), stream)
        kernels.check(rc, "finish")
    # keys of one read: <= max(D, 2) per window plus the extension genes
    has_ext = has_rows and ext_mat is not None and ext_w > 0
    kmax = max(D if has_rows else 0, 2) * Ls + (EXT_CAP2 * ext_w if has_ext else 0)
    key_cap = 1 << max(0, (kmax - 1).bit_length())
    scratch = None
    grid = B
    if key_cap * 8 > _FINISH_SMEM_MAX:
        # wide geometries: keys in a global scratch slice per block, with
        # a grid of a few blocks per SM looping over the reads
        grid = min(B, _FINISH_SCRATCH_GRID)
        scratch = torch.empty((grid, 2 * key_cap), dtype=torch.uint32,
                              device=dev)
    rc = lib.shkk_finish_reads(
        tagv.data_ptr(), payv.data_ptr(), length.data_ptr(),
        thresh.data_ptr(), rows3.data_ptr(), rows3.shape[0], rows3.shape[1],
        D, kernels.ptr(ext_mat if has_ext else None), ext_w if has_ext else 0,
        B, Ls, L, meta.k, meta.pos_bits, meta.n_genes, meta.rows_bits, W,
        int(has_rows), int(groups), kernels.ptr(flags), kernels.ptr(gmax),
        kernels.ptr(n_fix), fix_caps(B)[1], key_cap, grid,
        kernels.ptr(scratch), packed.data_ptr(), winners.data_ptr(),
        best_cov.data_ptr(), stream)
    kernels.check(rc, "finish")
    kernels.LAUNCHES.add("finish")
    return packed, winners, best_cov, length


# shared memory the finish's keys may take per block (keys + prefix sums,
# 8 bytes a key), and the grid of its global-scratch mode
_FINISH_SMEM_MAX = 96 * 1024
_FINISH_SCRATCH_GRID = 1056


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
    offsets = torch.empty((B + 1,), dtype=torch.int32, device=dev)
    rc = kernels.lib().shkk_pairs(
        packed.data_ptr(), winners.data_ptr(), B, W, out.data_ptr(),
        out_len, offsets.data_ptr(), kernels.stream(dev))
    kernels.check(rc, "pairs")
    kernels.LAUNCHES.add("pairs")
    return out


# ---------------------------------------------------------------------------
# The classifier
# ---------------------------------------------------------------------------


class Classifier:
    """Holds the device-resident index tables and runs the classify step.

    Probe-path selection (`probe`): "hashed" or None (auto) use the hashed
    bucket table (classify/hashed.py), the main path for gene panels. The
    other layouts of shark_tpu are not in the port yet: "xl" and "classic"
    raise, and so does an index whose hashed table cannot be built (where
    shark_tpu's auto-selection would take xl or classic) — the port never
    picks another layout silently."""

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
        table-build parallelism) and "cache_dir" (on-disk packed-table
        cache, classify/table_cache.py)."""
        from shark_tpu_torch.classify.hashed import (
            build_hashed_index,
            hashed_device_index,
        )
        from shark_tpu_torch.config import not_ported

        if probe in ("xl", "classic"):
            raise not_ported(
                f"probe={probe!r}",
                "xl probe" if probe == "xl" else "classic probe",
            )
        if probe not in (None, "hashed"):
            raise ValueError(f"unknown probe {probe!r}")
        opts = dict(probe_opts or {})
        build_threads = opts.pop("threads", None)
        cache_dir = opts.pop("cache_dir", None)
        if opts:
            raise ValueError(f"unknown probe_opts: {sorted(opts)}")
        self.index = index
        self.max_winners = max_winners
        self.c = c
        self.device = resolve_device(device)
        # deduped deg>=3 gene sets for the tie-heavy group fast path; the
        # host expands group verdicts (PACK_GRP) through this
        gi = group_info(index)
        self.groups = gi[1] if gi is not None else None
        built = None
        if cache_dir:
            from shark_tpu_torch.classify.table_cache import (
                load_tables,
                save_tables_async,
            )

            cached = load_tables(cache_dir, index, probe)
            if cached is not None:
                built = cached[1]
        if built is None:
            built = build_hashed_index(index, threads=build_threads)
            if built is None:
                raise not_ported(
                    "this index needs the xl or classic probe layout (its "
                    "hashed table exceeds the table or stash budget), which",
                    "xl probe / classic probe",
                )
            if cache_dir:
                save_tables_async(cache_dir, index, probe, "hashed", built)
        table, stash, hmeta = built
        rows3, ext_mat = (
            build_rows3(index)
            if hmeta.has_rows
            else (np.zeros((1, 1), np.uint32), None)
        )
        self.dix, self._hmeta = hashed_device_index(
            table, stash, rows3, ext_mat, hmeta, self.device
        )
        self.probe = "hashed"
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
        from shark_tpu_torch.classify.hashed import classify_kernel_hashed

        codes = torch.as_tensor(codes).to(self.device)
        B, L = codes.shape
        if L % 8:
            pad = torch.full((B, 8 - L % 8), INVALID, dtype=torch.uint8,
                             device=self.device)
            codes = torch.cat([codes, pad], dim=1)
        meta, thresh = self._geometry(codes.shape[1])
        return classify_kernel_hashed(
            self.dix, thresh, codes, meta=meta, hmeta=self._hmeta,
            max_winners=self.max_winners,
        )

    def call_packed(self, packed, vmask):
        """packed u8[B, L/4] + validity u8[B, L/8] -> result tuple."""
        from shark_tpu_torch.classify.hashed import (
            classify_kernel_hashed_packed,
        )

        packed = torch.as_tensor(packed).to(self.device, non_blocking=True)
        vmask = torch.as_tensor(vmask).to(self.device, non_blocking=True)
        meta, thresh = self._geometry(packed.shape[1] * 4)
        return classify_kernel_hashed_packed(
            self.dix, thresh, packed, vmask, meta=meta, hmeta=self._hmeta,
            max_winners=self.max_winners,
        )
