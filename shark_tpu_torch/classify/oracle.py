"""Pure-Python/numpy oracle: the executable specification.

A direct, dict-based re-statement of the reference's per-read classification
(ReadAnalyzer.hpp:39-109) and index association (bloomfilter.h:61-102),
independent of the device implementation. Used by tests to pin down exact
semantics (golden-file equality on the shipped example) and as the rare-case
fallback when a read has more tied winner genes than the device kernel's
compaction width.

Semantics reproduced:
  - len = number of ACGT bases in the (fused) read; candidate k-mers are all
    length-k windows of valid bases, probed in increasing end-position order;
  - per gene: cov += min(k, pos_effective - last), hits += 1, last = end,
    where the first probed k-mer of the read uses pos_effective = end + 1
    (the reference probes it with `pos` one past the window,
    ReadAnalyzer.hpp:56-62) and all others use pos_effective = end;
  - winners = all genes tied on lexicographically-max (cov, hits), in
    ascending gene-index order (std::map iteration);
  - emit iff cov_max >= c*len (double-precision compare) and, with
    --single, exactly one winner.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from shark_tpu_torch.ops.kmers import canonical_kmers_np, encode_bytes
from shark_tpu_torch.ops.xxh64 import xxh64_np

FastqRecord = Tuple[str, bytes, bytes]


@dataclass
class OracleIndex:
    """bf position -> ascending unique gene-id list (collision-faithful)."""

    k: int
    size_bits: int
    assoc: Dict[int, List[int]]
    gene_names: List[str]


def build_oracle_index(
    records: Iterable[Tuple[str, bytes]], k: int, size_bits: int
) -> OracleIndex:
    assoc: Dict[int, List[int]] = {}
    gene_names: List[str] = []
    for name, seq in records:
        gid = len(gene_names)
        gene_names.append(name)
        canon, _ = canonical_kmers_np(encode_bytes(seq), k)
        if canon.size == 0:
            continue
        idx = np.unique(xxh64_np(canon) % np.uint64(size_bits))
        for p in idx.tolist():
            lst = assoc.setdefault(int(p), [])
            # genes arrive in ascending order; each gene's positions are
            # unique, so append-if-new keeps lists ascending and unique
            if not lst or lst[-1] != gid:
                lst.append(gid)
    return OracleIndex(k=k, size_bits=size_bits, assoc=assoc, gene_names=gene_names)


def fuse_pair(
    rec1: FastqRecord, rec2: Optional[FastqRecord], min_quality: int
) -> np.ndarray:
    """Codes of the (fused, quality-masked) read, FastqSplitter semantics."""

    def one(rec: FastqRecord) -> np.ndarray:
        codes = encode_bytes(rec[1]).copy()
        if min_quality > 0:
            qual = np.frombuffer(rec[2], dtype=np.uint8)
            codes[qual < min_quality + 33] = 4
        return codes

    c1 = one(rec1)
    if rec2 is None:
        return c1
    sep = np.array([4], dtype=np.uint8)
    return np.concatenate([c1, sep, one(rec2)])


def classify_read(
    index: OracleIndex, codes: np.ndarray, c: float, only_single: bool
) -> Tuple[List[int], int, int]:
    """Returns (winner gene ids ascending, best_cov, len); winners empty if
    the read is not emitted."""
    k = index.k
    length = int(np.count_nonzero(codes < 4))
    state: Dict[int, List[int]] = {}  # gid -> [cov, hits, last]
    if length >= k:
        canon, end_pos = canonical_kmers_np(codes, k)
        if canon.size:
            hashes = xxh64_np(canon) % np.uint64(index.size_bits)
            for i in range(canon.size):
                genes = index.assoc.get(int(hashes[i]))
                if not genes:
                    continue
                e = int(end_pos[i])
                pos_eff = e + 1 if i == 0 else e
                for g in genes:
                    st = state.get(g)
                    if st is None:
                        st = [0, 0, 0]
                        state[g] = st
                    st[0] += min(k, pos_eff - st[2])
                    st[1] = 1 if i == 0 else st[1] + 1
                    st[2] = e
    best_cov = 0
    best_hits = 0
    winners: List[int] = []
    for g in sorted(state):
        cov, hits, _ = state[g]
        if cov == best_cov and hits == best_hits:
            winners.append(g)
        elif cov > best_cov or (cov == best_cov and hits > best_hits):
            winners = [g]
            best_cov = cov
            best_hits = hits
    if best_cov >= c * length and (not only_single or len(winners) == 1):
        return winners, best_cov, length
    return [], best_cov, length
