"""Host-side index builder (vectorized numpy).

Replaces the reference's three-step build (parallel Bloom fill, rank init,
sequential gene-association pass; main.cpp:128-193, bloomfilter.h:57-75,
111-188) with a single streaming pass over the FASTA: per gene we compute the
unique Bloom positions of its canonical k-mers, then construct the bit-vector,
per-word rank, and CSR association table in bulk.

Association semantics match the reference exactly: per Bloom position, the
gene list is the ascending, duplicate-free list of genes touching it. (The
reference achieves this by processing genes in file order and appending
if-not-last after sorting each gene's positions, bloomfilter.h:68-73; a
stable sort of (position, gene) pairs produced in gene order is equivalent.)

Gene indices count every FASTA record, including records shorter than k
(main.cpp:186 increments nidx unconditionally), so record order defines ids.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

from shark_tpu_torch.index.structure import SharkIndex
from shark_tpu_torch.ops.kmers import canonical_kmers_np, encode_bytes
from shark_tpu_torch.ops.xxh64 import xxh64_np

MAX_GENES = 1 << 16  # uint16 gene ids, reference bloomfilter.h:45


def gene_bf_positions(seq: bytes, k: int, size_bits: int) -> np.ndarray:
    """Unique Bloom bit positions of one gene's canonical k-mers (uint64)."""
    canon, _ = canonical_kmers_np(encode_bytes(seq), k)
    if canon.size == 0:
        return np.empty(0, np.uint64)
    idx = xxh64_np(canon) % np.uint64(size_bits)
    return np.unique(idx)


def build_index(
    records: Iterable[Tuple[str, bytes]], k: int, size_bits: int
) -> SharkIndex:
    """records: iterable of (name, sequence bytes) in file order."""
    if size_bits <= 0 or size_bits % 64 != 0:
        raise ValueError("size_bits must be a positive multiple of 64")
    if not (1 <= k <= 31):
        # the reference limit (argument_parser.hpp:115); k >= 32 would
        # silently overflow the 2-bit-per-base uint64 k-mer encoding
        raise ValueError("k must be in the range [1, 31]")
    gene_names = []
    per_gene_idx = []
    per_gene_count = []
    for name, seq in records:
        gid = len(gene_names)
        gene_names.append(name)
        uniq = gene_bf_positions(seq, k, size_bits)
        per_gene_idx.append(uniq)
        per_gene_count.append(uniq.size)
    n_genes = len(gene_names)
    if n_genes > MAX_GENES:
        raise ValueError(
            f"too many genes ({n_genes}); gene-id capacity is {MAX_GENES}"
        )

    if per_gene_idx:
        all_idx = np.concatenate(per_gene_idx)
    else:
        all_idx = np.empty(0, np.uint64)
    all_gene = np.repeat(
        np.arange(n_genes, dtype=np.uint16), np.asarray(per_gene_count, np.int64)
    )

    set_positions = np.unique(all_idx)  # sorted set-bit positions
    n_set = set_positions.size

    # Bit-vector: OR the per-position bits grouped by word.
    n_words = size_bits // 32
    bf_words = np.zeros(n_words, dtype=np.uint32)
    if n_set:
        word_of = (set_positions >> np.uint64(5)).astype(np.int64)
        bit_of = np.uint32(1) << (set_positions & np.uint64(31)).astype(np.uint32)
        # group-by-word OR: set_positions is sorted, so words are grouped
        starts = np.flatnonzero(np.diff(word_of, prepend=-1))
        bf_words[word_of[starts]] = np.bitwise_or.reduceat(bit_of, starts)

    # Per-word exclusive cumulative popcount (the rank structure). Stay in
    # uint32 end to end: uint64 intermediates over the 2^28-word default
    # filter double the allocation and conversion; n_set < 2^32 is
    # guaranteed by the positions fitting the association table.
    if n_set >= (1 << 32):
        raise ValueError("too many set bits for uint32 rank")
    pop = popcount_u32(bf_words)
    word_rank = np.zeros(n_words, dtype=np.uint32)
    if n_words > 1:
        np.cumsum(pop[:-1], dtype=np.uint32, out=word_rank[1:])
    total_bits = int(word_rank[-1]) + int(pop[-1]) if n_words else 0
    assert total_bits == n_set

    # CSR association table: rank of each (position, gene) pair, stable by
    # gene order => ascending unique gene list per set bit.
    ranks = np.searchsorted(set_positions, all_idx).astype(np.int64)
    counts = np.bincount(ranks, minlength=n_set).astype(np.int64)
    offsets = np.zeros(n_set + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    if offsets[-1] >= (1 << 31):
        raise ValueError("association table too large for int32 offsets")
    order = np.argsort(ranks, kind="stable")
    gene_ids = all_gene[order]

    return SharkIndex(
        k=k,
        size_bits=size_bits,
        bf_words=bf_words,
        word_rank=word_rank,
        offsets=offsets.astype(np.int32),
        gene_ids=np.ascontiguousarray(gene_ids),
        gene_names=gene_names,
    )


def popcount_u32(words: np.ndarray) -> np.ndarray:
    try:
        return np.bitwise_count(words)
    except AttributeError:  # numpy < 2.0
        v = words.astype(np.uint64)
        v = v - ((v >> np.uint64(1)) & np.uint64(0x55555555))
        v = (v & np.uint64(0x33333333)) + ((v >> np.uint64(2)) & np.uint64(0x33333333))
        v = (v + (v >> np.uint64(4))) & np.uint64(0x0F0F0F0F)
        return ((v * np.uint64(0x01010101)) >> np.uint64(24)).astype(np.uint32)
