"""The index: dense arrays instead of succinct structures.

The reference keeps (a) an sdsl bit-vector with rank support, (b) per-set-bit
gene-ID sets flattened into one uint16 array, and (c) a boundary bit-vector
with select support to find each set's extent (reference: bloomfilter.h:36-203).

Here the same information is four dense arrays, chosen so that a device probe
is a handful of coalesced gathers:

  bf_words  : uint32[n_words]   Bloom bit-vector, bit i of word w = bit 32w+i
  word_rank : uint32[n_words]   exclusive cumulative popcount per word
                                (replaces sdsl rank_support_v)
  offsets   : int32[n_set+1]    CSR row pointers per set bit, in bit order
                                (replaces the rank->select boundary walk)
  gene_ids  : uint16[total]     ascending unique gene ids per set bit

A probe of Bloom position p is: w = bf_words[p>>5]; hit = bit p&31 of w;
r = word_rank[p>>5] + popcount(w & low_mask); genes = gene_ids[offsets[r] :
offsets[r+1]] — two 4-byte gathers plus the gene-list walk, no select.

Gene-ID capacity matches the reference's uint16 ceiling of 65536 genes
(bloomfilter.h:45); the builder raises if exceeded.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class SharkIndex:
    k: int
    size_bits: int  # Bloom filter size in bits
    bf_words: np.ndarray  # uint32[n_words]
    word_rank: np.ndarray  # uint32[n_words]
    offsets: np.ndarray  # int32[n_set+1]
    gene_ids: np.ndarray  # uint16[total]
    gene_names: List[str]

    @property
    def n_genes(self) -> int:
        return len(self.gene_names)

    @property
    def max_degree(self) -> int:
        if self.offsets.size <= 1:
            return 0
        return int(np.max(np.diff(self.offsets)))

    @property
    def n_set_bits(self) -> int:
        return self.offsets.size - 1

    def save(self, path: str) -> None:
        """Serialize. A path ending in '/' or without an extension becomes a
        directory of raw .npy arrays (mmap-loadable in ~seconds even at the
        default 2 GiB scale); a .npz path uses compressed archive format
        (small on disk, ~tens of seconds to decompress at scale)."""
        if path.endswith(".npz"):
            np.savez_compressed(
                path,
                k=np.int64(self.k),
                size_bits=np.int64(self.size_bits),
                bf_words=self.bf_words,
                word_rank=self.word_rank,
                offsets=self.offsets,
                gene_ids=self.gene_ids,
                gene_names=np.array(self.gene_names, dtype=object),
            )
            return
        import json
        import os

        os.makedirs(path, exist_ok=True)
        for name in ("bf_words", "word_rank", "offsets", "gene_ids"):
            np.save(os.path.join(path, name + ".npy"), getattr(self, name))
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(
                {
                    "k": self.k,
                    "size_bits": self.size_bits,
                    "gene_names": self.gene_names,
                },
                f,
            )
        # content digest beside the arrays: later loads (and the probe-
        # table cache keyed on it) skip the hashing pass
        from shark_tpu_torch.classify.table_cache import write_index_digest

        write_index_digest(path, self)

    @classmethod
    def load(cls, path: str) -> "SharkIndex":
        import os

        if os.path.isdir(path):
            import json

            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
            arrs = {
                name: np.load(
                    os.path.join(path, name + ".npy"), mmap_mode="r"
                )
                for name in ("bf_words", "word_rank", "offsets", "gene_ids")
            }
            out = cls(
                k=int(meta["k"]),
                size_bits=int(meta["size_bits"]),
                gene_names=list(meta["gene_names"]),
                **arrs,
            )
            # lets table_cache.index_digest trust the stored digest file
            # (stat-guarded) instead of re-hashing the arrays
            out.__dict__["_source_dir"] = path
            return out
        with np.load(path, allow_pickle=True) as z:
            return cls(
                k=int(z["k"]),
                size_bits=int(z["size_bits"]),
                bf_words=z["bf_words"],
                word_rank=z["word_rank"],
                offsets=z["offsets"],
                gene_ids=z["gene_ids"],
                gene_names=[str(s) for s in z["gene_names"]],
            )

    def membership(self, bf_idx: int):
        """Host-side probe (debug/oracle cross-check): gene ids at a Bloom
        position, or empty array."""
        w = int(self.bf_words[bf_idx >> 5])
        bit = (w >> (bf_idx & 31)) & 1
        if not bit:
            return np.empty(0, np.uint16)
        r = int(self.word_rank[bf_idx >> 5]) + bin(
            w & ((1 << (bf_idx & 31)) - 1)
        ).count("1")
        return self.gene_ids[self.offsets[r] : self.offsets[r + 1]]
