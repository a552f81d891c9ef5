"""Fixed-shape device batch encoding.

Turns a list of (possibly paired) FASTQ records into a padded uint8 code
matrix [B, L]: 0..3 = ACGT, 4 = invalid (anything else, quality-masked bases,
the pair separator, and padding).

Semantics mirror FastqSplitter (reference: FastqSplitter.hpp:47-113):
  - pairs are classified jointly as seq1 + separator + seq2 (the reference
    fuses with 'N', :63, which k-mer-breaks at the junction; an invalid code
    is the same thing);
  - with min_quality q > 0, bases whose quality byte < q+33 are masked to
    invalid (the reference subtracts 64 from the base byte, :104-109, which
    maps every ACGTacgt byte outside the alphabet). Masking runs in FUSED
    QUALITY coordinates: mask_seq masks seq[i] for i < len(qual) with the
    fused qual = qual1 + '\\33' + qual2 (:84-90, 104-113). For FASTQ input
    (qual length == seq length) this is per-base; for FASTA records kseq
    yields an empty qual, so a single-end FASTA read masks nothing and a
    paired FASTA read masks exactly fused position len(qual1) — quirks
    preserved bit for bit;
  - the ORIGINAL seq/qual strings are preserved separately for FASTQ output.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from shark_tpu_torch.ops.kmers import BYTE_TO_CODE, INVALID

FastqRecord = Tuple[str, bytes, bytes]


@dataclass
class ReadBatch:
    """Host-side batch: n real reads, padded to shape [B, L]."""

    codes: np.ndarray  # uint8 [B, L]
    n: int  # number of real reads (<= B)
    ids: List[str]  # len n, mate-1 names
    recs1: List[FastqRecord]  # len n, original mate-1 records
    recs2: Optional[List[FastqRecord]]  # len n or None (single-end)


def _flatten(chunks: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate byte strings -> (flat uint8, row index, col index)."""
    lens = np.fromiter((len(c) for c in chunks), dtype=np.int64, count=len(chunks))
    flat = np.frombuffer(b"".join(chunks), dtype=np.uint8)
    rows = np.repeat(np.arange(len(chunks), dtype=np.int64), lens)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
    cols = np.arange(flat.size, dtype=np.int64) - np.repeat(offsets, lens)
    return flat, rows, cols


def encode_batch(
    recs1: List[FastqRecord],
    recs2: Optional[List[FastqRecord]],
    min_quality: int,
    batch_size: int,
    max_len: int,
) -> ReadBatch:
    """Encode records into a fixed [batch_size, max_len] code matrix."""
    n = len(recs1)
    assert n <= batch_size
    codes = np.full((batch_size, max_len), INVALID, dtype=np.uint8)

    def fill(recs: List[FastqRecord], col_off: np.ndarray) -> None:
        seqs = [r[1] for r in recs]
        flat, rows, cols = _flatten(seqs)
        vals = BYTE_TO_CODE[flat]
        cols = cols + col_off[rows]
        if cols.size and int(cols.max()) >= max_len:
            raise ValueError(
                f"read longer than batch max_len={max_len}; "
                "increase max_read_len"
            )
        codes[rows, cols] = vals

    def mask(quals: List[bytes], col_off: np.ndarray) -> None:
        """Mask fused positions i (= qual coordinate + offset) with quality
        below the cut — reference mask_seq, FastqSplitter.hpp:104-113."""
        qflat, rows, cols = _flatten(quals)
        low = qflat < min_quality + 33
        r = rows[low]
        c = (cols + col_off[rows])[low]
        keep = c < max_len
        codes[r[keep], c[keep]] = INVALID

    zero = np.zeros(n, dtype=np.int64)
    fill(recs1, zero)
    if recs2 is not None:
        # mate 2 starts after mate 1 plus one invalid separator column
        off2 = np.fromiter((len(r[1]) + 1 for r in recs1), np.int64, count=n)
        fill(recs2, off2)
    if min_quality > 0:
        mask([r[2] for r in recs1], zero)
        if recs2 is not None:
            # fused qual = qual1 + '\33' + qual2: the junction byte always
            # masks (27 < 33 <= cut) at fused position len(qual1), and the
            # mate-2 qual masks from len(qual1) + 1 — qual coordinates, NOT
            # seq coordinates (they differ for FASTA records)
            qoff2 = np.fromiter(
                (len(r[2]) + 1 for r in recs1), np.int64, count=n
            )
            junction = qoff2 - 1
            codes[np.arange(n)[junction < max_len],
                  junction[junction < max_len]] = INVALID
            mask([r[2] for r in recs2], qoff2)

    return ReadBatch(
        codes=codes,
        n=n,
        ids=[r[0] for r in recs1],
        recs1=recs1,
        recs2=recs2,
    )


def fused_length(rec1: FastqRecord, rec2: Optional[FastqRecord]) -> int:
    if rec2 is None:
        return len(rec1[1])
    return len(rec1[1]) + 1 + len(rec2[1])
