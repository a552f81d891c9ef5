"""FASTA and FASTQ as shark reads them: a name is the header up to its
first whitespace; a FASTA sequence may span lines; a FASTQ record is four
lines (name, sequence, '+', qualities)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


def read_fasta(path: str) -> Tuple[List[bytes], List[bytes]]:
    """(names, sequences) in file order."""
    names: List[bytes] = []
    seqs: List[List[bytes]] = []
    with open(path, "rb") as f:
        for line in f.read().split(b"\n"):
            line = line.rstrip(b"\r")
            if line.startswith(b">"):
                head = line[1:].split(None, 1)
                names.append(head[0] if head else b"")
                seqs.append([])
            elif seqs:
                seqs[-1].append(line.strip())
    return names, [b"".join(s) for s in seqs]


@dataclass
class Fastq:
    """A FASTQ file as its bytes and the [start, end) of each record's
    header, sequence and quality lines."""

    data: np.ndarray
    head: np.ndarray  # int64[n, 2]
    seq: np.ndarray
    qual: np.ndarray

    def __len__(self) -> int:
        return self.head.shape[0]

    def name(self, i: int) -> bytes:
        a, b = self.head[i]
        return bytes(self.data[a + 1:b]).split(None, 1)[0]

    def record(self, i: int) -> bytes:
        """The record as shark writes it out: @name, sequence, +, quals."""
        (sa, sb), (qa, qb) = self.seq[i], self.qual[i]
        return (b"@" + self.name(i) + b"\n" + bytes(self.data[sa:sb])
                + b"\n+\n" + bytes(self.data[qa:qb]) + b"\n")

    def matrix(self, which: str, rows: slice) -> Tuple[np.ndarray, np.ndarray]:
        """(uint8[n, Lmax] padded with 0, int64[n] lengths) of the
        sequence or quality lines of `rows`."""
        span = getattr(self, which)[rows]
        lens = span[:, 1] - span[:, 0]
        width = int(lens.max()) if lens.size else 0
        col = np.arange(width)[None, :]
        ok = col < lens[:, None]
        idx = np.where(ok, span[:, :1] + col, 0)
        return np.where(ok, self.data[idx], 0).astype(np.uint8), lens


def read_fastq(path: str) -> Fastq:
    data = np.fromfile(path, dtype=np.uint8)
    nl = np.flatnonzero(data == ord("\n"))
    if data.size and data[-1] != ord("\n"):
        nl = np.append(nl, data.size)
    starts = np.concatenate([[0], nl[:-1] + 1]).astype(np.int64)
    ends = nl.astype(np.int64)
    # a trailing \r belongs to the line break
    ends = ends - ((ends > starts) & (data[np.maximum(ends - 1, 0)]
                                      == ord("\r")))
    if starts.size % 4:
        raise ValueError(f"{path}: {starts.size} lines, not 4 a record")
    span = np.stack([starts, ends], axis=1)
    if starts.size and (np.any(data[starts[0::4]] != ord("@"))
                        or np.any(data[starts[2::4]] != ord("+"))):
        raise ValueError(f"{path}: not a four-line FASTQ")
    return Fastq(data, span[0::4], span[1::4], span[3::4])
