"""Shark's classification, restated in plain PyTorch.

The semantics (upstream shark: ReadAnalyzer.hpp:39-109, bloomfilter.h:
61-102, kmer_utils.hpp:57-83):
  - a base is A, C, G or T in either case; anything else breaks k-mers;
  - a k-mer is a window of k valid bases, packed 2 bits a base with the
    leftmost base highest; it is hashed in canonical form, the smaller of
    itself and its reverse complement;
  - its Bloom address is XXH64(the k-mer as 8 little-endian bytes, seed 0)
    modulo the filter's size in bits;
  - the index maps each address to the ascending list of genes that have
    a k-mer there (collisions included);
  - a read (mate 1, one invalid base, mate 2 for pairs; bases under -q
    invalid) probes its k-mers in order; per gene, cov += min(k, end -
    last end), hits += 1, last end = end, where the read's first k-mer
    counts its end one further;
  - the winners are the genes tied on the largest (cov, hits); the read is
    reported iff cov >= c * (its valid bases) in double precision (and,
    with -s, there is one winner), one line per winner in gene order.

`canonical=False` hashes the forward k-mer alone: the control, which
breaks the strand guarantee that the deployments state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .fastx import read_fasta, read_fastq

INVALID = 4
P1 = 11400714785074694791
P2 = 14029467366897019727
P3 = 1609587929392839161
P4 = 9650029242287828579
P5 = 2870177450012600261
GENE_BITS = 16  # gene ids below 65536, as shark's uint16

_CODE = np.full(256, INVALID, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
    _CODE[_b + 32] = _i  # lower case


def _s64(v: int) -> int:
    """The int64 with the bits of the u64 `v`."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in an int64 tensor."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _rotl(x: torch.Tensor, s: int) -> torch.Tensor:
    return (x << s) | _shr(x, 64 - s)


def xxh64(x: torch.Tensor) -> torch.Tensor:
    """XXH64 of 8-byte keys, seed 0, as u64 bits in int64 (products wrap
    modulo 2**64, as the hash needs)."""
    k1 = _rotl(x * _s64(P2), 31) * _s64(P1)
    h = _s64(P5 + 8) ^ k1
    h = _rotl(h, 27) * _s64(P1) + _s64(P4)
    h = h ^ _shr(h, 33)
    h = h * _s64(P2)
    h = h ^ _shr(h, 29)
    h = h * _s64(P3)
    return h ^ _shr(h, 32)


def bloom_address(h: torch.Tensor, size_bits: int) -> torch.Tensor:
    """The u64 `h` modulo `size_bits`, in 16-bit steps so that no int64
    product overflows."""
    if not 0 < size_bits < (1 << 47):
        raise ValueError("the filter's size must lie in (0, 2**47) bits")
    if size_bits & (size_bits - 1) == 0:
        return h & (size_bits - 1)
    r = _shr(h, 32) % size_bits
    r = (r * 65536 + (_shr(h, 16) & 0xFFFF)) % size_bits
    return (r * 65536 + (h & 0xFFFF)) % size_bits


def codes_of(ascii_rows: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Base codes 0-3 of padded ASCII rows, INVALID past each length."""
    codes = _CODE[ascii_rows]
    codes[np.arange(codes.shape[1])[None, :] >= lens[:, None]] = INVALID
    return codes


def kmers(codes: torch.Tensor, k: int, canonical: bool = True
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k-mer int64[N, W], valid bool[N, W]) of every window of uint8
    codes[N, L]; window w ends at base w + k - 1."""
    n, length = codes.shape
    w = max(length - k + 1, 0)
    valid = codes < INVALID
    c = torch.where(valid, codes, torch.zeros_like(codes)).long()
    fwd = torch.zeros((n, w), dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    ok = torch.ones((n, w), dtype=torch.bool, device=codes.device)
    for j in range(k):
        cj = c[:, j:j + w]
        fwd = (fwd << 2) | cj
        rc = (rc >> 2) | ((3 ^ cj) << (2 * k - 2))
        ok &= valid[:, j:j + w]
    return (torch.minimum(fwd, rc) if canonical else fwd), ok


@dataclass
class Index:
    """Sorted distinct Bloom addresses, CSR offsets into `genes`."""

    k: int
    size_bits: int
    canonical: bool
    address: torch.Tensor  # int64[n_set]
    offsets: torch.Tensor  # int64[n_set + 1]
    genes: torch.Tensor  # int64[total], ascending within an address
    names: List[bytes]


def build_index(names: List[bytes], seqs: Sequence[bytes], k: int,
                size_bits: int, device, canonical: bool = True,
                block: int = 4096) -> Index:
    if len(seqs) > (1 << GENE_BITS):
        raise ValueError("more genes than shark's 16-bit gene ids hold")
    keys = []
    for first in range(0, len(seqs), block):
        part = seqs[first:first + block]
        lens = np.array([len(s) for s in part], dtype=np.int64)
        width = max(int(lens.max()) if lens.size else 0, k)
        rows = np.zeros((len(part), width), dtype=np.uint8)
        for i, s in enumerate(part):
            rows[i, :len(s)] = np.frombuffer(s, np.uint8)
        codes = torch.from_numpy(codes_of(rows, lens)).to(device)
        km, ok = kmers(codes, k, canonical)
        gid = torch.arange(first, first + len(part), device=device)
        key = (bloom_address(xxh64(km), size_bits) << GENE_BITS) | gid[:, None]
        keys.append(torch.unique(key[ok]))
    key = torch.unique(torch.cat(keys)) if keys else torch.zeros(
        0, dtype=torch.int64, device=device)
    address, counts = torch.unique_consecutive(key >> GENE_BITS,
                                               return_counts=True)
    offsets = torch.zeros(address.numel() + 1, dtype=torch.int64,
                          device=device)
    torch.cumsum(counts, 0, out=offsets[1:])
    return Index(k, size_bits, canonical, address, offsets,
                 key & ((1 << GENE_BITS) - 1), list(names))


def classify(index: Index, codes: torch.Tensor, c: float,
             single: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(read, gene) int64 pairs of every association of uint8 codes[N, L]
    (fused, masked reads), in read then gene order."""
    k = index.k
    dev = codes.device
    n = codes.shape[0]
    length = (codes < INVALID).sum(1)
    km, ok = kmers(codes, k, index.canonical)
    if km.shape[1] == 0 or index.address.numel() == 0:
        none = torch.zeros(0, dtype=torch.int64, device=dev)
        return none, none
    first = ok.to(torch.int32).argmax(1)  # the read's first valid k-mer
    read, win = ok.nonzero(as_tuple=True)
    addr = bloom_address(xxh64(km[ok]), index.size_bits)
    j = torch.searchsorted(index.address, addr)
    jc = j.clamp(max=index.address.numel() - 1)
    hit = (j < index.address.numel()) & (index.address[jc] == addr)
    read, win, j = read[hit], win[hit], j[hit]
    # one entry a (probe, gene it names)
    deg = index.offsets[j + 1] - index.offsets[j]
    probe = torch.repeat_interleave(torch.arange(j.numel(), device=dev), deg)
    within = torch.arange(probe.numel(), device=dev) - (
        torch.cumsum(deg, 0) - deg)[probe]
    gene = index.genes[index.offsets[j][probe] + within]
    read, win = read[probe], win[probe]
    end = win + (k - 1)
    end_eff = end + (win == first[read]).long()
    # per (read, gene), in probe order
    key = (read << GENE_BITS) | gene
    order = torch.sort(key, stable=True).indices
    key, end, end_eff = key[order], end[order], end_eff[order]
    new = torch.ones_like(key, dtype=torch.bool)
    new[1:] = key[1:] != key[:-1]
    last = torch.zeros_like(end)
    last[1:] = end[:-1]
    last[new] = 0
    grp = torch.cumsum(new.long(), 0) - 1
    ngrp = int(new.sum())
    cov = torch.zeros(ngrp, dtype=torch.int64, device=dev).index_add_(
        0, grp, torch.clamp(end_eff - last, max=k))
    hits = torch.bincount(grp, minlength=ngrp)
    g_key = key[new]
    g_read, g_gene = g_key >> GENE_BITS, g_key & ((1 << GENE_BITS) - 1)
    score = (cov << 32) | hits
    best = torch.full((n,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, g_read, score, "amax")
    win_ = score == best[g_read]
    n_win = torch.bincount(g_read[win_], minlength=n)
    emit = (n_win > 0) & ((best >> 32).double() >= c * length.double())
    if single:
        emit &= n_win == 1
    sel = win_ & emit[g_read]
    return g_read[sel], g_gene[sel]


@dataclass
class Sample:
    """Codes of the fused reads of a sample, built block by block."""

    mates: list  # one or two fastx.Fastq
    min_quality: int

    def __len__(self) -> int:
        return len(self.mates[0])

    def codes(self, rows: slice) -> np.ndarray:
        parts = []
        for m in self.mates:
            seq, lens = m.matrix("seq", rows)
            codes = codes_of(seq, lens)
            if self.min_quality > 0:
                qual, _ = m.matrix("qual", rows)
                codes[(qual < self.min_quality + 33)
                      & (codes != INVALID)] = INVALID
            parts.append((codes, lens))
        if len(parts) == 1:
            return parts[0][0]
        (c1, l1), (c2, l2) = parts
        width = int((l1 + 1 + l2).max()) if l1.size else 1
        col = np.broadcast_to(np.arange(width)[None, :], (l1.size, width))
        in1 = col < l1[:, None]
        off2 = col - (l1[:, None] + 1)
        in2 = (off2 >= 0) & (off2 < l2[:, None])
        out = np.full((l1.size, width), INVALID, dtype=np.uint8)
        for cm, idx, inside in ((c1, col, in1), (c2, off2, in2)):
            cm = np.pad(cm, ((0, 0), (0, width - cm.shape[1])),
                        constant_values=INVALID)
            got = np.take_along_axis(cm, np.clip(idx, 0, width - 1), 1)
            out[inside] = got[inside]
        return out


def associations(index: Index, sample: Sample, c: float, single: bool,
                 device, block: int = 1 << 17) -> Tuple[np.ndarray, np.ndarray]:
    """(read, gene) int64 arrays of a whole sample, block by block."""
    reads, genes = [], []
    for first in range(0, len(sample), block):
        rows = slice(first, min(first + block, len(sample)))
        codes = torch.from_numpy(sample.codes(rows)).to(device)
        r, g = classify(index, codes, c, single)
        reads.append(r.cpu().numpy() + first)
        genes.append(g.cpu().numpy())
    if not reads:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(reads), np.concatenate(genes)


def render(index: Index, sample: Sample, reads: np.ndarray,
           genes: np.ndarray) -> Tuple[bytes, List[bytes]]:
    """The bytes shark writes for these associations: the ssv ("read
    gene" lines) and, for each mate, the records of the reported reads in
    input order."""
    m1 = sample.mates[0]
    out_reads = np.unique(reads)
    names = {int(r): m1.name(int(r)) for r in out_reads}
    ssv = b"".join(names[int(r)] + b" " + index.names[int(g)] + b"\n"
                   for r, g in zip(reads, genes))
    fastq = [b"".join(m.record(int(r)) for r in out_reads)
             for m in sample.mates]
    return ssv, fastq


def run(fasta: str, fastq: Sequence[str], k: int, c: float, size_bits: int,
        min_quality: int, single: bool, device, canonical: bool = True,
        index: Optional[Index] = None):
    """Index and classify a whole sample; returns (index, sample, reads,
    genes)."""
    if index is None:
        names, seqs = read_fasta(fasta)
        index = build_index(names, seqs, k, size_bits, device, canonical)
    sample = Sample([read_fastq(p) for p in fastq], min_quality)
    reads, genes = associations(index, sample, c, single, device)
    return index, sample, reads, genes
