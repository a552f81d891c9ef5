"""The one generator: a deployment's genes (FASTA) and a traffic mix's sample
(FASTQ) from a seed, both from parameters in data files.

A configuration file's "genes" block says how many genes, how long, and how
they fall into families that share a core (bench/transcriptome_bench.py:
37-84); a traffic file says how many reads or pairs, how long, which share
comes from the indexed genes and which from sequence that is not indexed,
which share is read off the reverse strand, the error model and the
qualities (bench.py:110-195). The draws are vectorised in blocks of a
fixed size, so the same seed and the same parameters give the same bytes.

Records have fixed-width names, so a record is one row of a byte matrix:
    >GENE00017\\n<seq>\\n
    @r0000042\\n<seq>\\n+\\n<qual>\\n
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
# complement of A, C, G, T, N in ASCII (anything else maps to N)
_COMPLEMENT = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMPLEMENT[_a] = _b
BLOCK = 1 << 16  # reads drawn at once


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """One independent stream per purpose (genes, reads); any whole
    number is a seed, negative ones included."""
    return np.random.default_rng([seed & ((1 << 64) - 1), stream])


def names(prefix: str, digits: int, first: int, n: int) -> np.ndarray:
    """uint8[n, len(prefix) + digits]: prefix and the zero-padded number."""
    if first + n > 10 ** digits:
        raise ValueError(f"{first + n} names do not fit {digits} digits")
    num = np.arange(first, first + n, dtype=np.int64)
    pow10 = 10 ** np.arange(digits - 1, -1, -1, dtype=np.int64)
    dig = (num[:, None] // pow10[None, :]) % 10 + ord("0")
    pre = np.broadcast_to(np.frombuffer(prefix.encode(), np.uint8),
                          (n, len(prefix)))
    return np.concatenate([pre, dig.astype(np.uint8)], axis=1)


def _col(n: int, text: bytes) -> np.ndarray:
    return np.broadcast_to(np.frombuffer(text, np.uint8), (n, len(text)))


def gene_matrix(spec: Dict, seed: int) -> np.ndarray:
    """uint8[count, length] ASCII genes. Every `family_every`-th gene
    starts a family of `family_size` genes that share a `family_core`
    bp core, centred, between random flanks of their own."""
    rng = rng_for(seed, 1)
    count, length = spec["count"], spec["length"]
    genes = BASES[rng.integers(0, 4, size=(count, length), dtype=np.uint8)]
    every, size, core = (spec.get("family_every", 0),
                         spec.get("family_size", 0),
                         spec.get("family_core", 0))
    if every and size and core:
        heads = np.arange(0, count, every)
        cores = BASES[rng.integers(0, 4, size=(heads.size, core),
                                   dtype=np.uint8)]
        at = (length - core) // 2
        for j in range(size):
            members = heads + j
            keep = members < count
            genes[members[keep], at:at + core] = cores[keep]
    return genes


def write_fasta(path: str, spec: Dict, seed: int) -> np.ndarray:
    genes = gene_matrix(spec, seed)
    n = genes.shape[0]
    rows = np.concatenate(
        [_col(n, b">"), names(spec["name_prefix"], spec["name_digits"], 0, n),
         _col(n, b"\n"), genes, _col(n, b"\n")], axis=1)
    with open(path, "wb") as f:
        f.write(np.ascontiguousarray(rows).tobytes())
    return genes


def reverse_complement(seqs: np.ndarray) -> np.ndarray:
    return _COMPLEMENT[seqs[:, ::-1]]


def _errors(rng, seqs: np.ndarray, rate: float, alphabet: bytes) -> np.ndarray:
    """Each base replaced, with probability `rate`, by a draw from
    `alphabet` (which may give the base back), as bench.py:160-167."""
    if rate <= 0:
        return seqs
    hit = rng.random(seqs.shape, dtype=np.float32) < rate
    alpha = np.frombuffer(alphabet.encode(), np.uint8)
    sub = alpha[rng.integers(0, alpha.size, size=seqs.shape, dtype=np.uint8)]
    return np.where(hit, sub, seqs)


def _qualities(rng, n: int, length: int, kind: str) -> np.ndarray:
    """'constant': every base 'I'; 'profile': bench.py:176-183, about 97%
    of bases q30-40 and 3% q2-19, Phred+33."""
    if kind == "constant":
        return np.full((n, length), ord("I"), np.uint8)
    if kind != "profile":
        raise ValueError(f"unknown quality kind {kind!r}")
    q = rng.integers(30, 41, size=(n, length), dtype=np.uint8)
    low = rng.random((n, length), dtype=np.float32) < 0.03
    q = np.where(low, rng.integers(2, 20, size=(n, length), dtype=np.uint8), q)
    return q + np.uint8(33)


def _fragments(rng, genes: np.ndarray, n: int, frag: int, on_genes: np.ndarray,
               reverse: np.ndarray) -> np.ndarray:
    """uint8[n, frag]: a fragment of a random gene where `on_genes`, of
    random sequence that no gene holds elsewhere; reverse-complemented
    where `reverse`."""
    g, length = genes.shape
    gi = rng.integers(0, g, size=n)
    start = rng.integers(0, length - frag + 1, size=n)
    cols = start[:, None] + np.arange(frag)[None, :]
    out = genes[gi[:, None], cols]
    off = ~on_genes
    if off.any():
        out[off] = BASES[rng.integers(0, 4, size=(int(off.sum()), frag),
                                      dtype=np.uint8)]
    if reverse.any():
        out[reverse] = reverse_complement(out[reverse])
    return out


def _exact_share(rng, n: int, share: float) -> np.ndarray:
    """A bool mask with exactly round(share * n) True, in random places:
    every seed gets the same amount of each kind of read."""
    mask = np.zeros(n, dtype=bool)
    mask[rng.permutation(n)[: int(round(share * n))]] = True
    return mask


def write_fastq(paths: List[str], traffic: Dict, genes: np.ndarray,
                seed: int) -> int:
    """The sample: `paths` holds one file (single-end) or two (pairs: mate
    1 the first `read_len` bases of a `fragment_len` fragment, mate 2 the
    reverse complement of its last). Returns the count of reads or
    pairs."""
    rng = rng_for(seed, 2)
    paired = traffic["layout"] == "paired"
    if paired != (len(paths) == 2):
        raise ValueError("a paired traffic mix writes two files")
    n = traffic["reads"]
    rl = traffic["read_len"]
    frag = traffic.get("fragment_len", rl) if paired else rl
    on_genes = _exact_share(rng, n, traffic["from_genes"])
    reverse = _exact_share(rng, n, traffic.get("reverse_strand", 0.0))
    files = [open(p, "wb") for p in paths]
    try:
        for first in range(0, n, BLOCK):
            m = min(BLOCK, n - first)
            fr = _fragments(rng, genes, m, frag, on_genes[first:first + m],
                            reverse[first:first + m])
            mates = [fr[:, :rl]]
            if paired:
                mates.append(reverse_complement(fr[:, frag - rl:]))
            head = names(traffic["name_prefix"], traffic["name_digits"],
                         first, m)
            for f, seq in zip(files, mates):
                seq = _errors(rng, seq, traffic["error_rate"],
                              traffic.get("error_bases", "ACGTN"))
                qual = _qualities(rng, m, rl, traffic["quality"])
                rows = np.concatenate(
                    [_col(m, b"@"), head, _col(m, b"\n"), seq,
                     _col(m, b"\n+\n"), qual, _col(m, b"\n")], axis=1)
                f.write(np.ascontiguousarray(rows).tobytes())
    finally:
        for f in files:
            f.close()
    return n


def write_inputs(dirpath: str, config: Dict, traffic: Dict, seed: int) -> Dict:
    """Write genes.fa and reads_1.fq (and reads_2.fq for pairs) under
    `dirpath`; returns their paths."""
    os.makedirs(dirpath, exist_ok=True)
    fasta = os.path.join(dirpath, "genes.fa")
    genes = write_fasta(fasta, config["genes"], seed)
    fq = [os.path.join(dirpath, "reads_1.fq")]
    if traffic["layout"] == "paired":
        fq.append(os.path.join(dirpath, "reads_2.fq"))
    write_fastq(fq, traffic, genes, seed)
    return {"fasta": fasta, "fastq": fq}
