"""The generator: the same seed gives the same bytes; the shares and
strands the traffic file names are what it writes."""

import hashlib

import numpy as np
import pytest

from conftest import TINY_GENES, tiny_traffic
from portbench import generate
from portbench.reference.fastx import read_fasta, read_fastq


def digest(paths) -> str:
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def write(tmp_path, traffic, seed, tag):
    out = generate.write_inputs(str(tmp_path / tag), {"genes": TINY_GENES},
                                traffic, seed)
    return [out["fasta"], *out["fastq"]]


@pytest.mark.parametrize("traffic", ["sample", "paired"])
def test_same_seed_same_bytes(tmp_path, traffic):
    t = tiny_traffic(traffic)
    big = 2 ** 31 + 12345
    a = write(tmp_path, t, big, "a")
    b = write(tmp_path, t, big, "b")
    c = write(tmp_path, t, big + 1, "c")
    assert digest(a) == digest(b)
    assert digest(a) != digest(c)
    assert len(a) == (3 if traffic == "paired" else 2)


def test_shares_and_strands(tmp_path):
    """The traffic's share of the reads comes from the genes, exactly;
    half of those read the reverse strand; pairs are innie, mate 2
    reverse-complemented."""
    t = tiny_traffic("sample")
    t.update(reads=2000, error_rate=0.0)
    fasta, fq = write(tmp_path, t, 7, "s")
    _, genes = read_fasta(fasta)
    text = b"|".join(genes)
    rc = b"|".join(bytes(generate.reverse_complement(
        np.frombuffer(g, np.uint8)[None, :])[0]) for g in genes)
    reads = read_fastq(fq)
    seqs = [bytes(reads.data[a:b]) for a, b in reads.seq]
    fwd = sum(s in text for s in seqs)
    rev = sum(s in rc and s not in text for s in seqs)
    want = int(round(t["from_genes"] * 2000))  # no errors
    assert fwd + rev == want
    assert want // 4 < rev < 3 * want // 4

    p = tiny_traffic("paired")
    p.update(error_rate=0.0)
    fasta, fq1, fq2 = write(tmp_path, p, 7, "p")
    _, genes = read_fasta(fasta)
    m1, m2 = read_fastq(fq1), read_fastq(fq2)
    assert len(m1) == len(m2) == p["reads"]
    for i in range(20):
        s1 = bytes(m1.data[slice(*m1.seq[i])])
        s2 = bytes(generate.reverse_complement(np.frombuffer(
            bytes(m2.data[slice(*m2.seq[i])]), np.uint8)[None, :])[0])
        frag_fwd = any(s1 in g and s2 in g and
                       g.index(s2) - g.index(s1) == p["fragment_len"]
                       - p["read_len"] for g in genes)
        frag_rev = any(s1 in r and s2 in r for r in (
            bytes(generate.reverse_complement(
                np.frombuffer(g, np.uint8)[None, :])[0]) for g in genes))
        assert frag_fwd or frag_rev
    assert m1.name(3) == m2.name(3) == b"p0000003"


def test_families_share_a_core(tmp_path):
    genes = generate.gene_matrix(TINY_GENES, 3)
    at = (TINY_GENES["length"] - TINY_GENES["family_core"]) // 2
    core = slice(at, at + TINY_GENES["family_core"])
    for head in range(0, TINY_GENES["count"], TINY_GENES["family_every"]):
        fam = genes[head:head + TINY_GENES["family_size"]]
        assert (fam[:, core] == fam[0, core]).all()
        assert not (fam[1:, :at] == fam[0, :at]).all()
    assert not (genes[4, core] == genes[0, core]).all()
