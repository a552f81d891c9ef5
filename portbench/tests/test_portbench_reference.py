"""The reference: a hand-worked case, its hash and addressing, and
agreement with the port's --backend cpu run (this test alone imports
both)."""

import os

import numpy as np
import pytest
import torch

from conftest import TEST_BF_UNIT_BITS, TINY_GENES, tiny_traffic
from portbench import generate
from portbench.reference import shark as ref

M64 = (1 << 64) - 1


def xxh64_scalar(x: int) -> int:
    """XXH64 of one 8-byte little-endian key, seed 0, in Python ints."""
    def rotl(v, s):
        return ((v << s) | (v >> (64 - s))) & M64

    h = (ref.P5 + 8) ^ (rotl((x * ref.P2) & M64, 31) * ref.P1 & M64)
    h = (rotl(h, 27) * ref.P1 + ref.P4) & M64
    h ^= h >> 33
    h = (h * ref.P2) & M64
    h ^= h >> 29
    h = (h * ref.P3) & M64
    return h ^ (h >> 32)


def test_xxh64_and_addressing():
    from shark_tpu_torch.ops.xxh64 import xxh64_int

    rng = np.random.default_rng(5)
    keys = [int(v) for v in rng.integers(0, 1 << 62, size=200)] + [0, 1, M64]
    got = ref.xxh64(torch.tensor([ref._s64(k) for k in keys]))
    for k, h in zip(keys, got.tolist()):
        assert h & M64 == xxh64_scalar(k) == xxh64_int(k)
    for size in (1 << 33, 3 << 33, (1 << 36) - 64, 12345677):
        addr = ref.bloom_address(got, size)
        assert [int(a) for a in addr] == [(h & M64) % size
                                          for h in got.tolist()]


def fasta_and_reads(tmp_path, genes, reads):
    fa = tmp_path / "g.fa"
    fa.write_bytes(b"".join(b">g%d x\n%s\n" % (i, g)
                            for i, g in enumerate(genes)))
    fq = tmp_path / "r.fq"
    fq.write_bytes(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r))
                            for i, r in enumerate(reads)))
    return str(fa), [str(fq)]


def test_hand_worked(tmp_path):
    """k = 3. g0 = AAAACCCC holds AAA, AAC, ACC, CCC (canonical); g1 =
    CCCCGGGG holds CCC and CCG (GGG is CCC's reverse complement, CGG
    CCG's). r0 AAAACC: g0, cov 3+1+1+1 = 6 of 6. r1 CCCC: CCC twice, g0
    and g1 tie at (4, 2). r2 GGGGAA: GGG twice hits both genes, GGA and
    GAA nothing; (4, 2) tie, 4 of 6 bases. r3 ANAACC: AAC, ACC, 4 of 5
    valid bases. r4 TTTTT: the reverse strand of AAA, g0, 5 of 5. r5
    ACGTAC: nothing."""
    fa, fq = fasta_and_reads(tmp_path, [b"AAAACCCC", b"CCCCGGGG"],
                             [b"AAAACC", b"CCCC", b"GGGGAA", b"ANAACC",
                              b"TTTTT", b"ACGTAC"])
    want = {0.6: [(0, 0), (1, 0), (1, 1), (2, 0), (2, 1), (3, 0), (4, 0)],
            0.7: [(0, 0), (1, 0), (1, 1), (3, 0), (4, 0)]}
    for c, pairs in want.items():
        index, sample, reads, genes = ref.run(fa, fq, 3, c, 1 << 20, 0,
                                              False, "cpu")
        assert index.address.numel() == 5  # no two k-mers collide
        assert list(zip(reads.tolist(), genes.tolist())) == pairs
    # -s: the ties go
    _, _, reads, genes = ref.run(fa, fq, 3, 0.6, 1 << 20, 0, True, "cpu")
    assert list(zip(reads.tolist(), genes.tolist())) == [(0, 0), (3, 0),
                                                         (4, 0)]
    ssv, (out,) = ref.render(index, sample, *ref.run(
        fa, fq, 3, 0.6, 1 << 20, 0, False, "cpu")[2:])
    assert ssv.startswith(b"r0 g0\nr1 g0\nr1 g1\nr2 g0\n")
    assert out.startswith(b"@r0\nAAAACC\n+\nIIIIII\n@r1\nCCCC\n")
    assert b"ACGTAC" not in out
    # forward k-mers only (the control): TTTTT no longer finds g0
    _, _, reads, _ = ref.run(fa, fq, 3, 0.6, 1 << 20, 0, False, "cpu",
                             canonical=False)
    assert 4 not in reads.tolist()


@pytest.mark.parametrize("traffic,extra,share", [
    ("sample", [], 0.6), ("sample", ["-q", "20"], 1.0), ("paired", [], 0.6),
    ("paired", ["-s"], 0.6)])
def test_agrees_with_the_port(tmp_path, monkeypatch, traffic, extra, share):
    """The port's CLI with --backend cpu (the kernels' plain versions)
    writes the reference's bytes."""
    from shark_tpu_torch import cli, config

    monkeypatch.setattr(config, "BF_UNIT_BITS", TEST_BF_UNIT_BITS)
    t = tiny_traffic(traffic, from_genes=share)
    paths = generate.write_inputs(str(tmp_path), {"genes": TINY_GENES}, t,
                                  2 ** 31 + 99)
    out = {n: str(tmp_path / n) for n in ("o.ssv", "o1.fq", "o2.fq")}
    argv = ["-r", paths["fasta"], "-1", paths["fastq"][0], "-o",
            out["o1.fq"], "--ssv", out["o.ssv"], "--backend", "cpu",
            "--batch-size", "256", *extra]
    if len(paths["fastq"]) == 2:
        argv += ["-2", paths["fastq"][1], "-p", out["o2.fq"]]
    assert cli.main(argv) == 0
    q = int(extra[1]) if "-q" in extra else 0
    index, sample, reads, genes = ref.run(
        paths["fasta"], paths["fastq"], 17, 0.6, TEST_BF_UNIT_BITS, q,
        "-s" in extra, "cpu")
    ssv, fastq = ref.render(index, sample, reads, genes)
    assert len(reads) > 100
    with open(out["o.ssv"], "rb") as f:
        assert f.read() == ssv
    for name, want in zip(("o1.fq", "o2.fq"), fastq):
        with open(out[name], "rb") as f:
            assert f.read() == want
    assert os.path.exists(out["o2.fq"]) == (traffic == "paired")
