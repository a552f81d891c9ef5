"""The engine's direct planar pack, on the CPU: with no --max-read-len each
batch is packed straight from its reads' bytes at its own width L, and
must hand over the packed and vmask bytes of the fixed-width pack path
(pack_row over CODE and mask_row) at the same L, row for row.

Each auto batch's records are written to a file of their own and streamed
at max_len = L through the fixed-width path; the two batches are held
equal, the rows past the batch's reads included (all zero). The reads hold
every byte the parser admits in a sequence line (ACGT, acgt, N, IUPAC
letters, '.', '-', control bytes and bytes of 0x80 and up), single and
paired, FASTQ, FASTA (empty qual) and both mixed record by record, at
-q 0 and 20, with fused lengths 1, k - 1, k, around 8, 256, 1024 and past
2048, and a short last batch. The engine's direct_rows counter counts
every read (or pair) of the auto stream and none of the fixed one. Where
JAX is installed, shark_tpu's own engine streams the same per-batch
files at the same L and must hand over the same bytes too.
"""

import numpy as np
import pytest

from shark_tpu_torch.io import native
from shark_tpu_torch.pipeline import _round_len

K, B = 7, 8
# every byte but the line breaks and the bytes that open a header or a
# FASTQ separator line
ADMITTED = bytes(c for c in range(256) if c not in b"\n\r+>@")
COMMON = b"ACGTacgt"
# fused lengths of each batch, in stream order: widths 8, 16, 24, 256,
# 264, 1024, 1056, 4096 and the rounded lengths of short reads
BATCHES = [
    [1, 2, 3, 4, 5, 6, 7, 8],
    [K - 1, K, 9, 8, 7, 1, 9, 3],
    [K, K - 1, 24, 17, 1, 12, 23, 20],
    [255, 256, 100, 1, 250, 40, 256, 3],
    [257, 255, 256, 8, 9, 101, 60, 2],
    [1023, 1024, 1000, 5, 300, 700, 1024, 33],
    [1025, 1023, 8, 9, 500, 200, 77, 100],
    [2049, 100, 101, 2048, 1, 7, 1500, 99],
    [len(ADMITTED), 100, 150, 35, 151, 88, 36, 100],
    [100, 2, 57],  # the short last batch: rows 3-7 stay zero
]
# name: (paired, mate formats ("q" FASTQ, "a" FASTA, "m" alternating per
# record, mate 2 starting on the other), min quality)
CASES = {
    "single_fastq_q0": (False, "q", 0),
    "single_fastq_q20": (False, "q", 20),
    "single_fasta_q20": (False, "a", 20),
    "paired_fastq_q0": (True, "q", 0),
    "paired_fastq_q20": (True, "q", 20),
    "paired_fasta_q20": (True, "a", 20),
    "paired_mixed_q20": (True, "m", 20),
}


@pytest.fixture(autouse=True)
def engine():
    if not native.available():
        pytest.skip("the C++ engine (g++) is needed")


def _seq(rng, n):
    """n bytes, three in four a base, the rest drawn from ADMITTED."""
    common = rng.choice(np.frombuffer(COMMON, np.uint8), n)
    other = rng.choice(np.frombuffer(ADMITTED, np.uint8), n)
    return np.where(rng.random(n) < 0.75, common, other).astype(
        np.uint8).tobytes()


def _qual(rng, n):
    """Phred+33 around the -q 20 cut (53), some control and high bytes."""
    q = rng.integers(33, 75, n).astype(np.uint8)
    odd = rng.random(n) < 0.1
    q[odd] = rng.choice(np.frombuffer(b"\x01\x1f !\x7f\x80\xc8\xff", np.uint8),
                        int(odd.sum()))
    return q.tobytes()


def _record(i, seq, qual, fmt):
    """One record; every fifth FASTQ record in CRLF and every FASTA record
    wrapped at 60 bases, so the engine's general parse path runs too."""
    if fmt == "a":
        lines = [seq[j:j + 60] for j in range(0, len(seq), 60)]
        return b">r%d x\n" % i + b"".join(line + b"\n" for line in lines)
    eol = b"\r\n" if i % 5 == 4 else b"\n"
    return b"@r%d x" % i + eol + seq + eol + b"+" + eol + qual + eol


def _reads(paired, rng):
    """Per batch, per read: ((seq1, qual1), (seq2, qual2) or None)."""
    batches = []
    for lens in BATCHES:
        batch = []
        for j, fused in enumerate(lens):
            if fused == len(ADMITTED) and j == 0:
                mates = [ADMITTED] if not paired else [
                    ADMITTED[:100], ADMITTED[101:]]
            elif paired and fused >= 3:
                n1 = int(rng.integers(1, fused - 1))
                mates = [_seq(rng, n1), _seq(rng, fused - 1 - n1)]
            elif paired:  # fused 1 or 2 cannot pair: the shortest pair
                mates = [_seq(rng, 1), _seq(rng, 1)]
            else:
                mates = [_seq(rng, fused)]
            mates = [(s, _qual(rng, len(s))) for s in mates]
            batch.append((mates[0], mates[1] if paired else None))
        batches.append(batch)
    return batches


def _write(path, reads, side, fmt):
    with open(path, "wb") as f:
        for i, read in enumerate(reads):
            seq, qual = read[side]
            rf = fmt if fmt != "m" else "qa"[(i + side) % 2]
            f.write(_record(i, seq, qual, rf))


def _files(tmp, name, reads, paired, fmt):
    f1, f2 = str(tmp / f"{name}_1.fx"), str(tmp / f"{name}_2.fx")
    _write(f1, reads, 0, fmt)
    if paired:
        _write(f2, reads, 1, fmt)
    return f1, f2 if paired else ""


def _batches(ns):
    out = []
    while (got := ns.next_batch()) is not None:
        packed, vmask, slot, n = got
        ns.release(slot)
        out.append((packed, vmask, n))
    return out


def _auto(tmp_path, case):
    """The case's reads by batch and the auto stream's batches of them,
    with its direct_rows counter."""
    paired, fmt, mq = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    batches = _reads(paired, rng)
    flat = [r for b in batches for r in b]
    ns = native.NativeStream(*_files(tmp_path, "all", flat, paired, fmt), B,
                             0, mq, packed=True, k=K)
    got = _batches(ns)
    direct = ns.stats()["direct_rows"]
    ns.close()
    return batches, got, direct


def _fixed_files(tmp_path, case, batches, got):
    """Per auto batch: its width L, its reads' own files, and what the
    auto stream handed over for it."""
    paired, fmt, _ = CASES[case]
    for i, ((packed, vmask, n), reads) in enumerate(zip(got, batches)):
        fused = max(len(r[0][0]) + (1 + len(r[1][0]) if paired else 0)
                    for r in reads)
        L = _round_len(fused, K)
        yield i, L, _files(tmp_path, f"b{i}", reads, paired, fmt), (
            packed, vmask, n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_direct_pack_writes_the_fixed_width_paths_bytes(tmp_path, case):
    paired, fmt, mq = CASES[case]
    batches, got, direct = _auto(tmp_path, case)
    flat = [r for b in batches for r in b]
    assert direct == len(flat)
    assert [n for _, _, n in got] == [len(b) for b in batches]
    for i, L, files, (packed, vmask, n) in _fixed_files(tmp_path, case,
                                                        batches, got):
        assert packed.shape == (B, L // 4) and vmask.shape == (B, L // 8)
        assert not packed[n:].any() and not vmask[n:].any()
        fixed = native.NativeStream(*files, B, L, mq, packed=True)
        [(want_p, want_v, want_n)] = _batches(fixed)
        assert fixed.stats()["direct_rows"] == 0
        fixed.close()
        assert want_n == n
        np.testing.assert_array_equal(packed, want_p, err_msg=f"batch {i}")
        np.testing.assert_array_equal(vmask, want_v, err_msg=f"batch {i}")
    if mq:  # the mask masked some valid base, but where nothing has a qual
        nomask = native.NativeStream(
            *_files(tmp_path, "all", flat, paired, fmt), B, 0, 0,
            packed=True, k=K)
        masked = any((v0 != v).any() for (_, v0, _), (_, v, _)
                     in zip(_batches(nomask), got))
        nomask.close()
        assert masked == (paired or fmt != "a")


@pytest.mark.parametrize("case", sorted(CASES))
def test_direct_pack_writes_shark_tpus_bytes(tmp_path, case):
    """Each auto batch's reads, streamed through shark_tpu's own engine at
    the batch's width, give the auto stream's packed and vmask bytes."""
    pytest.importorskip("jax")
    from shark_tpu.io import native as jnative

    if jnative.get_lib() is None:
        pytest.skip("shark_tpu's engine did not build")
    mq = CASES[case][2]
    batches, got, _ = _auto(tmp_path, case)
    for i, L, files, (packed, vmask, n) in _fixed_files(tmp_path, case,
                                                        batches, got):
        theirs = jnative.NativeStream(*files, B, L, mq, packed=True)
        [(want_p, want_v, want_n)] = _batches(theirs)
        theirs.close()
        assert want_n == n
        np.testing.assert_array_equal(packed, want_p, err_msg=f"batch {i}")
        np.testing.assert_array_equal(vmask, want_v, err_msg=f"batch {i}")
