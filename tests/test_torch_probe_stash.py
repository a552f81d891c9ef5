"""K2's stash, held against shark_tpu on the CPU.

The card's hashed probe (csrc/probe.cu) reads the stash rows before the
stash's trailing padding rows, a count the port derives on the host
(hashed.stash_rows_before_pad, kept in HashedDeviceIndex.stash_rows), and
adds the padding rows in closed form. These tests hold that count to
shark_tpu's padded stash on the fuzz workloads (tests/test_e2e_fuzz.py)
and on small filters whose buckets spill, and hold the plain probe, on
windows that do match stash rows, to shark_tpu's classic probe. The kernel
itself is held to the plain probe on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from shark_tpu.classify import hashed as jhashed  # noqa: E402
from shark_tpu.classify import step as jstep  # noqa: E402
from shark_tpu.index.build import build_index as jbuild  # noqa: E402
from shark_tpu.ops.kmers import encode_bytes  # noqa: E402
from shark_tpu_torch.classify import hashed as thashed  # noqa: E402
from shark_tpu_torch.classify import step as tstep  # noqa: E402
from shark_tpu_torch.convert import (  # noqa: E402
    hashed_device_index,
    index_from_arrays,
)
from test_e2e_fuzz import BASES, _random_workload  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

PAD = 0xFFFFFFFF


def _records(seed, size_bits, n_fam=6, members=4, singles=40):
    """test_torch_probe's workload shape: families sharing a core (rows of
    degree >= 3) and singleton genes, at a small filter so that
    collisions merge rows and buckets spill to the stash."""
    rng = np.random.default_rng(seed)
    records = []
    for fam in range(n_fam):
        core = BASES[rng.integers(0, 4, size=120)]
        for m in range(members):
            seq = np.concatenate([BASES[rng.integers(0, 4, size=200)], core,
                                  BASES[rng.integers(0, 4, size=200)]])
            records.append((f"F{fam}M{m}", seq.tobytes()))
    for g in range(singles):
        records.append((f"S{g}", BASES[rng.integers(0, 4, size=800)].tobytes()))
    return records, jbuild(records, 15, size_bits)


def _tiling_codes(records, read_len=90, step=60, L=96):
    """Reads tiling every gene end to end, so that every k-mer of the
    index, the stash's positions among them, is probed."""
    reads = []
    for _, seq in records:
        for s in range(0, max(1, len(seq) - read_len + step), step):
            reads.append(seq[s:s + read_len])
    codes = np.full((len(reads), L), 4, np.uint8)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = encode_bytes(r)
    return codes


def _stash_positions(stash, n):
    return stash[:n, 0].astype(np.uint64) | (
        stash[:n, 1].astype(np.uint64) << np.uint64(32))


def _check_count(jindex):
    """The port's count of stash rows K2 reads, against shark_tpu's padded
    stash: the rows before it are shark_tpu's spills (set Bloom bits),
    every row after it is padding. Returns the count."""
    jt = jhashed.build_hashed_index(jindex)
    tindex = index_from_arrays(vars(jindex))
    tt = thashed.build_hashed_index(tindex)
    np.testing.assert_array_equal(tt[1], jt[1])
    stash = np.asarray(jt[1])
    n = thashed.stash_rows_before_pad(stash)
    assert (stash[n:] == PAD).all()
    assert n == 0 or (stash[n - 1] != PAD).any()
    real = (stash != PAD).any(axis=1)
    assert int(real.sum()) == n  # no padding row among the spills
    pos = _stash_positions(stash, n)
    words = np.asarray(jindex.bf_words).astype(np.uint64)
    bits = (words[(pos >> np.uint64(5)).astype(np.int64)]
            >> (pos & np.uint64(31))) & np.uint64(1)
    assert (bits == 1).all(), "a stash row that is no set Bloom bit"
    dix, _ = hashed_device_index(jt[0], jt[1], *tstep.build_rows3(tindex),
                                 jt[2], "cpu")
    assert dix.stash_rows == n
    return n


@pytest.mark.parametrize("size_bits", [1 << 33, 1 << 16],
                         ids=["fuzz_filter", "small_filter"])
@pytest.mark.parametrize("seed", range(6))
def test_stash_rows_match_shark_tpu_on_fuzz_workloads(tmp_path, seed,
                                                      size_bits):
    w = _random_workload(np.random.default_rng(1000 + seed), tmp_path, seed)
    _check_count(jbuild(w["genes"], w["k"], size_bits))


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_stash_rows_of_spilling_indexes(seed):
    _, jindex = _records(seed, 1 << 24)
    assert _check_count(jindex) > 0
    tindex = index_from_arrays(vars(jindex))
    clf = tstep.Classifier(tindex, device="cpu")
    assert clf.probe == "hashed"
    assert clf.dix.stash_rows == thashed.stash_rows_before_pad(
        clf.dix.stash.numpy())


def test_stash_rows_before_pad_counts_only_trailing_padding():
    pad = np.full((1, 4), PAD, np.uint32)
    row = np.array([[5, 1, 2, 7]], np.uint32)
    for rows, want in [((), 0), ((pad,) * 32, 0), ((row,), 1),
                       ((row, pad, pad), 1), ((pad, row, pad), 2),
                       ((row, pad, row) + (pad,) * 29, 3),
                       ((row,) * 40, 40)]:
        stash = (np.concatenate(rows) if rows
                 else np.empty((0, 4), np.uint32))
        assert thashed.stash_rows_before_pad(stash) == want


@pytest.mark.parametrize("allow16", [True, False], ids=["entry16", "entry8"])
def test_plain_probe_hits_stash_rows_like_shark_tpu(allow16):
    """The plain probe on windows that match stash rows (reads tiling every
    gene of a small-filter index): shark_tpu's classic probe's tags
    everywhere, its payloads where the tag is not 0."""
    records, jindex = _records(21, 1 << 24)
    tindex = index_from_arrays(vars(jindex))
    table, stash, hmeta = thashed.build_hashed_index(tindex, allow16=allow16)
    assert hmeta.entry16 == allow16
    n = thashed.stash_rows_before_pad(stash)
    assert n > 0
    codes = _tiling_codes(records)
    meta = jstep.StaticMeta.for_index(jindex, codes.shape[1])
    idx_hi, idx_lo, win_valid = jstep.bloom_positions(jnp.asarray(codes),
                                                      meta)
    hi, lo, valid = (np.asarray(a) for a in (idx_hi, idx_lo, win_valid))
    pos = hi.astype(np.uint64) << np.uint64(32) | lo.astype(np.uint64)
    in_stash = np.isin(pos, _stash_positions(stash, n)) & valid
    assert in_stash.sum() > 0, "no window matches a stash row"

    word_idx = ((idx_hi << 27) | (idx_lo >> 5)).astype(jnp.int32)
    cdix = jstep.DeviceIndex(
        *(jnp.asarray(a) if a is not None else None
          for a in jstep.build_device_index(jindex)))
    want_tag, want_pay = (np.asarray(x) for x in jax.jit(jstep.probe_tags)(
        cdix, word_idx, idx_lo & 31, win_valid))
    dix, hmeta = hashed_device_index(table, stash,
                                     *tstep.build_rows3(tindex), hmeta,
                                     "cpu")
    tag, pay = thashed.probe_hashed(
        torch.from_numpy(hi), torch.from_numpy(lo), torch.from_numpy(valid),
        dix.table, dix.stash, hmeta, dix.stash_rows)
    tag, pay = tag.numpy(), pay.numpy()
    np.testing.assert_array_equal(tag, want_tag)
    hit = want_tag != 0
    np.testing.assert_array_equal(pay[hit], want_pay[hit])
    np.testing.assert_array_equal(pay[~hit], 0)
    assert (tag[in_stash] != 0).all()
