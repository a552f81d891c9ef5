"""K5, the classic probe of shark_tpu_torch, against shark_tpu.

The classic layout is the last fallback of auto selection and what
--probe classic forces: a (Bloom word, rank) row per window, then a pay
row. On the CPU the port must build shark_tpu's host tables (bf_rank,
pay, rows3), its plain probe must give shark_tpu's probe_tags stream bit
for bit, miss payloads included (a miss reads pay row 0), and its
Classifier must return shark_tpu's classic outputs. Inputs are made with
numpy from seeds; every comparison is exact."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from shark_tpu.classify import step as jstep  # noqa: E402
from shark_tpu_torch.classify import step as tstep  # noqa: E402
from shark_tpu_torch.convert import index_from_arrays  # noqa: E402
from test_torch_probe import workload  # noqa: E402,F401
from test_torch_xl import _fuzz_workload  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401


@pytest.fixture(scope="module")
def workloads(workload):  # noqa: F811
    """The families-and-singles panel of test_torch_probe (2^24 Bloom
    bits: rows, groups, collisions) and a dense 2^16-bit index of
    test_hashed_fuzz's xl fuzz (heavy collisions, row-free windows)."""
    _, index, codes = workload
    return {"panel": (index, codes), "dense": _fuzz_workload(1)}


def _port(index):
    return index_from_arrays(vars(index))


@pytest.mark.parametrize("name", ["panel", "dense"])
def test_classic_tables_match_shark_tpu(workloads, name):
    index, _ = workloads[name]
    for what, w, g in zip(("bf_rank", "pay", "rows3", "ext_mat"),
                          jstep.build_device_index(index),
                          tstep.build_device_index(_port(index))):
        if w is None:
            assert g is None, what
        else:
            np.testing.assert_array_equal(g, w, err_msg=what)


def _jax_probe(index, codes, bf_rank, pay):
    """shark_tpu's classic probe on the front end of `codes` against the
    given tables: (idx_hi, idx_lo, win_valid), (tag, payload) and (rank,
    hit), as numpy."""
    meta = jstep.StaticMeta.for_index(index, codes.shape[1])
    idx_hi, idx_lo, win_valid = jstep.bloom_positions(jnp.asarray(codes), meta)
    word_idx = ((idx_hi << 27) | (idx_lo >> 5)).astype(jnp.int32)
    cdix = jstep.DeviceIndex(jnp.asarray(bf_rank), jnp.asarray(pay), None)
    tags = jax.jit(jstep.probe_tags)(cdix, word_idx, idx_lo & 31, win_valid)
    rank = jax.jit(jstep.probe_rank)(cdix.bf_rank, word_idx, idx_lo & 31,
                                     win_valid)
    front = [np.array(x) for x in (idx_hi, idx_lo, win_valid)]
    return front, [np.asarray(x) for x in tags], [np.asarray(x) for x in rank]


@pytest.mark.parametrize("row0", ["built", "marked"])
@pytest.mark.parametrize("name", ["panel", "dense"])
def test_probe_tags_match_shark_tpu(workloads, name, row0):
    """Tags and payloads everywhere, misses included; and the rank/hit of
    probe_rank_plain on its own. A miss decodes pay row 0 with its first
    word zeroed; `marked` gives row 0 a second word whose low half is not
    0, so every miss has a payload that is not 0 either."""
    index, codes = workloads[name]
    bf_rank, pay, _, _ = tstep.build_device_index(_port(index))
    if row0 == "marked":
        pay[0, 1] = 0x1234ABCD
    front, (want_tag, want_pay), (want_rank, want_hit) = _jax_probe(
        index, codes, bf_rank, pay)
    hi, lo, valid = (torch.from_numpy(x) for x in front)
    bf_rank, pay = torch.from_numpy(bf_rank), torch.from_numpy(pay)
    tag, payv = tstep.probe_tags(hi, lo, valid, bf_rank, pay)
    assert tag.dtype == payv.dtype == torch.uint32
    np.testing.assert_array_equal(tag.numpy(), want_tag)
    np.testing.assert_array_equal(payv.numpy(), want_pay)
    miss = want_tag == 0
    assert miss.any()
    if row0 == "marked":
        assert (want_pay[miss] == 0xABCD0000).all()
    if name == "panel":
        for t in (1, 2, 3):
            assert (want_tag == t).any(), f"no tag-{t} windows"

    lo64 = lo.to(torch.int64)
    word_idx = (hi.to(torch.int64) << 27) | (lo64 >> 5)
    rank, hit = tstep.probe_rank_plain(bf_rank, word_idx, lo64 & 31, valid)
    np.testing.assert_array_equal(hit.numpy(), want_hit)
    np.testing.assert_array_equal(rank.numpy(), want_rank)


def test_decode_pay_words_matches_shark_tpu():
    rng = np.random.default_rng(4)
    w0 = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    w1 = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    want = [np.asarray(x) for x in
            jstep.decode_pay_words(jnp.asarray(w0), jnp.asarray(w1))]
    got = tstep.decode_pay_words(torch.from_numpy(w0.astype(np.int64)),
                                 torch.from_numpy(w1.astype(np.int64)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


@pytest.mark.parametrize("L", [96, 90])
@pytest.mark.parametrize("name", ["panel", "dense"])
def test_classic_classifier_matches_shark_tpu(workloads, name, L):
    """L = 90 is no multiple of 8 (the port pads it for the planar
    packing)."""
    index, codes = workloads[name]
    codes = np.ascontiguousarray(codes[:, :L])
    want = [np.asarray(x) for x in jstep.Classifier(
        index, max_winners=16, probe="classic")(codes)]
    clf = tstep.Classifier(_port(index), max_winners=16, probe="classic",
                           device="cpu")
    assert clf.probe == "classic"
    got = [x.numpy() for x in clf(codes)]
    for what, w, g in zip(("packed", "winners", "best_cov", "length"),
                          want, got):
        np.testing.assert_array_equal(g, w, err_msg=what)
    assert (want[0] != 0).any()
