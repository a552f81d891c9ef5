"""K6, the xl probe layout of shark_tpu_torch, against shark_tpu.

The xl layout is what both packages take at transcriptome scale, where the
hashed table passes its byte or stash budget: 16-byte buckets with a
13-bit rest, an overflow flag in slot 0, and a side table for the
spills. On the CPU the port must build shark_tpu's xl arrays, through
the native pack and through the numpy pack; its Classifier must return
shark_tpu's outputs bit for bit at the natural geometry, at a pinned
spill-heavy geometry, and where shark_tpu takes its full-width side
branch; its plain probe must give the classic probe's tags; auto
selection must pick the layout shark_tpu picks; and either package must
load the other's cached xl tables. Inputs are those of
tests/test_hashed_fuzz.py's xl tests, made with numpy from seeds; every
comparison is exact."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from shark_tpu.classify import hashed as jhashed  # noqa: E402
from shark_tpu.classify import step as jstep  # noqa: E402
from shark_tpu.classify import table_cache as jcache  # noqa: E402
from shark_tpu.index.build import build_index as jbuild  # noqa: E402
from shark_tpu.io import native as jnative  # noqa: E402
from shark_tpu_torch.classify import hashed as thashed  # noqa: E402
from shark_tpu_torch.classify import step as tstep  # noqa: E402
from shark_tpu_torch.classify import table_cache as tcache  # noqa: E402
from shark_tpu_torch.convert import index_from_arrays  # noqa: E402
from shark_tpu_torch.io import native as tnative  # noqa: E402
from test_hashed_fuzz import BASES, _random_records, _reads_codes  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401


def _fuzz_workload(seed):
    """test_xl_vs_classic_fuzz's index and reads for `seed`."""
    rng = np.random.default_rng(100 + seed)
    core = BASES[rng.integers(0, 4, size=60 + 10 * seed)].tobytes()
    recs = []
    for g in range(30 + 4 * seed):
        seq = BASES[rng.integers(0, 4, size=500)].tobytes()
        if g % 2 == 0:  # shared core -> deg>=3 rows -> TAG_ROW via side too
            seq = seq[:200] + core + seq[200 + len(core):]
        recs.append((f"G{g}", seq))
    index = jbuild(recs, 11, 1 << 16)
    return index, _reads_codes(rng, recs, n_reads=160, read_len=90, L=96)


def _no_spill_workload():
    """test_xl_no_spill_geometry's index and reads."""
    rng = np.random.default_rng(11)
    recs = _random_records(rng, 6, 300)
    index = jbuild(recs, 17, 1 << 18)
    return index, _reads_codes(rng, recs, n_reads=96, read_len=80, L=88)


@pytest.fixture(scope="module")
def workloads():
    out = {seed: _fuzz_workload(seed) for seed in range(4)}
    out["no_spill"] = _no_spill_workload()
    return out


# name -> (workload, probe_opts, whether the geometry spills)
GEOMETRIES = {
    "natural": (0, {}, None),
    "spill": (0, {"lgB": 13}, True),
    "no_spill": ("no_spill", {"lgB": 14}, False),
}


def _port(index):
    return index_from_arrays(vars(index))


def _equal_outputs(want, got):
    for name, w, g in zip(("packed", "winners", "best_cov", "length"),
                          want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("pack", ["native", "numpy"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_build_hashed_xl_matches_shark_tpu(workloads, monkeypatch, geometry,
                                           pack):
    """Like with like: both packages through the native pack, or both
    through the numpy pack (the two packs may pick lgB one apart)."""
    if pack == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    elif not jnative.available():
        pytest.skip("native engine unavailable")
    wl, opts, spills = GEOMETRIES[geometry]
    index, _ = workloads[wl]
    want = jhashed.build_hashed_xl(index, **opts)
    got = thashed.build_hashed_xl(_port(index), **opts)
    for name, w, g in zip(("table", "side", "side_stash"), want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert vars(got[3]) == vars(want[3])
    assert got[3].xl and got[3].slots == thashed.XL_SLOTS
    if spills is not None:
        assert got[3].has_side == spills


@pytest.mark.parametrize("mode", ["natural", "spill", "full_side"])
@pytest.mark.parametrize("seed", range(4))
def test_xl_classifier_matches_shark_tpu(workloads, monkeypatch, seed, mode):
    """`full_side` shrinks shark_tpu's XL_SIDE_CAP to 1, so reads with two
    or more side windows take its full-width side branch; the port's
    per-window resolve must equal that branch as well as the compacted
    one."""
    index, codes = workloads[seed]
    opts = {} if mode == "natural" else {"lgB": 13}
    if mode == "full_side":
        monkeypatch.setattr(jhashed, "XL_SIDE_CAP", 1)
    jclf = jstep.Classifier(index, max_winners=24, probe="xl",
                            probe_opts=opts)
    tclf = tstep.Classifier(_port(index), max_winners=24, probe="xl",
                            probe_opts=opts, device="cpu")
    assert tclf.probe == jclf.probe == "xl"
    assert vars(tclf._hmeta) == vars(jclf._hmeta)
    _equal_outputs(jclf(codes), tclf(codes))
    if mode == "full_side":
        assert tclf._hmeta.has_side
        assert _side_windows_per_read(tclf, codes).max() > 1


def _side_windows_per_read(clf, codes):
    """Windows per read that resolve through the side table."""
    meta, _ = clf._geometry(codes.shape[1])
    hi, lo, valid, _ = tstep.front_end_plain(
        *tstep.pack_codes(torch.from_numpy(codes)), meta)
    hmeta = clf._hmeta
    bucket = lo.to(torch.int64) & ((1 << hmeta.lgB) - 1)
    row = tstep.gather_u32(clf.dix.table, bucket)
    flagged = ((row[..., 0] >> thashed.XL_FLAG_BIT) & 1) == 1
    no_side = dataclasses.replace(hmeta, has_side=False)
    tag, _ = thashed.probe_xl(hi, lo, valid, clf.dix.table, clf.dix.side,
                              clf.dix.side_stash, no_side)
    return (valid & flagged & (tag == 0)).sum(dim=1).numpy()


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_xl_probe_tags_match_classic_probe(workloads, geometry):
    """The port's xl probe against shark_tpu's classic probe_tags on the
    same index: tags everywhere, payloads where the tag is not 0 (the
    classic probe decodes a miss's payload from pay row 0, xl gives 0)."""
    wl, opts, spills = GEOMETRIES[geometry]
    index, codes = workloads[wl]
    table, side, side_stash, jmeta = jhashed.build_hashed_xl(index, **opts)
    dix, hmeta = thashed.hashed_device_index(
        table, thashed.empty_stash(), *tstep.build_rows3(_port(index)),
        jmeta, "cpu", side=side, side_stash=side_stash)
    meta = jstep.StaticMeta.for_index(index, codes.shape[1])
    idx_hi, idx_lo, win_valid = jstep.bloom_positions(jnp.asarray(codes), meta)
    word_idx = ((idx_hi << 27) | (idx_lo >> 5)).astype(jnp.int32)
    cdix = jstep.DeviceIndex(
        *(jnp.asarray(a) if a is not None else None
          for a in jstep.build_device_index(index)))
    want_tag, want_pay = (
        np.asarray(x) for x in
        jax.jit(jstep.probe_tags)(cdix, word_idx, idx_lo & 31, win_valid))
    args = [torch.from_numpy(np.array(x)) for x in (idx_hi, idx_lo, win_valid)]
    tag, pay = thashed.probe_xl(*args, dix.table, dix.side, dix.side_stash,
                                hmeta)
    tag, pay = tag.numpy(), pay.numpy()
    np.testing.assert_array_equal(tag, want_tag)
    hit = want_tag != 0
    np.testing.assert_array_equal(pay[hit], want_pay[hit])
    np.testing.assert_array_equal(pay[~hit], 0)
    # the side table answers some hits exactly when the geometry spills
    no_side = dataclasses.replace(hmeta, has_side=False)
    tag0, _ = thashed.probe_xl(*args, dix.table, dix.side, dix.side_stash,
                               no_side)
    assert bool((tag0.numpy() != tag).any()) == bool(hmeta.has_side)
    if spills is not None:
        assert hmeta.has_side == spills


@pytest.mark.parametrize(
    "declined,layout",
    [((), "hashed"), (("build_hashed_index",), "xl"),
     (("build_hashed_index", "build_hashed_xl"), "classic")],
    ids=["hashed", "xl", "classic"],
)
def test_auto_selection_matches_shark_tpu(workloads, monkeypatch, declined,
                                          layout):
    """With a layout's build function declining (returning None) in both
    packages, auto selection falls back as shark_tpu's does and both
    agree; a forced layout that cannot be built raises ValueError."""
    index, codes = workloads[1]
    for mod in (jhashed, thashed):
        for name in declined:
            monkeypatch.setattr(mod, name, lambda *a, **k: None)
    jclf = jstep.Classifier(index, max_winners=24)
    tclf = tstep.Classifier(_port(index), max_winners=24, device="cpu")
    assert tclf.probe == jclf.probe == layout
    _equal_outputs(jclf(codes), tclf(codes))
    if layout == "classic":
        # "hashed" falls back to xl only; neither builds here
        for forced in ("hashed", "xl"):
            with pytest.raises(ValueError, match="not buildable"):
                tstep.Classifier(_port(index), probe=forced, device="cpu")


@pytest.mark.parametrize("writer", ["shark_tpu", "port"])
def test_xl_table_cache_is_shared_with_shark_tpu(workloads, monkeypatch,
                                                 tmp_path, writer):
    """xl tables cached by one package load in the other (same key, same
    arrays, no build), and the outputs agree."""
    index, codes = workloads[2]
    tindex = _port(index)
    opts = {"cache_dir": str(tmp_path / "xl.tables"), "lgB": 13}
    if writer == "shark_tpu":
        want = jstep.Classifier(index, max_winners=24, probe="xl",
                                probe_opts=opts)(codes)
        jcache.join_pending()
        reader, reader_mod = "port", thashed
    else:
        tstep.Classifier(tindex, max_winners=24, probe="xl", probe_opts=opts,
                         device="cpu")
        tcache.join_pending()
        reader, reader_mod = "shark_tpu", jhashed
        want = None

    def boom(*a, **k):
        raise AssertionError("cache miss: a table build was called")

    kind, arrays = tcache.load_tables(opts["cache_dir"], tindex, "xl",
                                      lgB=13)
    assert kind == "xl" and arrays[3].has_side
    with monkeypatch.context() as m:
        m.setattr(reader_mod, "build_hashed_index", boom)
        m.setattr(reader_mod, "build_hashed_xl", boom)
        if reader == "port":
            got = tstep.Classifier(tindex, max_winners=24, probe="xl",
                                   probe_opts=opts, device="cpu")(codes)
        else:
            want = jstep.Classifier(index, max_winners=24, probe="xl",
                                    probe_opts=opts)(codes)
    if reader == "shark_tpu":
        got = tstep.Classifier(tindex, max_winners=24, probe="xl",
                               probe_opts={"lgB": 13}, device="cpu")(codes)
    _equal_outputs(want, got)
