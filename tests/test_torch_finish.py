"""K3, the finish of shark_tpu_torch, against shark_tpu's finish_from_tags.

The same (tag, payload) windows — made by shark_tpu's front end and probe
from reads drawn with numpy from a seed — go through shark_tpu's
finish_from_tags and the port's plain finish (finish_from_tags on CPU
tensors). packed, winners and best_cov must be equal bit for bit across
the three group tiers (no impure read; impure reads within FIX_CAP; past
FIX_CAP2, where the whole batch takes full verdicts), the extension-row
geometry and an impure read at the last batch index. Key-heavy reads,
past the warp cap of the CUDA finish (step.FINISH_WARP_CAP), are held to
shark_tpu too: the plain version that the card tests trust for the
kernel's block path is checked in that regime. The CUDA kernel
(csrc/finish.cu) is held against the plain version on the card by
chip_smoke.py and tests/test_torch_cuda.py."""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from shark_tpu.classify import step as jstep  # noqa: E402
from shark_tpu_torch.classify import step as tstep  # noqa: E402
from shark_tpu_torch.convert import index_from_arrays  # noqa: E402
from test_groups import _encode, _sample, family_workload  # noqa: E402,F401
from test_homology import _high_degree_workload  # noqa: E402
from test_torch_cuda import family_index, finish_batch  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

from shark_tpu.index.build import build_index  # noqa: E402


def shark_tpu_tags(index, codes):
    """(tagv, payv, length) of shark_tpu's classic front end and probe."""
    L = codes.shape[1]
    meta = jstep.StaticMeta.for_index(index, L)
    dix = jstep.DeviceIndex(
        *(jnp.asarray(a) if a is not None else None
          for a in jstep.build_device_index(index))
    )

    @jax.jit
    def tags(codes):
        word_idx, bit_off, win_valid = jstep.hash_positions(codes, meta)
        tagv, payv = jstep.probe_tags(dix, word_idx, bit_off, win_valid)
        return tagv, payv, jnp.sum((codes < 4).astype(jnp.int32), axis=1)

    return [np.array(x) for x in tags(jnp.asarray(codes))], dix, meta


def finish_both(index, codes, max_winners=8, c=0.6):
    """(shark_tpu, port) finish outputs (packed, winners, best_cov)."""
    (tagv, payv, length), _, _ = shark_tpu_tags(index, codes)
    return finish_tags_both(index, tagv, payv, length, codes.shape[1],
                            max_winners, c)[0]


def finish_tags_both(index, tagv, payv, length, L, max_winners=8, c=0.6):
    """shark_tpu's and the port's finish of the same (tag, payload)
    windows must be equal; returns (shark_tpu's outputs, the port's
    finish_heavy_reads_plain mask)."""
    meta = jstep.StaticMeta.for_index(index, L)
    dix = jstep.DeviceIndex(
        *(jnp.asarray(a) if a is not None else None
          for a in jstep.build_device_index(index))
    )
    thresh = jstep.emit_threshold_table(c, L)
    has_rows = bool((np.diff(index.offsets) >= 3).any())
    jfin = jax.jit(functools.partial(
        jstep.finish_from_tags, rows3=dix.rows3, ext_mat=dix.ext_mat,
        meta=meta, max_winners=max_winners, L=L, has_rows=has_rows,
    ))
    want = [np.asarray(x) for x in jfin(tagv, payv, length, thresh)]

    tindex = index_of(index)
    rows3, ext_mat = tstep.build_rows3(tindex)
    got = tstep.finish_from_tags(
        torch.from_numpy(tagv), torch.from_numpy(payv),
        torch.from_numpy(length), torch.from_numpy(thresh),
        rows3=torch.from_numpy(rows3),
        ext_mat=torch.from_numpy(ext_mat) if ext_mat is not None else None,
        meta=tstep.StaticMeta.for_index(tindex, L), max_winners=max_winners,
        L=L, has_rows=has_rows,
    )
    got = [x.numpy() for x in got]
    for name, w, g in zip(("packed", "winners", "best_cov", "length"), want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)
    heavy = tstep.finish_heavy_reads_plain(
        torch.from_numpy(tagv), torch.from_numpy(payv),
        rows3=torch.from_numpy(rows3),
        ext_mat=torch.from_numpy(ext_mat) if ext_mat is not None else None,
        meta=tstep.StaticMeta.for_index(tindex, L), L=L, has_rows=has_rows)
    return want, heavy.numpy()


def index_of(index):
    """The port's copy of a shark_tpu index, with its forced geometries."""
    tindex = index_from_arrays(vars(index))
    for key in ("_row_geometry", "_row_geometry3"):
        if key in index.__dict__:
            tindex.__dict__[key] = index.__dict__[key]
    return tindex


def straddlers(rng, records, n):
    reads = []
    for _ in range(n):
        _, seq = records[rng.integers(0, len(records))]
        start = int(rng.integers(30, 90))  # across the flank/core boundary
        reads.append(seq[start:start + 90])
    return reads


def grp_count(packed):
    return int(((packed >> jstep.PACK_GRP_SHIFT) & 1).sum())


def test_finish_tier_no_impure_reads(family_workload):
    records, index, _ = family_workload
    rng = np.random.default_rng(1)
    reads = _sample(rng, records, 120, "core") + _sample(
        rng, records, 40, "flank"
    )
    packed = finish_both(index, _encode(reads))[0]
    assert grp_count(packed) >= 100  # group verdicts engaged


def test_finish_tier_impure_within_fix_cap(family_workload):
    records, index, _ = family_workload
    rng = np.random.default_rng(2)
    reads = (_sample(rng, records, 300, "core")
             + _sample(rng, records, 172, "flank")
             + straddlers(rng, records, 40))
    packed = finish_both(index, _encode(reads))[0]
    assert grp_count(packed) >= 250  # pure reads keep group verdicts


def test_finish_tier_past_fix_cap2(family_workload):
    records, index, _ = family_workload
    rng = np.random.default_rng(3)
    packed = finish_both(index, _encode(straddlers(rng, records, 200)))[0]
    assert grp_count(packed) == 0  # every read takes its full verdict


def test_finish_impure_last_read(family_workload):
    """test_groups.test_impure_last_read_exact's batch: a chimera of two
    family cores (row hits with two group ids) at the last index."""
    records, index, _ = family_workload
    rng = np.random.default_rng(9)
    reads = _sample(rng, records, 120, "core") + _sample(
        rng, records, 7, "flank"
    )
    reads.append(records[0][1][110:155] + records[39][1][110:155])
    packed = finish_both(index, _encode(reads))[0]
    assert not (packed[-1] >> jstep.PACK_GRP_SHIFT) & 1


def test_finish_extension_rows():
    """test_homology.test_high_degree_rows_match_oracle[40]: a 40-member
    family with the capped D=8 + extension geometry forced."""
    index, _, reads = _high_degree_workload(40)
    index.__dict__["_row_geometry"] = (8, 64)
    index.__dict__["_row_geometry3"] = (8, 64)
    assert jstep.build_rows3(index)[1] is not None  # extension rows exist
    packed = finish_both(index, _encode(reads, L=128), max_winners=24)[0]
    # core reads have more extension windows than EXT_CAP2: overflow bit
    assert ((packed >> jstep.PACK_OVF_SHIFT) & 1).any()


def test_finish_key_heavy_reads():
    """test_homology's 12-member family (deg-12 rows, D = 16) with 200
    reads: a read with more than 21 core windows has more keys than the
    warp cap, the singletons' reads far fewer."""
    index, _, reads = _high_degree_workload(12)
    codes = _encode(reads)
    (tagv, payv, length), _, _ = shark_tpu_tags(index, codes)
    want, heavy = finish_tags_both(index, tagv, payv, length, codes.shape[1])
    assert heavy.any() and not heavy.all()


@pytest.mark.parametrize("mix", ["no_impure", "within_cap", "past_cap2"])
def test_finish_tiers_across_the_warp_cap(mix):
    """test_torch_cuda's synthetic batches at each group tier: reads on
    both sides of the warp cap (direct, pure and impure; few and many
    keys), the same windows through shark_tpu and the port."""
    records, _ = family_index()
    index = build_index(records, 15, 1 << 26)
    tagv, payv, length, _ = finish_batch(index_of(index), mix)
    want, heavy = finish_tags_both(index, tagv, payv, length, 160)
    assert heavy.any() and not heavy.all()
    assert (grp_count(want[0]) > 0) == (mix != "past_cap2")
