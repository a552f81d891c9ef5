"""K2, the hashed probe of shark_tpu_torch, and the host tables it reads.

The port's table builders (index build, hashed table and stash, rows3)
are copies of shark_tpu's and must build identical arrays; an index saved
by either package must load in the other. The plain probe (probe_hashed on
CPU tensors) must give the (tag, payload) stream of shark_tpu's classic
probe (step.probe_tags) on the same index, for the entry16 and the entry8
layouts: tags everywhere, payloads where tag != 0 (the classic probe
decodes a miss's payload from row 0, the hashed one gives 0). The CUDA
kernel (csrc/probe.cu) is held against the plain version on the card by
chip_smoke.py."""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from shark_tpu.classify import hashed as jhashed  # noqa: E402
from shark_tpu.classify import step as jstep  # noqa: E402
from shark_tpu.index.build import build_index as jbuild  # noqa: E402
from shark_tpu.index.structure import SharkIndex as JIndex  # noqa: E402
from shark_tpu.ops.kmers import encode_bytes  # noqa: E402
from shark_tpu_torch.classify import hashed as thashed  # noqa: E402
from shark_tpu_torch.classify import step as tstep  # noqa: E402
from shark_tpu_torch.convert import (  # noqa: E402
    hashed_device_index,
    index_from_arrays,
)
from shark_tpu_torch.index.build import build_index as tbuild  # noqa: E402
from shark_tpu_torch.index.structure import SharkIndex as TIndex  # noqa: E402

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
K = 15
SIZE_BITS = 1 << 24  # small filter: collisions merge rows, buckets spill


@pytest.fixture(scope="module")
def workload():
    """Families sharing cores (degree >= 3 rows, group ids) plus singleton
    genes, and reads from anywhere plus random reads (misses)."""
    rng = np.random.default_rng(21)
    records = []
    for fam in range(6):
        core = BASES[rng.integers(0, 4, size=120)]
        for m in range(4):
            seq = np.concatenate([
                BASES[rng.integers(0, 4, size=200)], core,
                BASES[rng.integers(0, 4, size=200)],
            ])
            records.append((f"F{fam}M{m}", seq.tobytes()))
    for g in range(40):
        records.append((f"S{g}", BASES[rng.integers(0, 4, size=800)].tobytes()))
    reads = []
    for _ in range(160):
        _, seq = records[rng.integers(0, len(records))]
        start = int(rng.integers(0, len(seq) - 90))
        reads.append(seq[start:start + 90])
    for _ in range(32):
        reads.append(BASES[rng.integers(0, 4, size=90)].tobytes())
    codes = np.full((len(reads), 96), 4, np.uint8)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = encode_bytes(r)
    return records, jbuild(records, K, SIZE_BITS), codes


def test_index_build_matches_shark_tpu(workload):
    records, jindex, _ = workload
    tindex = tbuild(records, K, SIZE_BITS)
    for name in ("bf_words", "word_rank", "offsets", "gene_ids"):
        np.testing.assert_array_equal(
            getattr(tindex, name), getattr(jindex, name), err_msg=name
        )
    assert tindex.gene_names == jindex.gene_names


@pytest.mark.parametrize("fmt", [".npz", "/"])
def test_saved_index_loads_in_both_packages(workload, tmp_path, fmt):
    _, jindex, _ = workload
    for save_cls, load_cls, tag in ((JIndex, TIndex, "j"), (TIndex, JIndex, "t")):
        src = save_cls(**vars(jindex))
        path = str(tmp_path / f"idx_{tag}") + fmt
        src.save(path)
        got = load_cls.load(path)
        for name in ("bf_words", "word_rank", "offsets", "gene_ids"):
            np.testing.assert_array_equal(
                np.asarray(getattr(got, name)), getattr(jindex, name)
            )
        assert (got.k, got.size_bits, got.gene_names) == (
            jindex.k, jindex.size_bits, jindex.gene_names,
        )
        if fmt == "/":
            assert os.path.exists(os.path.join(path, "digest.json"))


@pytest.mark.parametrize("allow16", [True, False], ids=["entry16", "entry8"])
def test_hashed_probe_matches_classic(workload, allow16):
    _, jindex, codes = workload
    tindex = index_from_arrays(vars(jindex))
    jt = jhashed.build_hashed_index(jindex, allow16=allow16)
    tt = thashed.build_hashed_index(tindex, allow16=allow16)
    np.testing.assert_array_equal(tt[0], jt[0])  # bucket table
    np.testing.assert_array_equal(tt[1], jt[1])  # padded stash
    assert vars(tt[2]) == vars(jt[2])
    assert tt[2].entry16 == allow16
    assert (tt[1][:, 1] != 0xFFFFFFFF).any(), "no stash rows to probe"
    for want, got in zip(jstep.build_rows3(jindex), tstep.build_rows3(tindex)):
        np.testing.assert_array_equal(got, want)

    L = codes.shape[1]
    meta = jstep.StaticMeta.for_index(jindex, L)
    idx_hi, idx_lo, win_valid = jstep.bloom_positions(jnp.asarray(codes), meta)
    word_idx = ((idx_hi << 27) | (idx_lo >> 5)).astype(jnp.int32)
    cdix = jstep.DeviceIndex(
        *(jnp.asarray(a) if a is not None else None
          for a in jstep.build_device_index(jindex))
    )
    want_tag, want_pay = (
        np.asarray(x)
        for x in jax.jit(jstep.probe_tags)(cdix, word_idx, idx_lo & 31, win_valid)
    )
    dix, hmeta = hashed_device_index(
        tt[0], tt[1], *tstep.build_rows3(tindex), tt[2], "cpu"
    )
    tag, pay = thashed.probe_hashed(
        torch.from_numpy(np.array(idx_hi)),
        torch.from_numpy(np.array(idx_lo)),
        torch.from_numpy(np.array(win_valid)),
        dix.table, dix.stash, hmeta,
    )
    tag, pay = tag.numpy(), pay.numpy()
    np.testing.assert_array_equal(tag, want_tag)
    hit = want_tag != 0
    np.testing.assert_array_equal(pay[hit], want_pay[hit])
    np.testing.assert_array_equal(pay[~hit], 0)
    for t in (1, 2, 3):
        assert (want_tag == t).any(), f"no tag-{t} windows"


def test_probe_table_cache_is_shared_with_shark_tpu(workload, tmp_path):
    """A hashed table cached by shark_tpu is loaded by the port (same key,
    same arrays). The xl kind: tests/test_torch_xl.py."""
    from shark_tpu.classify import table_cache as jcache
    from shark_tpu_torch.classify import table_cache as tcache

    _, jindex, codes = workload
    tindex = index_from_arrays(vars(jindex))
    d = str(tmp_path / "hashed.tables")
    want = jstep.Classifier(jindex, probe_opts={"cache_dir": d})(codes)
    jcache.join_pending()
    kind, arrays = tcache.load_tables(d, tindex, None)
    assert kind == "hashed"
    got = tstep.Classifier(tindex, device="cpu",
                           probe_opts={"cache_dir": d})(codes)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
