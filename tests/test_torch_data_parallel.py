"""The replicated index of shark_tpu_torch (DataParallelClassifier) against
its one-device Classifier and shark_tpu's DataParallelClassifier.

On torch CPU devices ("cpu" and "cpu:0" are two devices to torch; a
device may repeat), the split-and-join classifier must return the one
device Classifier's result tuple bit for bit on the hashed, xl and classic
layouts, and on a tie-heavy batch whose winners leave through the pair
stream (K4's path), and on a batch whose parts alone would take the
finish's GROUP verdicts where the whole batch does not (the choice is
batch-wide, so the parts' group counts are summed); a batch that does not
split evenly is refused; and
run_pipeline through it writes the bytes of a one-device run and of
shark_tpu's DataParallelClassifier on the suite's eight virtual JAX CPU
devices (tests/conftest.py). Every comparison is exact."""

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from shark_tpu.config import SharkConfig as JConfig  # noqa: E402
from shark_tpu.io import native as jnative  # noqa: E402
from shark_tpu.pipeline import load_or_build_index as jload  # noqa: E402
from shark_tpu.pipeline import run_pipeline as jrun  # noqa: E402
from shark_tpu.utils.timers import PhaseTimer  # noqa: E402
from shark_tpu_torch import pipeline  # noqa: E402
from shark_tpu_torch.classify.step import Classifier  # noqa: E402
from shark_tpu_torch.config import SharkConfig  # noqa: E402
from shark_tpu_torch.convert import index_from_arrays  # noqa: E402
from shark_tpu_torch.pipeline import run_pipeline  # noqa: E402
from shark_tpu_torch.parallel.data_parallel import (  # noqa: E402
    DataParallelClassifier,
)
from test_e2e_fuzz import BASES, _random_workload  # noqa: E402
from test_groups import _encode, _sample, family_workload  # noqa: E402,F401
from test_torch_pipeline import _outputs  # noqa: E402
from test_torch_sharded import _planar  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

NAMES = ("packed", "winners", "best_cov", "length")
DEVICE_LISTS = {"two": ["cpu", "cpu:0"], "four": ["cpu"] * 4,
                "mixed": ["cpu:0", "cpu", "cpu:0", "cpu"]}


def _assert_same(got, want):
    assert len(got) == len(want) == 4
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)


def _tie_records(rng):
    """Families of two members (degree-2 ties: the winner-pair stream)
    and of four (group verdicts), test_torch_pipeline's tie workload."""
    records = []
    for fam, members in enumerate([2] * 6 + [4] * 4):
        core = BASES[rng.integers(0, 4, size=150)]
        for m in range(members):
            seq = np.concatenate([BASES[rng.integers(0, 4, size=80)], core,
                                  BASES[rng.integers(0, 4, size=80)]])
            records.append((f"F{fam}M{m}", seq.tobytes()))
    return records


@pytest.mark.parametrize("devices", list(DEVICE_LISTS), ids=str)
@pytest.mark.parametrize("probe", ["hashed", "xl", "classic"])
def test_replicated_matches_one_device(family_workload, probe, devices):  # noqa: F811
    """Pure core reads, flank reads and straddlers (rows, groups, direct
    genes), on the byte and the packed wire."""
    records, index, _ = family_workload
    rng = np.random.default_rng(21)
    reads = (_sample(rng, records, 96, "core")
             + _sample(rng, records, 64, "any")
             + _sample(rng, records, 32, "flank"))
    codes = _encode(reads)
    tindex = index_from_arrays(vars(index))
    one = Classifier(tindex, max_winners=8, c=0.6, device="cpu", probe=probe)
    dp = DataParallelClassifier(tindex, max_winners=8, c=0.6,
                                devices=DEVICE_LISTS[devices], probe=probe)
    assert dp.probe == one.probe == probe
    assert dp.n_devices == len(DEVICE_LISTS[devices])
    assert dp.device == torch.device(DEVICE_LISTS[devices][0])
    want = one(codes)
    assert (want[0] != 0).any()
    _assert_same(dp(codes), want)
    _assert_same(dp.call_packed(*_planar(codes)), want)


def test_replicas_share_one_table_per_device(family_workload):  # noqa: F811
    """The tables are built once; a repeated device shares its copy."""
    _, index, _ = family_workload
    dp = DataParallelClassifier(index_from_arrays(vars(index)),
                                devices=["cpu", "cpu:0", "cpu", "cpu:0"])
    r = dp._replicas
    assert r[0] is r[2] and r[1] is r[3] and r[0] is not r[1]
    assert r[0].dix.table is not None
    assert r[1].device == torch.device("cpu", 0)


@pytest.mark.parametrize("devices", ["two", "four"])
def test_tie_heavy_batch_takes_the_pair_stream(monkeypatch, devices):
    """Degree-2 ties: the joined result is one B-row result to
    _winner_pairs, whose winner-pair stream (K4, extract_pairs) runs on
    it and gives the one-device classifier's association pairs."""
    rng = np.random.default_rng(31)
    records = _tie_records(rng)
    from shark_tpu_torch.index.build import build_index

    tindex = build_index(records, 15, 1 << 16)
    reads = []
    for _ in range(256):
        _, seq = records[int(rng.integers(0, len(records)))]
        start = int(rng.integers(60, 140))
        reads.append(seq[start:start + 90])
    codes = _encode(reads)
    one = Classifier(tindex, max_winners=8, c=0.6, device="cpu")
    dp = DataParallelClassifier(tindex, max_winners=8, c=0.6,
                                devices=DEVICE_LISTS[devices])
    assert dp.groups is not None
    want = one(codes)
    got = dp(codes)
    _assert_same(got, want)
    calls = []
    real = pipeline.extract_pairs

    def counted(packed, winners, cap):
        calls.append(int(packed.shape[0]))
        return real(packed, winners, cap)

    monkeypatch.setattr(pipeline, "extract_pairs", counted)
    cfg = SharkConfig(c=0.6)
    pairs = [pipeline._winner_pairs(cfg, tindex, r, len(reads), codes, 8,
                                    groups=c.groups)
             for r, c in ((want, one), (got, dp))]
    assert calls == [256, 256], "the pair stream did not run on B rows"
    for a, b in zip(*pairs):
        np.testing.assert_array_equal(a, b)
    assert len(pairs[0][0]) > len(set(pairs[0][0].tolist()))  # ties


@pytest.mark.parametrize("devices", ["two", "mixed"])
def test_group_choice_is_the_whole_batchs(family_workload, devices):  # noqa: F811
    """Parts of 78 core reads and 50 reads from anywhere: each part alone
    has at most its FIX_CAP2 impure row-hitting reads and would give GROUP
    verdicts; the whole batch has more than its own and gives none. The
    replicated classifier sums the parts' counts and gives the whole
    batch's verdicts."""
    from shark_tpu_torch.classify.step import PACK_GRP_SHIFT

    records, index, _ = family_workload
    tindex = index_from_arrays(vars(index))
    devs = DEVICE_LISTS[devices]
    rng = np.random.default_rng(1)
    reads = []
    for _ in range(len(devs)):
        reads += _sample(rng, records, 78, "core") + _sample(rng, records, 50,
                                                             "any")
    codes = _encode(reads)
    one = Classifier(tindex, max_winners=8, c=0.6, device="cpu")
    dp = DataParallelClassifier(tindex, max_winners=8, c=0.6, devices=devs)

    def n_group(r):
        return int(((r[0] >> PACK_GRP_SHIFT) & 1).sum())

    whole = one(codes)
    alone = [one(codes[i * 128:(i + 1) * 128]) for i in range(len(devs))]
    assert n_group(whole) == 0 and all(n_group(r) > 40 for r in alone)
    _assert_same(dp(codes), whole)


@pytest.mark.parametrize("n", [3, 4])
def test_uneven_batch_is_refused(family_workload, n):  # noqa: F811
    _, index, _ = family_workload
    dp = DataParallelClassifier(index_from_arrays(vars(index)),
                                devices=["cpu"] * n)
    codes = np.full((10, 96), 4, dtype=np.uint8)
    with pytest.raises(ValueError, match=f"not divisible by {n} devices"):
        dp(codes)
    with pytest.raises(ValueError, match=f"not divisible by {n} devices"):
        dp.call_packed(*_planar(codes))


# seeds of test_e2e_fuzz's generator: paired + quality masking, plain;
# single end, gzip
@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_run_pipeline_matches_shark_tpu_data_parallel(tmp_path, seed, native,
                                                      monkeypatch):
    """run_pipeline over 2 and 4 torch CPU devices writes the bytes of the
    one-device port run and of shark_tpu's --devices 8 run."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the suite's 8 virtual JAX devices")
    if native and not jnative.available():
        pytest.skip("native engine unavailable")
    monkeypatch.setattr("shark_tpu.config.BF_UNIT_BITS", 1 << 20)
    monkeypatch.setattr("shark_tpu_torch.config.BF_UNIT_BITS", 1 << 20)
    w = _random_workload(np.random.default_rng(1000 + seed), tmp_path, seed)

    def paths(tag, **kw):
        return dict(
            fasta_path=str(w["fa"]), sample1_path=str(w["fq1"]),
            sample2_path=str(w["fq2"]) if w["fq2"] else "",
            out1_path=str(tmp_path / f"{tag}.1.fq"),
            out2_path=str(tmp_path / f"{tag}.2.fq") if w["fq2"] else "",
            ssv_path=str(tmp_path / f"{tag}.ssv"), k=w["k"], c=0.3,
            min_quality=w["minq"], batch_size=32, use_native=native,
            max_read_len=256 if native else 0, compile_cache="", **kw)

    jcfg = JConfig(devices=8, **paths("jax"))
    jrun(jcfg)
    want = _outputs(tmp_path, "jax", w["paired"])
    assert want[0], "workload emitted no association"
    tindex = index_from_arrays(vars(jload(jcfg, PhaseTimer())))
    runs = {"one": Classifier(tindex, c=0.3, device="cpu")}
    for name in ("two", "four"):
        runs[name] = DataParallelClassifier(tindex, c=0.3,
                                            devices=DEVICE_LISTS[name])
    for tag, clf in runs.items():
        stats = run_pipeline(SharkConfig(backend="cpu", **paths(tag)),
                             classifier=clf)
        assert stats["probe"] == "hashed"
        assert stats.get("native", False) == native
        assert _outputs(tmp_path, tag, w["paired"]) == want, tag
