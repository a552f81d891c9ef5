"""shark_tpu_torch end to end on the CPU, against shark_tpu.

The port's Classifier(device="cpu") must return shark_tpu's hashed
Classifier outputs bit for bit, and the port's run_pipeline must write the
bytes shark_tpu's writes — ssv and FASTQ — on the random workloads of
tests/test_e2e_fuzz.py (paired and single-end, quality masking, gzip),
through the native engine and through the Python path, with the
auto-length pre-scan. One index per workload, built once and given to
both packages' classifiers."""

import numpy as np
import pytest

pytest.importorskip("jax")

from shark_tpu.classify.step import Classifier as JClassifier  # noqa: E402
from shark_tpu.config import SharkConfig as JConfig  # noqa: E402
from shark_tpu.io import native as jnative  # noqa: E402
from shark_tpu.pipeline import load_or_build_index  # noqa: E402
from shark_tpu.pipeline import run_pipeline as jrun  # noqa: E402
from shark_tpu.utils.timers import PhaseTimer  # noqa: E402
from shark_tpu_torch.classify.oracle import (  # noqa: E402
    build_oracle_index,
    classify_read,
)
from shark_tpu_torch.classify.step import Classifier  # noqa: E402
from shark_tpu_torch.config import SharkConfig  # noqa: E402
from shark_tpu_torch.convert import index_from_arrays  # noqa: E402
from shark_tpu_torch.ops.kmers import encode_bytes  # noqa: E402
from shark_tpu_torch.pipeline import _winner_pairs, run_pipeline  # noqa: E402
from test_e2e_fuzz import BASES, _random_workload  # noqa: E402
from test_groups import _encode, _sample, family_workload  # noqa: E402,F401


def test_classifier_matches_shark_tpu(family_workload):
    """Mixed batch (pure core reads, flank reads, straddlers) at an L that
    is no multiple of 8 (the port pads it for the planar packing)."""
    records, index, _ = family_workload
    rng = np.random.default_rng(12)
    reads = _sample(rng, records, 150, "core") + _sample(
        rng, records, 60, "any"
    )
    codes = _encode(reads, L=90)
    want = [np.asarray(x) for x in JClassifier(
        index, max_winners=8, c=0.6, probe="hashed")(codes)]
    clf = Classifier(index_from_arrays(vars(index)), max_winners=8, c=0.6,
                     device="cpu")
    assert clf.probe == "hashed"
    got = [x.numpy() for x in clf(codes)]
    for name, w, g in zip(("packed", "winners", "best_cov", "length"), want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_winner_pairs_match_oracle(family_workload):
    """The port's drain decode (_winner_pairs, with group expansion)
    against the port's oracle."""
    records, index, _ = family_workload
    rng = np.random.default_rng(13)
    reads = _sample(rng, records, 100, "core") + _sample(
        rng, records, 60, "any"
    )
    codes = _encode(reads)
    tindex = index_from_arrays(vars(index))
    clf = Classifier(tindex, max_winners=8, c=0.6, device="cpu")
    ri, gi = _winner_pairs(
        SharkConfig(c=0.6), tindex, clf(codes), len(reads), codes, 8,
        groups=clf.groups,
    )
    oracle = build_oracle_index(records, tindex.k, tindex.size_bits)
    want_r, want_g = [], []
    for i, r in enumerate(reads):
        w, _, _ = classify_read(oracle, encode_bytes(r), 0.6, False)
        want_r += [i] * len(w)
        want_g += w
    np.testing.assert_array_equal(ri, want_r)
    np.testing.assert_array_equal(gi, want_g)


def _outputs(tmp_path, tag, paired):
    return (
        (tmp_path / f"{tag}.ssv").read_bytes(),
        (tmp_path / f"{tag}.1.fq").read_bytes(),
        (tmp_path / f"{tag}.2.fq").read_bytes() if paired else b"",
    )


# seeds of test_e2e_fuzz's generator: paired/single, minq 0/10, gzip/plain
@pytest.mark.parametrize("seed", [0, 1, 3, 4, 6])
def test_run_pipeline_matches_shark_tpu(tmp_path, seed):
    if not jnative.available():
        pytest.skip("native engine unavailable")
    rng = np.random.default_rng(1000 + seed)
    w = _random_workload(rng, tmp_path, seed)

    def paths(tag):
        return dict(
            fasta_path=str(w["fa"]),
            sample1_path=str(w["fq1"]),
            sample2_path=str(w["fq2"]) if w["fq2"] else "",
            out1_path=str(tmp_path / f"{tag}.1.fq"),
            out2_path=str(tmp_path / f"{tag}.2.fq") if w["fq2"] else "",
            ssv_path=str(tmp_path / f"{tag}.ssv"),
            k=w["k"],
            # mate 2 of a paired workload is random sequence, so a fused
            # pair covers at most about half its bases: c = 0.3 lets
            # paired workloads emit
            c=0.3,
            min_quality=w["minq"],
            batch_size=32,  # several batches per run
        )

    jcfg = JConfig(max_read_len=256, **paths("jax"))
    index = load_or_build_index(jcfg, PhaseTimer())
    jrun(jcfg, classifier=JClassifier(index, c=jcfg.c))
    want = _outputs(tmp_path, "jax", w["paired"])
    assert want[0], "workload emitted no association"

    clf = Classifier(index_from_arrays(vars(index)), c=jcfg.c, device="cpu")
    for tag, native in (("native", True), ("python", False)):
        # max_read_len 0: the native path takes the auto-length pre-scan,
        # the Python path pads each batch to its own length
        cfg = SharkConfig(max_read_len=0, use_native=native, backend="cpu",
                          **paths(tag))
        stats = run_pipeline(cfg, classifier=clf)
        assert stats.get("native", False) == native
        assert stats["probe"] == "hashed"
        got = _outputs(tmp_path, tag, w["paired"])
        for name, a, b in zip(("ssv", "fq1", "fq2"), want, got):
            assert a == b, f"{tag}: {name} differs from shark_tpu"


def test_tie_heavy_native_pipeline_matches_shark_tpu(tmp_path):
    """Families of two members (degree-2 ties: the winner-pair stream and
    its speculation on the dispatch thread) and of four (group verdicts)
    through many small batches of the native engine and the Python path."""
    if not jnative.available():
        pytest.skip("native engine unavailable")
    rng = np.random.default_rng(31)
    records = []
    for fam, members in enumerate([2] * 6 + [4] * 4):
        core = BASES[rng.integers(0, 4, size=150)]
        for m in range(members):
            seq = np.concatenate([BASES[rng.integers(0, 4, size=80)], core,
                                  BASES[rng.integers(0, 4, size=80)]])
            records.append((f"F{fam}M{m}", seq.tobytes()))
    fa = tmp_path / "genes.fa"
    fa.write_bytes(b"".join(b">%s\n%s\n" % (n.encode(), q) for n, q in records))
    fq = tmp_path / "reads.fq"
    with open(fq, "wb") as f:
        for i in range(600):
            _, seq = records[int(rng.integers(0, len(records)))]
            start = int(rng.integers(60, 140))
            r = seq[start:start + 90]
            f.write(b"@r%04d\n%s\n+\n%s\n" % (i, r, b"I" * len(r)))

    def cfg_of(config_cls, tag, native):
        return config_cls(
            fasta_path=str(fa), sample1_path=str(fq),
            out1_path=str(tmp_path / f"{tag}.fq"),
            ssv_path=str(tmp_path / f"{tag}.ssv"), k=15,
            batch_size=64, max_read_len=96 if native else 0,
            use_native=native,
        )

    jcfg = cfg_of(JConfig, "jax", True)
    index = load_or_build_index(jcfg, PhaseTimer())
    jrun(jcfg, classifier=JClassifier(index))
    clf = Classifier(index_from_arrays(vars(index)), device="cpu")
    for tag, native in (("native", True), ("python", False)):
        stats = run_pipeline(cfg_of(SharkConfig, tag, native), classifier=clf)
        if native:
            assert stats["group_rows"] > 0
        for ext in (".ssv", ".fq"):
            assert (tmp_path / f"{tag}{ext}").read_bytes() == (
                tmp_path / f"jax{ext}").read_bytes(), f"{tag}{ext}"
    ssv = (tmp_path / "jax.ssv").read_text().splitlines()
    assert len(ssv) > len({line.split()[0] for line in ssv})  # ties emitted
