"""--backend native in shark_tpu_torch: the pure-CPU C++ classify path.

The port's host_classify (shk_host_classify of the port's own copy of the
engine) against the port's oracle and across thread counts, as
tests/test_native_backend.py holds shark_tpu's; the port's
_run_native_host against the port's Python-path pipeline; and the port's
--backend native bytes against shark_tpu's on the same workloads, with
CUDA reported missing (the path must not need it). Every comparison is
exact."""

import io

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from shark_tpu.config import SharkConfig as JConfig  # noqa: E402
from shark_tpu.pipeline import run_pipeline as jrun  # noqa: E402
from shark_tpu_torch import cli, kernels  # noqa: E402
from shark_tpu_torch.classify import step  # noqa: E402
from shark_tpu_torch.config import SharkConfig  # noqa: E402
from shark_tpu_torch.convert import index_from_arrays  # noqa: E402
from shark_tpu_torch.io import native as native_mod  # noqa: E402
from shark_tpu_torch.pipeline import (  # noqa: E402
    _run_native_host,
    _ShimIndex,
    run_pipeline,
)
from shark_tpu_torch.utils.timers import PhaseTimer  # noqa: E402
from test_e2e_fuzz import _random_workload  # noqa: E402
from test_native_backend import K  # noqa: E402
from test_native_backend import _index_and_reads as _jworkload  # noqa: E402
from test_torch_pipeline import _family_fastx, _outputs  # noqa: E402

pytestmark = pytest.mark.skipif(
    not native_mod.available(), reason="native engine unavailable"
)


def _index_and_reads(seed=5):
    """tests/test_native_backend.py's workload, the index in the port's
    form."""
    index, records, codes = _jworkload(seed)
    return index_from_arrays(vars(index)), records, codes


@pytest.mark.parametrize("single", [False, True])
def test_host_classify_matches_oracle(single):
    from shark_tpu_torch.classify.oracle import classify_read

    index, _, codes = _index_and_reads()
    ri, gi = native_mod.host_classify(
        index, codes, codes.shape[0], 0.6, single, threads=3
    )
    shim = _ShimIndex(index)
    want_r, want_g = [], []
    for i in range(codes.shape[0]):
        wins, _, _ = classify_read(shim, codes[i], 0.6, single)
        want_r.extend([i] * len(wins))
        want_g.extend(wins)
    np.testing.assert_array_equal(ri, np.asarray(want_r, np.int32))
    np.testing.assert_array_equal(gi, np.asarray(want_g, np.int32))


def test_host_classify_thread_count_invariant():
    """Contiguous-chunk parallelism: output identical at any thread
    count."""
    index, _, codes = _index_and_reads(seed=9)
    ref = native_mod.host_classify(index, codes, codes.shape[0], 0.6, False, 1)
    for t in (2, 4, 7):
        got = native_mod.host_classify(
            index, codes, codes.shape[0], 0.6, False, t
        )
        np.testing.assert_array_equal(ref[0], got[0])
        np.testing.assert_array_equal(ref[1], got[1])


def test_native_backend_matches_python_pipeline(tmp_path):
    """_run_native_host (paired + quality masking) vs the port's
    Python-path pipeline on the same index: identical ssv + FASTQs."""
    rng = np.random.default_rng(3)
    index, records, _ = _index_and_reads(seed=3)
    fasta = tmp_path / "genes.fa"
    with open(fasta, "wb") as f:
        for name, seq in records:
            f.write(b">" + name.encode() + b"\n" + seq + b"\n")
    fq1, fq2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    with open(fq1, "wb") as f1, open(fq2, "wb") as f2:
        for i in range(200):
            _, seq = records[rng.integers(0, len(records))]
            s = int(rng.integers(0, 120))
            m1 = seq[s : s + 70]
            m2 = seq[s + 60 : s + 130]
            q1 = (rng.integers(2, 41, size=len(m1)) + 33).astype(np.uint8)
            q2 = (rng.integers(2, 41, size=len(m2)) + 33).astype(np.uint8)
            f1.write(b"@p%04d\n" % i + m1 + b"\n+\n" + q1.tobytes() + b"\n")
            f2.write(b"@p%04d\n" % i + m2 + b"\n+\n" + q2.tobytes() + b"\n")

    common = dict(
        fasta_path=str(fasta),
        sample1_path=str(fq1),
        sample2_path=str(fq2),
        k=K,
        min_quality=10,
        batch_size=64,
        max_read_len=144,  # 70 + 1 + 70, padded %8
        threads=3,
    )
    cfg_n = SharkConfig(
        out1_path=str(tmp_path / "n1.fq"),
        out2_path=str(tmp_path / "n2.fq"),
        ssv_path=str(tmp_path / "n.ssv"),
        **common,
    )
    stats = _run_native_host(cfg_n, index, PhaseTimer())
    assert stats["n_reads"] == 200 and stats["probe"] == "host"

    cfg_p = SharkConfig(
        out1_path=str(tmp_path / "p1.fq"),
        out2_path=str(tmp_path / "p2.fq"),
        use_native=False,
        backend="cpu",
        **common,
    )
    ssv = io.StringIO()
    run_pipeline(
        cfg_p, ssv_stream=ssv,
        classifier=step.Classifier(index, max_winners=cfg_p.max_winners,
                                   c=cfg_p.c, device="cpu"),
    )
    assert (tmp_path / "n.ssv").read_text() == ssv.getvalue()
    assert (tmp_path / "n1.fq").read_bytes() == (tmp_path / "p1.fq").read_bytes()
    assert (tmp_path / "n2.fq").read_bytes() == (tmp_path / "p2.fq").read_bytes()


def _no_cuda(monkeypatch):
    """CUDA reported missing; resolving a device or loading the kernels
    fails the test."""
    from shark_tpu_torch import pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def refuse(*a, **k):
        raise AssertionError("--backend native asked for a device")

    for mod in (step, pipeline):
        monkeypatch.setattr(mod, "resolve_device", refuse)
    monkeypatch.setattr(kernels, "lib", refuse)
    kernels.LAUNCHES.reset()


@pytest.fixture
def small_bf(monkeypatch):
    """Both packages' -b unit shrunk to 2^20 bits: -b 1 builds a small
    filter."""
    monkeypatch.setattr("shark_tpu.config.BF_UNIT_BITS", 1 << 20)
    monkeypatch.setattr("shark_tpu_torch.config.BF_UNIT_BITS", 1 << 20)


# seeds of test_e2e_fuzz's generator: paired/single, minq 0/10, gzip/plain
@pytest.mark.parametrize("seed", [0, 1, 3, 4, 6])
def test_native_backend_matches_shark_tpu(tmp_path, monkeypatch, small_bf,
                                         seed):
    """run_pipeline with backend="native", the auto-length scan and -t 3,
    writes shark_tpu's --backend native bytes, with no CUDA."""
    rng = np.random.default_rng(1000 + seed)
    w = _random_workload(rng, tmp_path, seed)

    def paths(tag):
        return dict(
            fasta_path=str(w["fa"]), sample1_path=str(w["fq1"]),
            sample2_path=str(w["fq2"]) if w["fq2"] else "",
            out1_path=str(tmp_path / f"{tag}.1.fq"),
            out2_path=str(tmp_path / f"{tag}.2.fq") if w["fq2"] else "",
            ssv_path=str(tmp_path / f"{tag}.ssv"), k=w["k"], c=0.3,
            min_quality=w["minq"], batch_size=32, backend="native",
            threads=3,
        )

    jrun(JConfig(**paths("jax")))
    want = _outputs(tmp_path, "jax", w["paired"])
    assert want[0], "workload emitted no association"
    _no_cuda(monkeypatch)
    stats = run_pipeline(SharkConfig(**paths("torch")))
    assert stats["probe"] == "host" and stats["auto_max_read_len"] > 0
    assert _outputs(tmp_path, "torch", w["paired"]) == want
    assert kernels.LAUNCHES.snapshot() == {n: 0 for n in kernels.KERNELS}


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_native_backend_cli_matches_shark_tpu(tmp_path, monkeypatch, small_bf,
                                             paired):
    """`--backend native` through both CLIs, on a tie-heavy family
    workload (rows, groups), with CUDA reported missing for the port."""
    from shark_tpu import cli as jcli

    fa, fq = _family_fastx(tmp_path, np.random.default_rng(77 + paired),
                           paired)
    outs = {}
    for tag, main in (("jax", jcli.main), ("torch", cli.main)):
        if tag == "torch":
            _no_cuda(monkeypatch)
        argv = ["-r", fa, "-1", fq[0], "-o", str(tmp_path / f"{tag}.1.fq"),
                "--ssv", str(tmp_path / f"{tag}.ssv"), "-k", "15", "-c",
                "0.5", "-b", "1", "--backend", "native", "-t", "2",
                "--batch-size", "64"]
        if paired:
            argv += ["-2", fq[1], "-p", str(tmp_path / f"{tag}.2.fq")]
        assert main(argv) == 0
        outs[tag] = _outputs(tmp_path, tag, paired)
    assert outs["jax"][0], "workload emitted no association"
    assert outs["torch"] == outs["jax"]


@pytest.mark.parametrize(
    "extra, match",
    [
        (dict(sharded_bf=True), "require a device backend"),
        (dict(devices=2), "require a device backend"),
    ],
    ids=["sharded-bf", "devices"],
)
def test_native_backend_refuses_device_flags(tmp_path, extra, match):
    """shark_tpu's refusals: device flags with --backend native."""
    fa = tmp_path / "g.fa"
    fq = tmp_path / "r.fq"
    fa.write_bytes(b">g\nACGTACGTTGCAACGTTGCA\n")
    fq.write_bytes(b"@r\nACGTACGTTGCA\n+\nIIIIIIIIIIII\n")
    cfg = SharkConfig(fasta_path=str(fa), sample1_path=str(fq),
                      out1_path=str(tmp_path / "o.fq"),
                      ssv_path=str(tmp_path / "o.ssv"), backend="native",
                      **extra)
    with pytest.raises(ValueError, match=match):
        run_pipeline(cfg)
