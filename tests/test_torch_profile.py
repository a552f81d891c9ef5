"""--profile-dir in shark_tpu_torch: a torch.profiler profile around the
run writes a Chrome trace into the directory (made if missing), also when
the run raises, and changes no output byte; on every backend the CPU can
run (cpu, and native, which records the host only)."""

import json

import numpy as np
import pytest

from shark_tpu_torch import cli
from shark_tpu_torch.config import SharkConfig
from shark_tpu_torch.io import native
from shark_tpu_torch.pipeline import run_pipeline

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture
def workload(tmp_path, monkeypatch):
    """Ten genes and 200 reads from them; -b 1 is 2^20 bits here."""
    monkeypatch.setattr("shark_tpu_torch.config.BF_UNIT_BITS", 1 << 20)
    rng = np.random.default_rng(8)
    genes = [BASES[rng.integers(0, 4, size=400)] for _ in range(10)]
    fa = tmp_path / "genes.fa"
    fa.write_bytes(b"".join(b">g%d\n%s\n" % (i, g.tobytes())
                            for i, g in enumerate(genes)))
    fq = tmp_path / "reads.fq"
    recs = []
    for i in range(200):
        g = genes[int(rng.integers(0, 10))]
        s = int(rng.integers(0, 300))
        recs.append(b"@r%04d\n%s\n+\n%s\n" % (i, g[s:s + 90].tobytes(),
                                               b"I" * 90))
    fq.write_bytes(b"".join(recs))
    return str(fa), str(fq)


def _traces(d):
    return sorted(d.glob("*.pt.trace.json")) if d.exists() else []


def _run(tmp_path, workload, tag, extra):
    fa, fq = workload
    argv = ["-r", fa, "-1", fq, "-o", str(tmp_path / f"{tag}.fq"),
            "--ssv", str(tmp_path / f"{tag}.ssv"), "-k", "15",
            "--batch-size", "64", *extra]
    assert cli.main(argv) == 0
    return ((tmp_path / f"{tag}.ssv").read_bytes(),
            (tmp_path / f"{tag}.fq").read_bytes())


@pytest.mark.parametrize("backend", ["cpu", "native"])
def test_profile_dir_writes_a_trace_and_the_same_bytes(tmp_path, workload,
                                                       backend):
    if backend == "native" and not native.available():
        pytest.skip("native engine unavailable")
    plain = _run(tmp_path, workload, "plain", ["--backend", backend])
    assert plain[0], "workload emitted no association"
    trace_dir = tmp_path / "trace" / "deep"  # made by the run
    profiled = _run(tmp_path, workload, "profiled",
                    ["--backend", backend, "--profile-dir", str(trace_dir)])
    assert profiled == plain
    (trace,) = _traces(trace_dir)
    events = json.loads(trace.read_text())["traceEvents"]
    assert events
    # the host's torch operators are there; no device activity
    names = {e.get("name", "") for e in events}
    cats = {e.get("cat", "") for e in events}
    assert "kernel" not in cats and "gpu_memcpy" not in cats
    if backend == "cpu":
        assert any(n.startswith("aten::") for n in names)


def test_profile_dir_trace_is_written_when_the_run_raises(tmp_path, workload,
                                                          monkeypatch):
    from shark_tpu_torch.classify import step

    def fail(*a, **k):
        raise RuntimeError("injected classify failure")

    monkeypatch.setattr(step.Classifier, "call_packed", fail)
    fa, fq = workload
    cfg = SharkConfig(fasta_path=fa, sample1_path=fq, k=15,
                      out1_path=str(tmp_path / "o.fq"),
                      ssv_path=str(tmp_path / "o.ssv"), batch_size=64,
                      backend="cpu", profile_dir=str(tmp_path / "trace"))
    with pytest.raises(RuntimeError, match="injected"):
        run_pipeline(cfg)
    assert len(_traces(tmp_path / "trace")) == 1
