"""Checkpoint/resume in shark_tpu_torch, on both native paths.

tests/test_resume.py's six cases (marked slow there, on the example data)
ported to the port, on the random workloads of tests/test_e2e_fuzz.py and
a tie-heavy family workload: an interrupted run restarts from the
<ssv>.progress sidecar, and its final bytes (ssv and FASTQ) equal an
uninterrupted port run's and shark_tpu's. The card's native path
(_run_native, here on the CPU device, crashed by the fail_after_batches
hook) and --backend native (_run_native_host, crashed by a host_classify
that raises) both resume. Both packages' -b unit is shrunk to 2^20 bits."""

import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

from shark_tpu.classify.step import Classifier as JClassifier  # noqa: E402
from shark_tpu.config import SharkConfig as JConfig  # noqa: E402
from shark_tpu.pipeline import load_or_build_index as jload  # noqa: E402
from shark_tpu.pipeline import run_pipeline as jrun  # noqa: E402
from shark_tpu.utils.timers import PhaseTimer  # noqa: E402
from shark_tpu_torch.classify.step import Classifier  # noqa: E402
from shark_tpu_torch.config import SharkConfig  # noqa: E402
from shark_tpu_torch.convert import index_from_arrays  # noqa: E402
from shark_tpu_torch.io import native  # noqa: E402
from shark_tpu_torch.pipeline import _load_progress, run_pipeline  # noqa: E402
from test_e2e_fuzz import _random_workload  # noqa: E402

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native engine unavailable"
)

BATCH = 8
OUTS = ("out.ssv", "out1.fq", "out2.fq")


@pytest.fixture(autouse=True)
def small_bf(monkeypatch):
    monkeypatch.setattr("shark_tpu.config.BF_UNIT_BITS", 1 << 20)
    monkeypatch.setattr("shark_tpu_torch.config.BF_UNIT_BITS", 1 << 20)


def _workload(tmp_path, seed):
    w = _random_workload(np.random.default_rng(1000 + seed), tmp_path, seed)

    def cfg(config_cls, d, **kw):
        os.makedirs(d, exist_ok=True)
        return config_cls(
            fasta_path=str(w["fa"]), sample1_path=str(w["fq1"]),
            sample2_path=str(w["fq2"]) if w["fq2"] else "",
            out1_path=f"{d}/out1.fq",
            out2_path=f"{d}/out2.fq" if w["fq2"] else "",
            ssv_path=f"{d}/out.ssv", k=w["k"], c=0.3,
            min_quality=w["minq"], batch_size=BATCH, max_read_len=256,
            compile_cache="", **kw)

    return w, cfg


def _read_outputs(d):
    return tuple(
        open(f"{d}/{f}", "rb").read() if os.path.exists(f"{d}/{f}") else b""
        for f in OUTS
    )


def _shark_tpu_outputs(cfg, tmp_path, **kw):
    """shark_tpu's uninterrupted bytes, and its index for the port."""
    jcfg = cfg(JConfig, str(tmp_path / "jax"), **kw)
    index = jload(jcfg, PhaseTimer())
    clf = None if kw.get("backend") == "native" else JClassifier(
        index, max_winners=jcfg.max_winners, c=jcfg.c)
    jrun(jcfg, classifier=clf)
    return _read_outputs(str(tmp_path / "jax")), index


# seeds of test_e2e_fuzz's generator: paired + quality masking; single
# end from a gzip sample
@pytest.mark.parametrize("seed", [0, 4])
def test_resume_after_injected_crash(tmp_path, seed):
    w, cfg = _workload(tmp_path, seed)
    want, jindex = _shark_tpu_outputs(cfg, tmp_path)
    assert want[0], "workload emitted no association"
    clf = Classifier(index_from_arrays(vars(jindex)), c=0.3, device="cpu")
    full_dir, res_dir = str(tmp_path / "full"), str(tmp_path / "res")

    stats_full = run_pipeline(cfg(SharkConfig, full_dir), classifier=clf)
    assert _read_outputs(full_dir) == want

    # crash after 4 dispatched batches; the shutdown path drains everything
    # queued, so the checkpoint lands at exactly 4 * BATCH reads
    with pytest.raises(RuntimeError, match="injected"):
        run_pipeline(cfg(SharkConfig, res_dir, resume=True,
                         fail_after_batches=4), classifier=clf)
    sidecar = f"{res_dir}/out.ssv.progress"
    st = json.load(open(sidecar))
    assert st["reads_done"] == 4 * BATCH
    got_partial = _read_outputs(res_dir)
    assert all(len(g) <= len(x) for g, x in zip(got_partial, want))

    stats = run_pipeline(cfg(SharkConfig, res_dir, resume=True),
                         classifier=clf)
    assert stats["resumed_reads"] == 4 * BATCH
    assert not os.path.exists(sidecar)
    assert _read_outputs(res_dir) == want
    for key in ("n_reads", "n_associations", "n_reads_out"):
        assert stats[key] == stats_full[key], key


@pytest.mark.parametrize("seed", [0, 4])
def test_resume_after_crash_under_backend_native(tmp_path, monkeypatch, seed):
    """--backend native (_run_native_host): host_classify raises on the
    third batch; the sidecar holds the two classified batches, and the
    resumed run writes shark_tpu's --backend native bytes."""
    w, cfg = _workload(tmp_path, seed)
    want, _ = _shark_tpu_outputs(cfg, tmp_path, backend="native")
    assert want[0], "workload emitted no association"
    full_dir, res_dir = str(tmp_path / "full"), str(tmp_path / "res")
    stats_full = run_pipeline(cfg(SharkConfig, full_dir, backend="native"))
    assert _read_outputs(full_dir) == want

    real = native.host_classify
    calls = []

    def crashing(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected host_classify failure")
        return real(*a, **k)

    monkeypatch.setattr(native, "host_classify", crashing)
    with pytest.raises(RuntimeError, match="injected"):
        run_pipeline(cfg(SharkConfig, res_dir, backend="native",
                         resume=True))
    monkeypatch.setattr(native, "host_classify", real)
    sidecar = f"{res_dir}/out.ssv.progress"
    assert json.load(open(sidecar))["reads_done"] == 2 * BATCH

    stats = run_pipeline(cfg(SharkConfig, res_dir, backend="native",
                             resume=True))
    assert stats["resumed_reads"] == 2 * BATCH and stats["probe"] == "host"
    assert not os.path.exists(sidecar)
    assert _read_outputs(res_dir) == want
    for key in ("n_reads", "n_associations", "n_reads_out"):
        assert stats[key] == stats_full[key], key


@pytest.mark.parametrize("backend", ["cpu", "native"])
def test_resume_fresh_run_with_flag_matches(tmp_path, backend):
    """--resume with no checkpoint is a plain run that leaves no sidecar."""
    w, cfg = _workload(tmp_path, 0)
    want, jindex = _shark_tpu_outputs(
        cfg, tmp_path, **({"backend": "native"} if backend == "native" else {}))
    clf = (None if backend == "native" else
           Classifier(index_from_arrays(vars(jindex)), c=0.3, device="cpu"))
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    run_pipeline(cfg(SharkConfig, d1, backend=backend), classifier=clf)
    run_pipeline(cfg(SharkConfig, d2, backend=backend, resume=True),
                 classifier=clf)
    assert not os.path.exists(f"{d2}/out.ssv.progress")
    assert _read_outputs(d1) == _read_outputs(d2) == want


def test_resume_rejects_mismatched_checkpoint(tmp_path):
    _, cfg = _workload(tmp_path, 0)
    c = cfg(SharkConfig, str(tmp_path / "x"), resume=True)
    sidecar = f"{tmp_path}/x/out.ssv.progress"
    json.dump(
        {"identity": {"k": 99}, "reads_done": 512, "offsets": [0, 0, 0]},
        open(sidecar, "w"),
    )
    with pytest.raises(ValueError, match="different"):
        _load_progress(sidecar, c)


def test_resume_requires_native_fixed_len(tmp_path):
    _, cfg = _workload(tmp_path, 0)
    c = cfg(SharkConfig, str(tmp_path / "y"), resume=True, backend="cpu")
    c.max_read_len = 0  # auto-length -> python path
    with pytest.raises(ValueError, match="resume requires"):
        run_pipeline(c)


@pytest.mark.parametrize("backend", ["cpu", "native"])
def test_resume_rejects_gz_outputs(tmp_path, backend):
    _, cfg = _workload(tmp_path, 0)
    c = cfg(SharkConfig, str(tmp_path / "z"), resume=True, backend=backend)
    c.out1_path += ".gz"
    with pytest.raises(ValueError, match="uncompressed"):
        run_pipeline(c)


def _family_workload(tmp_path):
    """tests/test_resume.py's homolog-family workload (seed 777): four
    families of five genes sharing a 120 bp core; half the reads from a
    core."""
    rng = np.random.default_rng(777)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genes, cores = [], []
    for fam in range(4):
        core = bases[rng.integers(0, 4, size=120)].tobytes()
        cores.append(core)
        for m in range(5):
            genes.append((
                f"F{fam}M{m}",
                bases[rng.integers(0, 4, size=60)].tobytes() + core
                + bases[rng.integers(0, 4, size=60)].tobytes(),
            ))
    fa = tmp_path / "fam.fa"
    fa.write_bytes(b"".join(b">%s\n%s\n" % (n.encode(), s) for n, s in genes))
    reads = []
    for i in range(240):
        if i % 2 == 0:
            core = cores[int(rng.integers(0, len(cores)))]
            st = int(rng.integers(0, len(core) - 60))
            reads.append(core[st : st + 60])
        else:
            _, gs = genes[int(rng.integers(0, len(genes)))]
            reads.append(gs[:60])
    fq = tmp_path / "s.fq"
    fq.write_bytes(b"".join(b"@r%04d\n%s\n+\n%s\n" % (i, r, b"I" * len(r))
                            for i, r in enumerate(reads)))

    def cfg(config_cls, d, **kw):
        os.makedirs(d, exist_ok=True)
        return config_cls(
            fasta_path=str(fa), sample1_path=str(fq),
            out1_path=f"{d}/out1.fq", ssv_path=f"{d}/out.ssv",
            k=15, batch_size=32, max_read_len=64, compile_cache="", **kw)

    return cfg


def test_resume_through_group_path(tmp_path):
    """Crash + resume on the homolog-family workload: the group fast path
    (GROUP verdicts, host expansion, ordered emit) survives the checkpoint
    boundary byte-identically, as do the resumed association counters."""
    cfg = _family_workload(tmp_path)
    jcfg = cfg(JConfig, str(tmp_path / "jax"))
    jindex = jload(jcfg, PhaseTimer())
    jrun(jcfg, classifier=JClassifier(jindex, max_winners=8, c=jcfg.c))
    want = _read_outputs(str(tmp_path / "jax"))

    clf = Classifier(index_from_arrays(vars(jindex)), max_winners=8,
                     c=jcfg.c, device="cpu")
    assert clf.groups is not None
    full_dir, res_dir = str(tmp_path / "full"), str(tmp_path / "res")
    stats_full = run_pipeline(cfg(SharkConfig, full_dir), classifier=clf)
    assert stats_full["group_rows"] > 50, "group path never engaged"
    assert _read_outputs(full_dir) == want

    with pytest.raises(RuntimeError, match="injected"):
        run_pipeline(cfg(SharkConfig, res_dir, resume=True,
                         fail_after_batches=3), classifier=clf)
    stats = run_pipeline(cfg(SharkConfig, res_dir, resume=True),
                         classifier=clf)
    assert stats["resumed_reads"] == 3 * 32
    assert stats["group_rows"] > 0  # groups engaged after the boundary too
    assert stats["n_associations"] == stats_full["n_associations"]
    assert _read_outputs(res_dir) == want
