"""bench_gpu.py, the port's bench, on the CPU at a tiny size.

- its three generators write the bytes of bench.py's and of its two
  sub-benches' (each reference stopped right after it generated);
- a tiny run of every workload with device="cpu" prints one JSON line
  holding every key of bench.py's docstring schema, each workload exact
  against bench/baseline.cpp (the comparator, compiled once here);
- a classifier whose verdicts are corrupted makes the workload inexact
  and the run exit 1, with the mismatch named;
- without a CUDA card and without device="cpu" the line holds "error".

The -b unit is shrunk to 2^22 bits (config.BF_UNIT_BITS), and the
comparator is given the same bit count. Tests that need g++ skip without
it.
"""

import importlib.util
import json
import os
import re
import shutil
import sys

import pytest
import torch

import bench_gpu
from shark_tpu_torch import config
from shark_tpu_torch.classify import step
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKLOADS = bench_gpu.WORKLOADS
TINY = dict(N_GENES=40, N_READS=1000, N_PAIRS=400, HOMOLOG_GENES=48,
            HOMOLOG_READS=800, TXOME_GENES=160, TXOME_READS=1000,
            BATCH=256, N_ORACLE=200)


class Stop(Exception):
    """Raised where a reference bench has finished generating."""


def _raise_stop(*a, **kw):
    raise Stop()


def _needs_gpp():
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed for the comparator and the C++ engine")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_files(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


@pytest.fixture
def reference_bench(monkeypatch):
    """bench.py (its module level imports numpy only), importable as
    `bench` by the sub-benches, with sys.path restored afterwards."""
    monkeypatch.setattr(sys, "path", [ROOT] + list(sys.path))
    bench = _load("bench", os.path.join(ROOT, "bench.py"))
    monkeypatch.setitem(sys.modules, "bench", bench)
    return bench


@pytest.mark.parametrize("workload", ["panel", "homolog", "txome"])
def test_generators_write_the_reference_bytes(tmp_path, monkeypatch,
                                              reference_bench, workload):
    monkeypatch.setattr(bench_gpu, "CACHE", str(tmp_path / "port"))
    ref = tmp_path / "ref"
    if workload == "panel":
        for name, v in (("N_GENES", 20), ("N_READS", 300), ("N_PAIRS", 120)):
            monkeypatch.setattr(reference_bench, name, v)
            monkeypatch.setattr(bench_gpu, name, v)
        monkeypatch.setattr(reference_bench, "CACHE", str(ref))
        want = reference_bench.gen_workload()
        got = bench_gpu.gen_workload()
    elif workload == "homolog":
        sub = _load("homolog_bench",
                    os.path.join(ROOT, "bench", "homolog_bench.py"))
        monkeypatch.setattr(sub, "CACHE", str(ref))
        monkeypatch.setattr(reference_bench, "run_baseline", _raise_stop)
        with pytest.raises(Stop):
            sub.run(300)
        want = [str(ref / "genes.fa"), str(ref / "reads300.fq")]
        got = bench_gpu.gen_homolog(300)
    else:
        pytest.importorskip("jax")
        import shark_tpu.pipeline

        sub = _load("transcriptome_bench",
                    os.path.join(ROOT, "bench", "transcriptome_bench.py"))
        monkeypatch.setattr(sub, "CACHE", str(ref))
        # its comparator runs last; the index build comes right after
        # the generation
        monkeypatch.setattr(shark_tpu.pipeline, "load_or_build_index",
                            _raise_stop)
        with pytest.raises(Stop):
            sub.run(160, 300)
        want = [str(ref / "genes160.fa"), str(ref / "reads160_300.fq")]
        got = bench_gpu.gen_txome(160, 300)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert os.path.getsize(a) > 0
        assert _same_files(a, b), f"{os.path.basename(a)} differs"


@pytest.fixture(scope="module")
def comparator(tmp_path_factory):
    """bench/baseline.cpp compiled once for the module's runs, and one
    cache directory they share (the stamps name every constant)."""
    _needs_gpp()
    d = tmp_path_factory.mktemp("bench_gpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(bench_gpu, "CACHE", str(d / "exe"))
    try:
        exe = bench_gpu.build_baseline()
    finally:
        mp.undo()
    return exe, str(d / "cache")


@pytest.fixture
def tiny(monkeypatch, comparator):
    exe, cache = comparator
    monkeypatch.setattr(config, "BF_UNIT_BITS", 1 << 22)
    monkeypatch.setattr(bench_gpu, "CACHE", cache)
    monkeypatch.setattr(bench_gpu, "build_baseline", lambda: exe)
    for name, v in TINY.items():
        monkeypatch.setattr(bench_gpu, name, v)


def _line(capsys):
    lines = capsys.readouterr()
    return json.loads(lines.out.strip().splitlines()[-1]), lines.err


def _schema_keys(bench_doc):
    """Every key of bench.py's docstring schema, its <wl>_ keys expanded
    for the five workloads (the panel's carry no prefix)."""
    keys = set(re.findall(r'"([a-z0-9_<>]+)":', bench_doc))
    out = set()
    for k in keys:
        if k.startswith("<wl>_"):
            out.update(p + k[5:] for p in
                       ("", "paired_", "q10_", "homolog_", "txome_"))
        else:
            out.add(k)
    return out


def test_tiny_run_is_exact_on_every_workload(tiny, capsys, reference_bench):
    rc = bench_gpu.main([], device="cpu")
    line, err = _line(capsys)
    assert rc == 0, err[-3000:]
    schema = _schema_keys(reference_bench.__doc__)
    assert len(schema) > 25
    missing = sorted(schema - set(line))
    assert not missing, missing
    for wl in WORKLOADS + ("native_cpu",):
        assert line[f"{wl}_exact"] is True, wl
    assert "error" not in line and "failures" not in line
    assert line["device"] == "cpu"
    assert line["workloads"] == list(WORKLOADS)
    assert line["txome_full_reads_checked"] == TINY["TXOME_READS"]
    assert line["txome_n_genes"] == TINY["TXOME_GENES"]
    assert 100 < line["txome_oracle_checked"] < 300
    assert line["gather_ceiling_measured"] is True
    assert set(line["gather_ceiling_ms"]) == {
        "index_select_sum", "idx_sum", "index_select", "rows_sum"}
    for k in ("value", "paired_reads_per_sec", "q10_reads_per_sec",
              "homolog_reads_per_sec", "txome_reads_per_sec",
              "native_cpu_reads_per_sec", "gather_ceiling_rows_s"):
        assert line[k] > 0, k
    assert {"panel_passes", "panel_revisit_passes", "txome_reload_tables",
            "txome_comparator"} <= set(line["stage_s"])


def _drop_emits(packed, winners):
    """Half the reads (the even rows) lose their emit flag."""
    odd = torch.arange(packed.shape[0], device=packed.device) % 2 == 1
    return (torch.where(odd, packed, packed & ~(1 << step.PACK_EMIT_SHIFT)),
            winners)


def _other_gene(packed, winners):
    """Every emitted single-winner verdict names its neighbour gene (id
    xor 1), in the packed verdict and in the winner list: the same
    association count, other genes."""
    nw = (packed >> step.PACK_NW_SHIFT) & ((1 << step.PACK_NW_BITS) - 1)
    emit = (packed >> step.PACK_EMIT_SHIFT) & 1
    grp = (packed >> step.PACK_GRP_SHIFT) & 1
    one = (nw == 1) & (emit == 1) & (grp == 0)
    winners = winners.clone()
    winners[:, 0] = torch.where(one, winners[:, 0] ^ 1, winners[:, 0])
    return torch.where(one, packed ^ 1, packed), winners


@pytest.mark.parametrize("workload, corrupt, message", [
    ("panel", _drop_emits,
     r"panel: association count \d+ differs from the comparator's \d+"),
    ("txome", _other_gene,
     "txome: full dump differs from the comparator's at sorted position"),
])
def test_planted_difference_fails_the_run(tiny, capsys, monkeypatch,
                                          workload, corrupt, message):
    call_packed = step.Classifier.call_packed

    def corrupted(self, packed, vmask):
        r = call_packed(self, packed, vmask)
        return corrupt(r[0], r[1]) + tuple(r[2:])

    monkeypatch.setattr(step.Classifier, "call_packed", corrupted)
    rc = bench_gpu.main(["--workload", workload], device="cpu")
    line, err = _line(capsys)
    assert rc == 1
    assert line[f"{workload}_exact"] is False
    assert line["workloads"] == [workload]
    assert re.search(message, err), err[-3000:]
    assert any(re.search(message, f) for f in line["failures"])
    assert "failed:" not in err  # a mismatch, not a crash


def test_without_a_card_the_line_holds_error(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench_gpu, "CACHE", "/nonexistent/bench_gpu")
    assert bench_gpu.main([]) == 1
    line, _ = _line(capsys)
    assert "no CUDA card" in line["error"]
    assert set(line) == {"metric", "unit", "error"}
