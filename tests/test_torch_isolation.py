"""shark_tpu_torch stands alone, and says what it does not do yet.

- importing it imports neither jax nor shark_tpu, and no source of the
  port (nor chip_smoke.py) imports them;
- its C++ host engine is shark_tpu's, byte for byte;
- with no CUDA device and no explicit request for the CPU, its entry
  points raise instead of carrying on on the CPU;
- every option whose path is not ported raises "not in the port yet".
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

from shark_tpu_torch import cli, pipeline
from shark_tpu_torch.classify import step
from shark_tpu_torch.config import NOT_PORTED, SharkConfig
from shark_tpu_torch.index.build import build_index

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "shark_tpu_torch")


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "shark_tpu")


def test_import_leaves_out_jax_and_shark_tpu():
    code = (
        "import sys, shark_tpu_torch, shark_tpu_torch.cli, "
        "shark_tpu_torch.convert, shark_tpu_torch.kernels, "
        "shark_tpu_torch.classify.table_cache; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'shark_tpu')); print(bad); sys.exit(bool(bad))"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_import_no_jax_and_no_shark_tpu():
    seen = 0
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call) and node.args
                  and isinstance(node.args[0], ast.Constant)
                  and isinstance(node.args[0].value, str)
                  and getattr(node.func, "attr",
                              getattr(node.func, "id", "")) in
                  ("import_module", "__import__")):
                names = [node.args[0].value]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path}:{node.lineno} imports {bad}"
        seen += 1
    assert seen > 20


def test_native_engine_source_is_shark_tpu_s():
    with open(os.path.join(ROOT, "shark_tpu", "native", "shark_native.cpp"),
              "rb") as a, open(os.path.join(PORT, "native", "shark_native.cpp"),
                               "rb") as b:
        assert a.read() == b.read()


def test_entry_points_without_cuda_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        step.resolve_device()
    index = build_index([("g", b"ACGTACGTTGCAACGTTGCA" * 4)], 11, 1 << 12)
    with pytest.raises(RuntimeError, match="CUDA"):
        step.Classifier(index)
    assert step.Classifier(index, device="cpu").device.type == "cpu"
    fa = tmp_path / "g.fa"
    fa.write_bytes(b">g\nACGTACGTTGCAACGTTGCA\n")
    fq = tmp_path / "r.fq"
    fq.write_bytes(b"@r\nACGTACGTTGCA\n+\nIIIIIIIIIIII\n")
    cfg = SharkConfig(fasta_path=str(fa), sample1_path=str(fq),
                      out1_path=str(tmp_path / "o.fq"),
                      ssv_path=str(tmp_path / "o.ssv"))
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.run_pipeline(cfg)


def test_kernel_wrappers_take_the_plain_path_only_on_cpu_tensors():
    """A CPU tensor runs the plain version and counts no launch."""
    from shark_tpu_torch import kernels

    kernels.LAUNCHES.reset()
    step.extract_pairs(torch.zeros(4, dtype=torch.int32),
                       torch.zeros((4, 2), dtype=torch.int32), 8)
    assert kernels.LAUNCHES.snapshot() == {n: 0 for n in kernels.KERNELS}


@pytest.mark.parametrize(
    "flags",
    [
        ["--devices", "2"],
        ["--sharded-bf"],
        ["--num-hosts", "2", "--coordinator", "localhost:1234"],
        ["--backend", "native"],
        ["--profile-dir", "trace"],
        ["--probe", "xl"],
        ["--probe", "classic"],
    ],
    ids=lambda f: f[0].lstrip("-") + ("-" + f[1] if f[0] == "--probe" else ""),
)
def test_deferred_flags_raise_not_ported(flags, capsys, tmp_path):
    fa = tmp_path / "g.fa"
    fq = tmp_path / "r.fq"
    fa.write_bytes(b">g\nACGT\n")
    fq.write_bytes(b"@r\nACGT\n+\nIIII\n")
    rc = cli.main(["-r", str(fa), "-1", str(fq), *flags])
    assert rc == 1
    assert NOT_PORTED in capsys.readouterr().err


def test_probe_layouts_not_ported_raise_in_classifier():
    index = build_index([("g", b"ACGTACGTTGCAACGTTGCA" * 4)], 11, 1 << 12)
    for probe in ("xl", "classic"):
        with pytest.raises(NotImplementedError, match=NOT_PORTED):
            step.Classifier(index, device="cpu", probe=probe)


def test_index_without_a_hashed_table_raises(monkeypatch):
    """Where shark_tpu's auto-selection would fall back to xl or classic,
    the port refuses instead of substituting a layout."""
    from shark_tpu_torch.classify import hashed

    monkeypatch.setattr(hashed, "build_hashed_index", lambda *a, **k: None)
    index = build_index([("g", b"ACGTACGTTGCAACGTTGCA" * 4)], 11, 1 << 12)
    with pytest.raises(NotImplementedError, match=NOT_PORTED):
        step.Classifier(index, device="cpu")
