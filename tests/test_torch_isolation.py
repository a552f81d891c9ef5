"""shark_tpu_torch stands alone, and says what it does not do yet.

- importing it imports neither jax nor shark_tpu, and no source of the
  port (nor chip_smoke.py) imports them;
- its C++ host engine is shark_tpu's, byte for byte;
- with no CUDA device and no explicit request for the CPU, its entry
  points raise instead of carrying on on the CPU;
- every option whose path is not ported raises "not in the port yet";
- --sharded-bf asks for no more devices than there are;
- probe options are refused as shark_tpu refuses them.
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
from shark_tpu_torch.parallel import sharded_bf
from shark_tpu_torch.parallel.mesh import make_devices
from shark_tpu_torch.parallel.sharded_bf import ShardedBFClassifier

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
        "shark_tpu_torch.classify.hashed, shark_tpu_torch.classify.table_cache, "
        "shark_tpu_torch.parallel.mesh, shark_tpu_torch.parallel.sharded_bf, "
        "shark_tpu_torch.experiments.gather_tiles, "
        "shark_tpu_torch.experiments.resident_match; "
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
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedBFClassifier(index)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-r", str(fa), "-1", str(fq), "--sharded-bf"])


def test_kernel_wrappers_take_the_plain_path_only_on_cpu_tensors():
    """A CPU tensor runs the plain version and counts no launch."""
    from shark_tpu_torch import kernels

    from shark_tpu_torch.classify import hashed
    from shark_tpu_torch.experiments import gather_tiles, resident_match

    kernels.LAUNCHES.reset()
    step.extract_pairs(torch.zeros(4, dtype=torch.int32),
                       torch.zeros((4, 2), dtype=torch.int32), 8)
    idx = torch.zeros((2, 3), dtype=torch.uint32)
    valid = torch.ones((2, 3), dtype=torch.bool)
    rows = torch.zeros((4, 2), dtype=torch.uint32)
    step.probe_tags(idx, idx, valid, rows, rows)
    xl = hashed.HashedMeta(lgB=6, has_rows=False, entry16=True, slots=4,
                           xl=True, side_lgB=6, has_side=True)
    side = torch.zeros((64, 2, 8), dtype=torch.uint32)
    stash = torch.from_numpy(hashed.empty_stash())
    hashed.probe_xl(idx, idx, valid, torch.zeros((64, 4), dtype=torch.uint32),
                    side, stash, xl)
    win = lambda t: t.view(1, 2, 3)  # noqa: E731
    send, slot, owner, _ = sharded_bf.shard_route(
        win(idx), win(idx), win(valid), n=1, wps=4, wide=False, cap=8)
    reply = sharded_bf.shard_probe(send.transpose(0, 1).contiguous(),
                                   rows.view(1, 4, 2), rows.view(1, 4, 2))
    sharded_bf.shard_return(reply, owner, slot)
    gather_tiles.gather_tiles(torch.zeros((1, 128), dtype=torch.uint32),
                              torch.zeros(gather_tiles.CHUNK, dtype=torch.int32))
    resident_match.resident_match(
        torch.zeros(resident_match.CHUNK, dtype=torch.int32),
        torch.zeros(resident_match.CHUNK, dtype=torch.uint32),
        torch.zeros((1, 128), dtype=torch.uint32))
    assert kernels.LAUNCHES.snapshot() == {n: 0 for n in kernels.KERNELS}


@pytest.mark.parametrize(
    "flags",
    [
        ["--devices", "2"],
        ["--num-hosts", "2", "--coordinator", "localhost:1234"],
        ["--backend", "native"],
        ["--profile-dir", "trace"],
    ],
    ids=lambda f: f[0].lstrip("-"),
)
def test_deferred_flags_raise_not_ported(flags, capsys, tmp_path):
    fa = tmp_path / "g.fa"
    fq = tmp_path / "r.fq"
    fa.write_bytes(b">g\nACGT\n")
    fq.write_bytes(b"@r\nACGT\n+\nIIII\n")
    rc = cli.main(["-r", str(fa), "-1", str(fq), *flags])
    assert rc == 1
    assert NOT_PORTED in capsys.readouterr().err


def test_sharded_devices_past_the_count_raise(capsys, tmp_path):
    """--devices N is as strict as shark_tpu's make_mesh: more devices
    than there are is an error (the CPU counts as one device)."""
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_devices(2, "cpu")
    assert make_devices(0, "cpu") == make_devices(1, "cpu") == [
        torch.device("cpu")]
    fa = tmp_path / "g.fa"
    fq = tmp_path / "r.fq"
    fa.write_bytes(b">g\nACGT\n")
    fq.write_bytes(b"@r\nACGT\n+\nIIII\n")
    rc = cli.main(["-r", str(fa), "-1", str(fq), "--sharded-bf", "--devices",
                   "2", "--backend", "cpu"])
    assert rc == 1
    assert "requested 2 devices, have 1" in capsys.readouterr().err
    cfg = SharkConfig(fasta_path=str(fa), sample1_path=str(fq),
                      out1_path=str(tmp_path / "o.fq"), sharded_bf=True,
                      devices=3, backend="cpu")
    with pytest.raises(ValueError, match="requested 3 devices"):
        pipeline.run_pipeline(cfg)


@pytest.mark.parametrize("probe", [None, "hashed", "classic"])
@pytest.mark.parametrize("opt", ["lgB", "side_lgB"])
def test_xl_geometry_without_probe_xl_raises(probe, opt):
    """Pinned xl geometries are taken only with probe="xl" (shark_tpu
    step.py:1296-1297); the auto fallbacks: tests/test_torch_xl.py."""
    index = build_index([("g", b"ACGTACGTTGCAACGTTGCA" * 4)], 11, 1 << 12)
    with pytest.raises(ValueError, match="require probe='xl'"):
        step.Classifier(index, device="cpu", probe=probe,
                        probe_opts={opt: 8})
    assert step.Classifier(index, device="cpu", probe="xl",
                           probe_opts={opt: 8}).probe == "xl"
