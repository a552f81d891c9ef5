"""shark_tpu_torch stands alone, and runs every option shark_tpu runs.

- importing it imports neither jax nor shark_tpu, and no source of the
  port (nor chip_smoke.py, nor scripts/fuzz_soak_torch.py and the seed
  body it loads, nor the stage profilers in scripts/) imports them;
- bench_gpu.py, the port's bench, imports and loads neither them nor
  bench.py or bench/, also while it runs;
- its C++ host engine is shark_tpu's, byte for byte;
- with no CUDA device and no explicit request for the CPU, its entry
  points raise instead of carrying on on the CPU;
- the options the early slices of the port refused (--devices N,
  --num-hosts N, --backend native, --profile-dir) now run;
- --devices asks for no more devices than there are;
- probe options are refused as shark_tpu refuses them.
"""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

from shark_tpu_torch import cli, pipeline
from shark_tpu_torch.classify import step
from shark_tpu_torch.config import SharkConfig
from shark_tpu_torch.index.build import build_index
from shark_tpu_torch.parallel import sharded_bf
from shark_tpu_torch.parallel.mesh import make_devices
from shark_tpu_torch.parallel.sharded_bf import ShardedBFClassifier

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "shark_tpu_torch")
# the end-to-end stage profilers (scripts/)
STAGE_SCRIPTS = ("profile_e2e_torch", "dispatch_bench_torch",
                 "parser_bench_torch", "trace_report_torch")


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "scripts", "fuzz_soak_torch.py")
    for name in STAGE_SCRIPTS:
        yield os.path.join(ROOT, "scripts", f"{name}.py")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "shark_tpu")


def test_import_leaves_out_jax_and_shark_tpu():
    code = (
        "import sys, shark_tpu_torch, shark_tpu_torch.cli, "
        "shark_tpu_torch.convert, shark_tpu_torch.kernels, "
        "shark_tpu_torch.classify.hashed, shark_tpu_torch.classify.table_cache, "
        "shark_tpu_torch.parallel.mesh, shark_tpu_torch.parallel.sharded_bf, "
        "shark_tpu_torch.parallel.data_parallel, "
        "shark_tpu_torch.parallel.distributed, "
        "shark_tpu_torch.experiments.gather_tiles, "
        "shark_tpu_torch.experiments.resident_match; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'shark_tpu')); print(bad); sys.exit(bool(bad))"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_soak_and_its_seed_body_load_without_jax():
    """scripts/fuzz_soak_torch.py and the per-seed body it loads by path
    (tests/test_torch_fuzz.py, which chip_smoke.py loads too) import
    neither jax nor shark_tpu: the card machine has no jax."""
    code = (
        "import importlib.util, sys\n"
        "for name, path in (('soak', 'scripts/fuzz_soak_torch.py'), "
        "('body', 'tests/test_torch_fuzz.py')):\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'shark_tpu')); print(bad); sys.exit(bool(bad))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stdout + out.stderr


def test_stage_profilers_load_without_jax():
    """The stage profilers and the modules they bring (bench_gpu.py,
    shark_tpu_torch/utils/trace.py, shark_tpu_torch/floors.py) import
    neither jax nor shark_tpu, nor bench.py or bench/."""
    code = (
        "import importlib.util, sys\n"
        f"for name in {STAGE_SCRIPTS!r}:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, f'scripts/{name}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import shark_tpu_torch.floors, shark_tpu_torch.utils.trace\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'shark_tpu', 'bench')); print(bad); "
        "sys.exit(bool(bad))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
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


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            yield node.lineno, "." * node.level + (node.module or "")


def test_bench_gpu_source_imports_no_reference():
    path = os.path.join(ROOT, "bench_gpu.py")
    names = list(_imported_modules(path))
    assert any(n.startswith("shark_tpu_torch") for _, n in names)
    for line, name in names:
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "shark_tpu", "bench", ""), (
            f"bench_gpu.py:{line} imports {name}")
    with open(path) as f:
        src = f.read()
    assert "import_module" not in src and "spec_from_file_location" not in src


def test_bench_gpu_run_loads_no_jax_shark_tpu_or_bench(tmp_path):
    """A tiny panel run of bench_gpu.main (device="cpu", the comparator
    and the C++ engine built) leaves no jax, shark_tpu or bench module
    loaded."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed for the comparator and the C++ engine")
    code = (
        "import sys\n"
        "import bench_gpu as b\n"
        "from shark_tpu_torch import config\n"
        "config.BF_UNIT_BITS = 1 << 22\n"
        "b.CACHE = sys.argv[1]\n"
        "b.N_GENES, b.N_READS, b.N_PAIRS, b.BATCH = 20, 500, 100, 256\n"
        "rc = b.main(['--workload', 'panel'], device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'shark_tpu', 'bench'))\n"
        "print(bad); sys.exit(rc or bool(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=240, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


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
    n_fix = torch.zeros(1, dtype=torch.int32)
    step.finish_group_count(idx, idx, n_fix, has_rows=True,
                            meta=type("Meta", (), {"rows_bits": 4}))
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
        ["--devices", "2", "--backend", "cpu"],
        ["--num-hosts", "2", "--coordinator", "localhost:1234",
         "--backend", "cpu"],
        ["--backend", "native"],
        ["--profile-dir", "trace", "--backend", "cpu"],
    ],
    ids=lambda f: f[0].lstrip("-"),
)
def test_deferred_flags_raise_not_ported(flags, capsys, tmp_path, monkeypatch):
    """The four options the early slices refused with "not in the port
    yet" now run through the CLI and write the bytes of a plain --backend
    cpu run: --devices 2 over two torch CPU devices ("cpu" and "cpu:0";
    the host counts as one device to --devices, so the device list is
    given), --num-hosts 2 as host 0 with the process group stubbed (its
    outputs carry the .0 suffix), --backend native and --profile-dir
    (a trace file)."""
    from shark_tpu_torch.parallel import distributed, mesh

    monkeypatch.setattr("shark_tpu_torch.config.BF_UNIT_BITS", 1 << 20)
    monkeypatch.chdir(tmp_path)  # the trace directory is relative
    two = [torch.device("cpu"), torch.device("cpu", 0)]
    for mod in (mesh, pipeline):
        monkeypatch.setattr(mod, "make_devices", lambda n, d=None: two[:n])
    joined = []
    monkeypatch.setattr(distributed, "initialize",
                        lambda *a: joined.append(a))
    monkeypatch.setattr(distributed, "shutdown", lambda wait=True: None)
    gene = b"ACGTTGCAAGCTTCGAGGATCCTTAGGCATGCAAGTCGACCTGCAGGAATTCCCGGGTAC"
    fa = tmp_path / "g.fa"
    fq = tmp_path / "r.fq"
    fa.write_bytes(b">g\n" + gene + b"\n")
    fq.write_bytes(b"@r\n" + gene[5:50] + b"\n+\n" + b"I" * 45 + b"\n")

    def run(tag, extra):
        assert cli.main(["-r", str(fa), "-1", str(fq), "-k", "15",
                         "--batch-size", "8", "-o", str(tmp_path / f"{tag}.fq"),
                         "--ssv", str(tmp_path / f"{tag}.ssv"), *extra]) == 0
        sfx = ".0" if "--num-hosts" in extra else ""
        return [(tmp_path / f"{tag}.{ext}{sfx}").read_bytes()
                for ext in ("ssv", "fq")]

    want = run("plain", ["--backend", "cpu"])
    assert want[0] == b"r g\n"
    assert run("flag", flags) == want
    assert "not in the port yet" not in capsys.readouterr().err
    if "--num-hosts" in flags:
        assert joined == [("localhost:1234", 2, 0)]
    if "--profile-dir" in flags:
        assert list((tmp_path / "trace").glob("*.pt.trace.json"))


def test_sharded_devices_past_the_count_raise(capsys, tmp_path):
    """--devices N, sharded or replicated, is as strict as shark_tpu's
    make_mesh: more devices than there are is an error (the CPU counts as
    one device)."""
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_devices(2, "cpu")
    assert make_devices(0, "cpu") == make_devices(1, "cpu") == [
        torch.device("cpu")]
    fa = tmp_path / "g.fa"
    fq = tmp_path / "r.fq"
    fa.write_bytes(b">g\nACGT\n")
    fq.write_bytes(b"@r\nACGT\n+\nIIII\n")
    for flags in (["--sharded-bf", "--devices", "2"], ["--devices", "2"]):
        rc = cli.main(["-r", str(fa), "-1", str(fq), *flags, "--backend",
                       "cpu"])
        assert rc == 1
        assert "requested 2 devices, have 1" in capsys.readouterr().err
    for sharded in (True, False):
        cfg = SharkConfig(fasta_path=str(fa), sample1_path=str(fq),
                          out1_path=str(tmp_path / "o.fq"), sharded_bf=sharded,
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
