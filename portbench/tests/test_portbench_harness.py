"""The harness: a cell added from new files alone runs; the check catches
each fault a cell can have and the control; without a card or without the
program there is no result; nothing it imports is JAX or shark_tpu."""

import ast
import json
import os
import subprocess
import sys

import pytest

from portbench.run import CHECK_LIMITS
from conftest import (REPO, TEST_BF_UNIT_BITS, TINY_FLAGS, TINY_GENES, Bench,
                      tiny_traffic)

FORBIDDEN = {"jax", "jaxlib", "flax", "shark_tpu"}


def tiny_cell(bench: Bench, traffic: str = "paired") -> str:
    return bench.add_cell(f"tiny.{traffic}", TINY_GENES, TINY_FLAGS,
                          tiny_traffic(traffic), f"tiny_{traffic}")


def tiny_capture(bench: Bench) -> str:
    """Single-end reads, every one from the genes: many answers a batch."""
    return bench.add_cell("tiny.capture", TINY_GENES, TINY_FLAGS,
                          tiny_traffic("sample", from_genes=1.0),
                          "tiny_capture")


@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_from_new_files(bench, trace):
    """A third cell: a new configuration file, a new traffic file and a
    new entry of BENCHMARK.json, run by the CPU rehearsal."""
    cell = tiny_cell(bench)
    rc, result, err = bench.rehearse(cell, trace=trace)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, err[-3000:]
    assert result["attempted"] >= 1 and result["failed"] == 0
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in spec[kind] if cell in m.get(
        "workloads", [cell])}
    have = set(result["metrics"])
    if trace:  # no device on the CPU: its trace readers find nothing
        names -= {"device.idle_pct", "kernels.roofline_pct"}
    assert names <= have
    assert list(result)[-1] == "checks"
    assert all(v == {"value": 0, "limit": 0}
               for v in result["checks"].values())


def test_cell_scoped_readers(bench):
    """The per-layer metrics kept for some cells alone (a `workloads` key)
    read in a cell that lists them: the rate per layer, and each `.tail`
    reader as the reader it stands for."""
    cell = tiny_cell(bench, "sample")
    path = os.path.join(bench.root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    scoped = [m for m in spec["per_layer"] if "workloads" in m]
    for m in scoped:
        m["workloads"].append(cell)
    with open(path, "w") as f:
        json.dump(spec, f)
    rc, result, err = bench.rehearse(cell, trace=1)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, err[-3000:]
    have = result["metrics"]
    on_cpu = {"device.idle_pct", "kernels.roofline_pct"}  # no device trace
    for m in scoped:
        base = m["name"].removesuffix(".tail")
        if base in on_cpu:
            assert m["name"] not in have
        else:
            assert have[m["name"]]["value"] > 0, m["name"]
    assert have["step.call_ms.tail"]["unit"] == "ms"
    assert have["pipeline.reads_per_s"]["unit"] == "reads/s"


@pytest.mark.parametrize("fault", ["half_batch", "answer"])
def test_faults_fail_the_check(bench, fault):
    """Half of each batch left out, or one answer altered where it is
    produced (the drain's winner pairs): `correct` comes out false."""
    cell = tiny_capture(bench)
    rc, result, err = bench.rehearse(cell, fault=fault)
    assert rc == 0, err[-3000:]
    assert result["correct"] is False
    assert result["checks"]["ssv_lines_differ"]["value"] > 0
    if fault == "half_batch":
        assert result["failed"] == result["attempted"]


@pytest.mark.parametrize("traffic", ["sample", "paired", "capture"])
def test_the_control_fails(bench, traffic):
    """The reference with forward k-mers only, in the program's place:
    the harness's verdict is false, and every number reads above its
    limit of 0."""
    cell = (tiny_capture(bench) if traffic == "capture"
            else tiny_cell(bench, traffic))
    code = f"""
import sys
sys.path.insert(0, {bench.root!r})
from portbench import control, run
run.BF_UNIT_BITS = {TEST_BF_UNIT_BITS}
sys.exit(control.main(["--workload", {cell!r}, "--cpu", "--seeds", "1",
                       "2", str(2 ** 31 + 3)]))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    assert len(lines) == 3
    for line in lines:
        out = json.loads(line)
        assert out.pop("correct") is False, out
        out.pop("seed"), out.pop("seconds")
        assert all(v > CHECK_LIMITS[k] for k, v in out.items()), out


def run_script(root: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "panel1385.sample",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    p = run_script(REPO)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA card" in p.stderr


def test_no_program_no_result(tmp_path):
    Bench(str(tmp_path), with_program=False)
    assert sorted(os.listdir(tmp_path)) == ["BENCHMARK.json", "portbench"]
    p = run_script(str(tmp_path))
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def imports_of(path: str):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def bench_sources():
    top = os.path.join(REPO, "portbench")
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__")]
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_imports():
    """No top-level name of JAX or shark_tpu (compared whole: the port's
    name begins with it) in the harness, its readers or the reference;
    the reference imports nothing of the program either."""
    for path in bench_sources():
        tops = {m.split(".")[0] for m in imports_of(path)}
        assert not tops & FORBIDDEN, path
        if os.sep + "reference" + os.sep in path:
            assert "shark_tpu_torch" not in tops, path
    code = f"""
import glob, importlib.util, sys
sys.path.insert(0, {REPO!r})
import portbench.run, portbench.control, portbench.reference.shark
for p in glob.glob({REPO!r} + "/portbench/metrics/*.py"):
    s = importlib.util.spec_from_file_location("m", p)
    s.loader.exec_module(importlib.util.module_from_spec(s))
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert not set(ast.literal_eval(p.stdout.strip())) & FORBIDDEN
