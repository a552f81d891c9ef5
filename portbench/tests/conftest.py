"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary directory with the program beside it, and tiny cells in it
made of new configuration and traffic files only.

    python -m pytest portbench/tests -q
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the -b unit the CPU tests run at (2^33 bits on the card)
TEST_BF_UNIT_BITS = 1 << 22

# tiny versions of the benchmark's traffic, and a gene set small enough
# for the CPU, with families
TINY_GENES = {"count": 40, "length": 400, "name_prefix": "G",
              "name_digits": 5, "family_every": 10, "family_size": 4,
              "family_core": 120}
TINY_FLAGS = ["-k", "17", "-c", "0.6", "-b", "1", "-q", "0", "-t", "1",
              "--batch-size", "256"]


def tiny_traffic(name: str, **over) -> dict:
    """A traffic file of the benchmark at a tiny size, with `over` set."""
    with open(os.path.join(REPO, "portbench", "traffic", name + ".json")) as f:
        t = json.load(f)
    t["reads"] = 600
    if t["layout"] == "paired":
        t["fragment_len"] = 200
    t.update(over)
    return t


class Bench:
    """A benchmark copy under `root`, where cells are added from new files
    and run by the harness's CPU rehearsal in a fresh process."""

    def __init__(self, root: str, with_program: bool = True):
        self.root = root
        shutil.copytree(os.path.join(REPO, "portbench"),
                        os.path.join(root, "portbench"),
                        ignore=shutil.ignore_patterns("__pycache__", "tests"))
        shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
        if with_program:
            os.symlink(os.path.join(REPO, "shark_tpu_torch"),
                       os.path.join(root, "shark_tpu_torch"))

    def add_cell(self, name: str, genes: dict, flags: list, traffic: dict,
                 traffic_name: str) -> str:
        """A new configuration file, a new traffic file and a new entry of
        BENCHMARK.json; no file of the benchmark is edited."""
        conf_name = name.split(".")[0]
        conf_file = f"portbench/configs/{conf_name}.json"
        with open(os.path.join(self.root, conf_file), "w") as f:
            json.dump({"flags": flags, "genes": genes}, f)
        with open(os.path.join(self.root, "portbench", "traffic",
                               traffic_name + ".json"), "w") as f:
            json.dump(traffic, f)
        path = os.path.join(self.root, "BENCHMARK.json")
        with open(path) as f:
            bench = json.load(f)
        bench["configs"].append({"name": conf_name, "source": "a test",
                                 "file": conf_file, "reduced": [],
                                 "why": "a test"})
        bench["workloads"].append({"name": name, "config": conf_name,
                                   "traffic": traffic_name, "chips": 1,
                                   "why": "a test"})
        with open(path, "w") as f:
            json.dump(bench, f)
        return name

    def rehearse(self, cell: str, seed: int = 2147483653, trace: int = 0,
                 seconds: float = 1.0, fault: str = "") -> tuple:
        """Run `cell` through portbench/run.py's main on the CPU in a new
        process, the -b unit shrunk on both sides and `fault` planted in
        the program; returns (exit code, the result line or None,
        stderr)."""
        code = REHEARSAL.format(root=self.root, bits=TEST_BF_UNIT_BITS,
                                fault=fault, argv=[
                                    "--workload", cell, "--seed", str(seed),
                                    "--seconds", str(seconds), "--trace",
                                    str(trace)])
        p = subprocess.run([sys.executable, "-c", code], cwd=self.root,
                           capture_output=True, text=True, timeout=600,
                           env={**os.environ, "JAX_PLATFORMS": "cpu"})
        lines = p.stdout.strip().splitlines()
        result = json.loads(lines[-1]) if lines else None
        return p.returncode, result, p.stderr


REHEARSAL = """
import importlib.util, sys
sys.path.insert(0, {root!r})
import shark_tpu_torch.config
shark_tpu_torch.config.BF_UNIT_BITS = {bits}
if {fault!r}:
    from portbench import control
    control.plant({fault!r})
spec = importlib.util.spec_from_file_location(
    "portbench_run", {root!r} + "/portbench/run.py")
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
run.BF_UNIT_BITS = {bits}
sys.exit(run.main({argv!r}, allow_cpu=True))
"""


@pytest.fixture
def bench(tmp_path):
    return Bench(str(tmp_path))
