"""Multi-host in shark_tpu_torch: parallel/distributed.py's helpers, the
per-file-pair parts of run_files, and a real two-process launch through
the CLI (--coordinator localhost:<free port> --num-hosts 2 --host-id h,
torch.distributed over gloo) on the CPU, whose merged parts equal a
one-process port run, whose bytes are shark_tpu's. Each process has its own
timeout. The workload loads one small saved index (--load-index), which
both packages read."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from shark_tpu_torch import cli
from shark_tpu_torch.config import SharkConfig
from shark_tpu_torch.index.build import build_index
from shark_tpu_torch.parallel.distributed import (
    assign_files,
    host_suffixed,
    merge_outputs,
    merge_parts,
    run_files,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
K = 15
PROCESS_TIMEOUT_S = 180


def test_assign_files_round_robin():
    pairs = [(f"a{i}.fq", f"b{i}.fq") for i in range(7)]
    out = assign_files(pairs, 3)
    assert [len(x) for x in out] == [3, 2, 2]
    assert out[0][0] == (0, ("a0.fq", "b0.fq"))
    assert out[1][0] == (1, ("a1.fq", "b1.fq"))
    assert out[0][1] == (3, ("a3.fq", "b3.fq"))
    # deterministic and disjoint-complete, with global indices preserved
    flat = sorted(p for host in out for p in host)
    assert flat == list(enumerate(pairs))


def test_host_suffixed():
    assert host_suffixed("out.ssv", 0) == "out.ssv.0"
    assert host_suffixed("x.fq.gz", 3) == "x.fq.3.gz"
    assert host_suffixed("x.fq.gz", "part7") == "x.fq.part7.gz"


def test_merge_outputs(tmp_path):
    parts = []
    for h in range(3):
        p = tmp_path / f"part{h}"
        p.write_bytes(f"host{h}\n".encode())
        parts.append(str(p))
    dest = tmp_path / "merged"
    merge_outputs(parts, str(dest))
    assert dest.read_bytes() == b"host0\nhost1\nhost2\n"
    merge_outputs(parts, str(dest), remove=True)
    assert dest.read_bytes() == b"host0\nhost1\nhost2\n"
    assert not any(os.path.exists(p) for p in parts)


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """A saved 2^20-bit index of 12 genes (two families of three share a
    core) and 240 read pairs with Ns; mate 2 is the reverse complement of
    the sequence 100 bp downstream."""
    d = tmp_path_factory.mktemp("multihost")
    rng = np.random.default_rng(2024)
    comp = bytes.maketrans(b"ACGTN", b"TGCAN")
    genes = []
    for fam in range(2):
        core = BASES[rng.integers(0, 4, size=120)]
        for _ in range(3):
            genes.append(np.concatenate([BASES[rng.integers(0, 4, size=150)],
                                         core,
                                         BASES[rng.integers(0, 4, size=150)]]))
    genes += [BASES[rng.integers(0, 4, size=420)] for _ in range(6)]
    records = [(f"g{i:02d}", g.tobytes()) for i, g in enumerate(genes)]
    fa = d / "genes.fa"
    fa.write_bytes(b"".join(b">%s\n%s\n" % (n.encode(), s) for n, s in records))
    idx = str(d / "index.npz")
    build_index(records, K, 1 << 20).save(idx)
    mates = ([], [])
    for i in range(240):
        g = genes[int(rng.integers(0, len(genes)))]
        s = int(rng.integers(0, len(g) - 190))
        r1 = g[s:s + 90].copy()
        r1[rng.random(90) < 0.02] = ord("N")
        mates[0].append(b"@p%04d\n%s\n+\n%s\n" % (i, r1.tobytes(), b"I" * 90))
        r2 = g[s + 100:s + 190].tobytes().translate(comp)[::-1]
        mates[1].append(b"@p%04d\n%s\n+\n%s\n" % (i, r2, b"I" * 90))
    return d, str(fa), idx, mates


def _write_pairs(d, mates, cuts):
    """The read pairs cut at pair boundaries into one file pair a cut."""
    pairs = []
    for i, (lo, hi) in enumerate(cuts):
        fq = []
        for m in range(2):
            p = d / f"s{m + 1}_{i}.fq"
            p.write_bytes(b"".join(mates[m][lo:hi]))
            fq.append(str(p))
        pairs.append(tuple(fq))
    return pairs


def _argv(fa, idx, fq, out):
    return ["-r", fa, "-1", fq[0], "-2", fq[1], "-o", f"{out}.1.fq",
            "-p", f"{out}.2.fq", "--ssv", f"{out}.ssv", "--load-index", idx,
            "-k", str(K), "--backend", "cpu", "--batch-size", "32",
            "--compile-cache", ""]


def _bytes(out):
    return tuple(open(f"{out}{ext}", "rb").read()
                 for ext in (".ssv", ".1.fq", ".2.fq"))


@pytest.fixture(scope="module")
def one_process(workload):
    """The whole sample through the port's CLI in one process."""
    d, fa, idx, mates = workload
    (whole,) = _write_pairs(d, mates, [(0, 240)])
    out = str(d / "one")
    assert cli.main(_argv(fa, idx, whole, out)) == 0
    want = _bytes(out)
    assert want[0], "workload emitted no association"
    return want


def test_one_process_matches_shark_tpu(workload, one_process):
    """shark_tpu's CLI writes the same bytes on the whole sample."""
    pytest.importorskip("jax")
    from shark_tpu import cli as jcli

    d, fa, idx, mates = workload
    (whole,) = _write_pairs(d, mates, [(0, 240)])
    out = str(d / "jax")
    assert jcli.main(_argv(fa, idx, whole, out)) == 0
    assert _bytes(out) == one_process


def test_run_files_parts_merge_to_one_process_run(workload, one_process,
                                                  tmp_path):
    """Two hosts, three file pairs round-robin (host 0 takes pairs 0 and
    2, host 1 pair 1), run in turn in this process: the parts merged in
    global index order are the one-process bytes."""
    d, fa, idx, mates = workload
    pairs = _write_pairs(tmp_path, mates, [(0, 20), (20, 130), (130, 240)])
    out = str(tmp_path / "out")
    for host in (0, 1):
        cfg = SharkConfig(
            fasta_path=fa, sample1_path="", load_index=idx, k=K,
            batch_size=32, backend="cpu", ssv_path=f"{out}.ssv",
            out1_path=f"{out}.1.fq", out2_path=f"{out}.2.fq")
        done = run_files(cfg, pairs, host, 2)
        assert [gi for gi, _ in done] == ([0, 2] if host == 0 else [1])
    for ext in (".ssv", ".1.fq", ".2.fq"):
        merge_parts(out + ext, len(pairs))
    assert _bytes(out) == one_process


def test_two_process_cli(workload, one_process, tmp_path):
    """Two CLI processes at once, each with half the pairs, join one
    gloo process group and write per-host parts (and stats); merged in
    host order they are the one-process bytes."""
    d, fa, idx, mates = workload
    halves = _write_pairs(tmp_path, mates, [(0, 120), (120, 240)])
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = str(tmp_path / "out")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "shark_tpu_torch",
             *_argv(fa, idx, halves[h], out),
             "--stats-json", str(tmp_path / "stats.json"),
             "--coordinator", f"localhost:{port}", "--num-hosts", "2",
             "--host-id", str(h)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=str(tmp_path),
            env=env)
        for h in range(2)
    ]
    try:
        for p in procs:
            _, err = p.communicate(timeout=PROCESS_TIMEOUT_S)
            assert p.returncode == 0, err.decode()[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for ext in (".ssv", ".1.fq", ".2.fq"):
        merge_outputs([host_suffixed(out + ext, h) for h in range(2)],
                      out + ext)
    assert _bytes(out) == one_process
    for h in range(2):
        assert (tmp_path / f"stats.json.{h}").exists()


@pytest.mark.parametrize(
    "flags, message",
    [
        (["--num-hosts", "2"], "--num-hosts > 1 requires --coordinator"),
        (["--num-hosts", "2", "--coordinator", "localhost:1",
          "--backend", "native"], "--backend native is single-host"),
    ],
    ids=["no-coordinator", "native"],
)
def test_multi_host_refusals(flags, message, capsys, tmp_path):
    fa = tmp_path / "g.fa"
    fq = tmp_path / "r.fq"
    fa.write_bytes(b">g\nACGT\n")
    fq.write_bytes(b"@r\nACGT\n+\nIIII\n")
    assert cli.main(["-r", str(fa), "-1", str(fq), *flags]) == 1
    assert message in capsys.readouterr().err
