"""The sharded Bloom filter of shark_tpu_torch against shark_tpu.

The port's ShardedBFClassifier runs its kernels' plain versions on a list
of CPU devices (["cpu"] * n: n shards stacked on one device, exchanged by
a transpose); shark_tpu's runs on the conftest's eight virtual CPU
devices. On the workloads of tests/test_sharded_bf.py, made with numpy
from seeds and given to both packages, the two must agree bit for bit:
the shard tables, the owner split (narrow and wide, and against a numpy
uint64 oracle at a > 2^36-bit geometry), and all five outputs (packed,
winners, best_cov, length, per-shard overflow) at n in {1, 8}, narrow and
force_wide, on the byte and the packed wire, including a call whose
routing overflows (which pins the slot order). reprobe, run_pipeline's
retry on both paths, and the CLI's --backend cpu --sharded-bf bytes are
checked too. Every comparison is exact."""

import json

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from shark_tpu.index.build import build_index  # noqa: E402
from shark_tpu.ops.kmers import encode_bytes  # noqa: E402
from shark_tpu.parallel import sharded_bf as jsharded  # noqa: E402
from shark_tpu_torch.classify.step import Classifier  # noqa: E402
from shark_tpu_torch.config import SharkConfig  # noqa: E402
from shark_tpu_torch.convert import index_from_arrays  # noqa: E402
from shark_tpu_torch.parallel import sharded_bf as tsharded  # noqa: E402
from shark_tpu_torch.pipeline import run_pipeline  # noqa: E402
from test_sharded_bf import K, _decode, _records_of, workload  # noqa: E402,F401
from test_torch_pipeline import _family_fastx, _outputs  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

NAMES = ("packed", "winners", "best_cov", "length", "overflow")


def _port(index):
    return index_from_arrays(vars(index))


def _planar(codes):
    """shark_tpu's planar (packed, vmask) wire of byte codes."""
    B, L = codes.shape
    L4, L8 = L // 4, L // 8
    packed = np.zeros((B, L4), dtype=np.uint8)
    vmask = np.zeros((B, L8), dtype=np.uint8)
    for i in range(L):
        c = codes[:, i]
        v = c < 4
        packed[:, i % L4] |= np.where(v, c, 0).astype(np.uint8) << (2 * (i // L4))
        vmask[:, i % L8] |= v.astype(np.uint8) << (i // L8)
    return packed, vmask


def _assert_equal(got, want, what=""):
    assert len(got) == len(want) == 5
    for name, g, w in zip(NAMES, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"{name} {what}")


@pytest.fixture(scope="module")
def jax_results(workload):  # noqa: F811
    """shark_tpu's sharded outputs on the byte wire, one jit each: n in
    {1, 8} x (narrow, wide), and the overflowing slack=0.05 call at n = 8."""
    index, codes = workload
    out = {}
    for n in (1, 8):
        for wide in (False, True):
            clf = jsharded.ShardedBFClassifier(
                index, max_winners=8, c=0.6, n_devices=n, force_wide=wide)
            out[n, wide] = [np.asarray(x) for x in clf(codes)]
    clf = jsharded.ShardedBFClassifier(
        index, max_winners=8, c=0.6, n_devices=8, slack=0.05)
    out["slack"] = [np.asarray(x) for x in clf(codes)]
    return out


@pytest.mark.parametrize("n", [1, 8])
def test_shard_index_matches_shark_tpu(workload, n):  # noqa: F811
    index, _ = workload
    want = jsharded.shard_index(index, n)
    got = tsharded.shard_index(_port(index), n)
    for name, w, g in zip(("bf_ranks", "pays", "wps", "counts"), want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_wide_owner_local_matches_uint64_oracle():
    """The wide owner split at a real > 2^36-bit geometry, every shard
    boundary's +-1 word included, against numpy uint64 arithmetic and
    against shark_tpu's limb form."""
    n = 8
    size_bits = (1 << 37) + (5 << 33)
    wps = size_bits // 32 // n
    rng = np.random.default_rng(11)
    addr = (rng.integers(0, 1 << 62, size=4096, dtype=np.int64).astype(np.uint64)
            % np.uint64(size_bits))
    edges = [(s * wps + d) * 32 + 7 for s in range(1, n) for d in (-1, 0, 1)]
    addr = np.concatenate([addr, np.asarray(edges, np.uint64)])
    word = addr >> np.uint64(5)
    exp_owner = (word // np.uint64(wps)).astype(np.int64)
    exp_local = (word - exp_owner.astype(np.uint64) * np.uint64(wps)).astype(
        np.int64)
    hi = (addr >> np.uint64(32)).astype(np.uint32)
    lo = (addr & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    owner, local, bit = tsharded.shard_owner_local(
        torch.from_numpy(hi), torch.from_numpy(lo), n=n, wps=wps, wide=True)
    np.testing.assert_array_equal(owner.numpy(), exp_owner)
    np.testing.assert_array_equal(local.numpy(), exp_local)
    np.testing.assert_array_equal(bit.numpy().astype(np.int64),
                                  (addr & np.uint64(31)).astype(np.int64))
    want = jsharded.shard_owner_local(jnp.asarray(hi), jnp.asarray(lo), n=n,
                                      wps=wps, wide=True)
    for g, w in zip((owner, local, bit), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_shard_owner_local_matches_shark_tpu(wide):
    """Any u32 limbs, addresses past the filter and int32 wrap included:
    the port's int64 twin gives shark_tpu's int32/u32 values."""
    rng = np.random.default_rng(12 + wide)
    hi = rng.integers(0, 1 << 32, size=8192, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, size=8192, dtype=np.uint64).astype(np.uint32)
    hi[:4096] &= 15  # half inside a 2^36-bit filter
    for n, wps in ((8, 64), (8, (1 << 31) - 1), (3, 5 << 26)):
        want = jsharded.shard_owner_local(jnp.asarray(hi), jnp.asarray(lo), n=n,
                                          wps=wps, wide=wide)
        got = tsharded.shard_owner_local(torch.from_numpy(hi),
                                         torch.from_numpy(lo), n=n, wps=wps,
                                         wide=wide)
        for name, g, w in zip(("owner", "local", "bit"), got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{name} n={n} wps={wps}")


@pytest.mark.parametrize("wire", ["bytes", "packed"])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("n", [1, 8])
def test_sharded_matches_shark_tpu(workload, jax_results, n, wide, wire):  # noqa: F811
    index, codes = workload
    clf = tsharded.ShardedBFClassifier(_port(index), max_winners=8, c=0.6,
                                       devices=["cpu"] * n, force_wide=wide)
    assert clf.wide == wide and clf.n == n
    got = clf(codes) if wire == "bytes" else clf.call_packed(*_planar(codes))
    want = jax_results[n, wide]
    assert int(want[4].sum()) == 0
    _assert_equal(got, want)
    assert (want[0] != 0).any()


def test_shards_on_several_devices_match_shark_tpu(workload, jax_results):  # noqa: F811
    """Eight shards on two devices, interleaved ("cpu" and "cpu:0" are two
    devices to torch): the exchange takes the copy path between devices,
    and the shards of a device are not contiguous."""
    index, codes = workload
    clf = tsharded.ShardedBFClassifier(_port(index), max_winners=8, c=0.6,
                                       devices=["cpu", "cpu:0"] * 4)
    assert len(clf._groups) == 2
    _assert_equal(clf(codes), jax_results[8, False])


def _fuzz_case(seed):
    """test_sharded_bf.py's fuzz generator, seed for seed."""
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    rng = np.random.default_rng(500 + seed)
    k = int(rng.choice([11, 13, 17]))
    size_bits = 1 << int(rng.integers(13, 17))
    n_genes = int(rng.integers(4, 40))
    records = []
    for g in range(n_genes):
        seq = bases[rng.integers(0, 4, size=int(rng.integers(k + 10, 400)))]
        records.append((f"G{g}", seq.tobytes()))
    index = build_index(records, k, size_bits)
    L = int(rng.choice([64, 96, 128]))
    B = 8 * int(rng.integers(4, 24))
    codes = np.full((B, L), 4, dtype=np.uint8)
    for i in range(B):
        _, seq = records[rng.integers(0, n_genes)]
        rl = min(len(seq), int(rng.integers(k, L)))
        start = int(rng.integers(0, len(seq) - rl + 1))
        arr = np.frombuffer(seq[start:start + rl], np.uint8).copy()
        mut = rng.random(arr.size) < 0.05
        arr[mut] = rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                              size=int(mut.sum()))
        codes[i, :arr.size] = encode_bytes(arr.tobytes())
    wide = bool(rng.integers(0, 2))
    return index, codes, wide


@pytest.mark.parametrize("seed", range(2))
def test_sharded_fuzz_matches_shark_tpu(seed):
    """The non-slow seeds of test_sharded_fuzz_matches_single: random gene
    counts and filter sizes (collision-heavy), reads with Ns, the router
    the seed draws, both wires on the port's side."""
    index, codes, wide = _fuzz_case(seed)
    want = [np.asarray(x) for x in jsharded.ShardedBFClassifier(
        index, max_winners=8, c=0.6, n_devices=8, force_wide=wide)(codes)]
    clf = tsharded.ShardedBFClassifier(_port(index), max_winners=8, c=0.6,
                                       devices=["cpu"] * 8, force_wide=wide)
    _assert_equal(clf(codes), want, f"wide={wide}")
    _assert_equal(clf.call_packed(*_planar(codes)), want, f"wide={wide}")


def test_probe_cap_and_growth_match_shark_tpu(workload):  # noqa: F811
    index, _ = workload
    for slack in (None, 2.0, 0.05):
        j = jsharded.ShardedBFClassifier(index, n_devices=8, slack=slack)
        t = tsharded.ShardedBFClassifier(_port(index), devices=["cpu"] * 8,
                                         slack=slack)
        for _ in range(12):
            for b, L in ((32, 128), (1, 8), (1024, 104), (8192, 208)):
                assert t._probe_cap(b, L) == j._probe_cap(b, L), (slack, b, L)
            j.grow_cap()
            t.grow_cap()
        assert t.cap_mult == j.cap_mult


def test_overflowing_call_matches_shark_tpu(workload, jax_results):  # noqa: F811
    """slack = 0.05: every source overflows, but each owner keeps its
    first `cap` probes by window position; which ones are kept decides
    the verdicts, so equal outputs pin shark_tpu's slot order."""
    index, codes = workload
    clf = tsharded.ShardedBFClassifier(_port(index), max_winners=8, c=0.6,
                                       devices=["cpu"] * 8, slack=0.05)
    got = clf(codes)
    want = jax_results["slack"]
    assert (want[4] > 0).all()
    _assert_equal(got, want)
    # some probes of every owner were delivered: the verdicts differ from
    # the complete ones, and are not all misses
    assert (want[2] != jax_results[8, False][2]).any()
    assert (want[2] > 0).any()


def test_reprobe_recovers_and_the_cap_sticks(workload, jax_results):  # noqa: F811
    index, codes = workload
    clf = tsharded.ShardedBFClassifier(_port(index), max_winners=8, c=0.6,
                                       devices=["cpu"] * 8, slack=0.05)
    assert int(clf(codes)[4].sum()) > 0
    got = clf.reprobe(codes)
    _assert_equal(got, jax_results[8, False])
    grown = clf.cap_mult
    assert grown > 1
    assert int(clf(codes)[4].sum()) == 0  # no retry needed any more
    assert int(clf.reprobe(_planar(codes))[4].sum()) == 0
    assert clf.cap_mult == grown  # a batch that fits does not grow it
    clf.cap_mult = grown / 2  # the growth stopped at the first cap that fits
    assert int(clf(codes)[4].sum()) > 0


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_pipeline_retries_sharded_overflow(workload, tmp_path, native):  # noqa: F811
    """run_pipeline drains batches whose routing overflowed through the
    reprobe hook (on the native engine's drain thread, or inline on the
    Python path) and writes the single-device bytes."""
    from shark_tpu_torch.io import native as native_mod

    if native and not native_mod.available():
        pytest.skip("native engine unavailable")
    index, codes = workload
    rng = np.random.default_rng(3)
    fasta = tmp_path / "genes.fa"
    fasta.write_bytes(b"".join(b">" + n.encode() + b"\n" + s + b"\n"
                               for n, s in _records_of()))
    fastq = tmp_path / "reads.fq"
    with open(fastq, "wb") as f:
        for i in range(200):
            seq = _decode(codes[rng.integers(0, codes.shape[0])])
            f.write(b"@r%03d\n" % i + seq + b"\n+\n" + b"I" * len(seq) + b"\n")

    def cfg(tag):
        return SharkConfig(
            fasta_path=str(fasta), sample1_path=str(fastq),
            out1_path=str(tmp_path / f"{tag}.fq"),
            ssv_path=str(tmp_path / f"{tag}.ssv"), batch_size=64, k=K,
            use_native=native, max_read_len=128 if native else 0,
            backend="cpu")

    tindex = _port(index)
    clf = tsharded.ShardedBFClassifier(tindex, devices=["cpu"] * 8,
                                       slack=0.05)
    stats = run_pipeline(cfg("sharded"), classifier=clf)
    assert stats["n_reads"] == 200 and stats["probe"] == "sharded"
    assert stats.get("native", False) == native
    assert clf.cap_mult > 1.0  # the retry path fired
    run_pipeline(cfg("single"), classifier=Classifier(tindex, device="cpu"))
    for ext in (".ssv", ".fq"):
        assert (tmp_path / f"sharded{ext}").read_bytes() == (
            tmp_path / f"single{ext}").read_bytes(), ext
    assert (tmp_path / "single.ssv").read_bytes()


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_cli_sharded_matches_shark_tpu(tmp_path, monkeypatch, paired):
    """`--backend cpu --sharded-bf` through both packages' CLI entry
    points writes the same ssv and FASTQ bytes (one shard each: the CLI's
    --devices 1 on the CPU). The -b unit is shrunk to 2^20 bits."""
    from shark_tpu import cli as jcli
    from shark_tpu import config as jconfig
    from shark_tpu_torch import cli as tcli
    from shark_tpu_torch import config as tconfig

    monkeypatch.setattr(jconfig, "BF_UNIT_BITS", 1 << 20)
    monkeypatch.setattr(tconfig, "BF_UNIT_BITS", 1 << 20)
    fa, fq = _family_fastx(tmp_path, np.random.default_rng(51 + paired),
                           paired)
    outs = {}
    for tag, cli in (("jax", jcli), ("torch", tcli)):
        argv = ["-r", fa, "-1", fq[0], "-o", str(tmp_path / f"{tag}.1.fq"),
                "--ssv", str(tmp_path / f"{tag}.ssv"), "-k", "15", "-c",
                "0.5", "-b", "1", "--sharded-bf", "--backend", "cpu",
                "--batch-size", "64", "--compile-cache", "",
                "--stats-json", str(tmp_path / f"{tag}.json")]
        if paired:
            argv += ["-2", fq[1], "-p", str(tmp_path / f"{tag}.2.fq")]
        assert cli.main(argv) == 0
        stats = json.loads((tmp_path / f"{tag}.json").read_text())
        assert stats["probe"] == "sharded"
        outs[tag] = _outputs(tmp_path, tag, paired)
    assert outs["jax"][0], "workload emitted no association"
    for name, a, b in zip(("ssv", "fq1", "fq2"), outs["jax"], outs["torch"]):
        assert a == b, f"{name} differs from shark_tpu"
