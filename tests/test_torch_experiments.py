"""P1 and P2, the port's counterparts of the repository's two Pallas
experiments, against the Pallas kernels themselves.

bench/pallas_probe.py (the per-probe tile gather) and
bench/pallas_vmem_match.py (the bucket match against a resident table)
are loaded from their files and run as their own CPU modes run them:
the match kernel with its INTERPRET switch set, the gather with
pallas_call in interpret mode; neither file changes. The port's plain
versions must equal them and the jnp references (jnp.take, xla_match),
its input makers must give the harnesses' arrays, and its entry points
must run with --cpu and raise without a card. Integer outputs: every
comparison is exact."""

import functools
import importlib.util
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from shark_tpu_torch.experiments import gather_tiles as G  # noqa: E402
from shark_tpu_torch.experiments import resident_match as R  # noqa: E402

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bench")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_bench_{name}", os.path.join(BENCH, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jp1():
    return _load("pallas_probe")


@pytest.fixture(scope="module")
def jp2():
    return _load("pallas_vmem_match")


@pytest.fixture
def interpret(monkeypatch, jp1, jp2):
    """Both Pallas kernels in interpret mode, for this test only."""
    monkeypatch.setattr(jp1.pl, "pallas_call",
                        functools.partial(jp1.pl.pallas_call, interpret=True))
    monkeypatch.setattr(jp2, "INTERPRET", True)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# P1: the tile gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_log2", [10, 11])
def test_gather_tiles_plain_matches_pallas(interpret, jp1, n_log2):
    table, tiles, idx = G.make_inputs(n_log2, 12, seed=n_log2)
    want = np.asarray(jp1.pallas_gather_tiles(jnp.asarray(tiles),
                                              jnp.asarray(idx)))
    rows = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))
    t_tiles, t_idx = _t(tiles, idx)
    got = G.gather_tiles_plain(t_tiles, t_idx)
    assert got.dtype == torch.uint32 and got.shape == (1 << n_log2, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(G.gather_tiles(t_tiles, t_idx).numpy(),
                                  want)
    np.testing.assert_array_equal(G.rows_of_tiles(got, t_idx).numpy(), rows)


# ---------------------------------------------------------------------------
# P2: the resident-table bucket match
# ---------------------------------------------------------------------------


def _entry(tag, key, pay):
    return np.uint32((int(tag) << 30) | (int(key) << 16) | int(pay))


def _plant(table, bucket, rest, valid, seed):
    """Hand-planted probes on the first 16 indices: every slot matching
    (pays near 2^16, so p1 << 16 wraps), 3-8 matching slots, tag-0 slots
    with the probe's key, an invalid probe on a full bucket, and a key
    that misses."""
    rng = np.random.default_rng(seed)
    n_buckets = table.shape[0]
    picks = rng.choice(n_buckets, size=16, replace=False)
    key = rng.integers(0, 1 << 14, size=16).astype(np.uint32)
    for j in range(16):
        bucket[j], rest[j], valid[j] = picks[j], key[j], True
    # 0: all 8 slots match, pays 0xFFF0.. (the sum passes 16 bits)
    for s in range(8):
        table[picks[0], s] = _entry(1 + s % 3, key[0], 0xFFF0 + s)
    # 1-6: 3..8 matching slots at random places, the rest other keys
    for j, m in zip(range(1, 7), range(3, 9)):
        slots = rng.choice(8, size=m, replace=False)
        for s in range(8):
            k = key[j] if s in slots else (key[j] + 1 + s) % (1 << 14)
            table[picks[j], s] = _entry(rng.integers(1, 4), k,
                                        rng.integers(0, 1 << 16))
    # 7: tag-0 slots carry the key (no match), then 3 real matches
    for s in range(8):
        table[picks[7], s] = _entry(0 if s < 5 else 2, key[7], 100 + s)
    # 8: only tag-0 slots with the key: no match at all
    for s in range(8):
        table[picks[8], s] = _entry(0, key[8], 7)
    # 9: an invalid probe on bucket 0's full match
    bucket[9], rest[9], valid[9] = picks[0], key[0], False
    # 10: bucket 0 with another key: no match
    bucket[10], rest[10] = picks[0], (key[0] + 1) % (1 << 14)


def _match_inputs(n, lgB, seed):
    table, bucket, rest, valid = R.build_inputs(n, lgB, seed)
    _plant(table, bucket, rest, valid, seed)
    return table, bucket, rest, valid


@pytest.mark.parametrize("lgB", [12, 14])
def test_resident_match_plain_matches_pallas(interpret, jp2, lgB):
    n = 4096
    host = _match_inputs(n, lgB, seed=lgB)
    rows, want, table128 = R.probe_inputs(*host)
    pal = jp2.make_pallas_match(table128.shape[0], n)
    ref = np.asarray(pal(jnp.asarray(rows),
                         jnp.asarray(want.reshape(-1, 8, 1)),
                         jnp.asarray(table128)))
    xla = np.asarray(jax.jit(jp2.xla_match)(*map(jnp.asarray, host)))
    np.testing.assert_array_equal(ref, xla)
    got = R.resident_match_plain(*_t(rows, want, table128))
    assert got.dtype == torch.uint32 and got.shape == (n, 2)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        R.resident_match(*_t(rows, want, table128)).numpy(), ref)
    # the planted probes reach every case
    assert ref[0, 0] == 3 and ref[0, 1] & 0xFFFF == 0xFFF0
    assert ref[0, 1] >> 16 == sum(range(0xFFF1, 0xFFF8)) & 0xFFFF
    assert (ref[1:8, 0] != 0).all() and (ref[8:11] == 0).all()
    assert ref[7, 1] & 0xFFFF == 105 and ref[7, 1] >> 16 == 106 + 107


@pytest.mark.parametrize("lgB", [10, 19])
def test_match_gather_equals_resident_match_plain(lgB):
    n = R.CHUNK * 4
    host = _match_inputs(n, lgB, seed=lgB + 1)
    got = R.match_gather(*_t(*host))
    np.testing.assert_array_equal(
        got.numpy(), R.resident_match_plain(*_t(*R.probe_inputs(*host))))
    assert 0.3 < (got[:, 0].numpy() != 0).mean() < 0.7


# ---------------------------------------------------------------------------
# the harnesses' inputs and the entry points
# ---------------------------------------------------------------------------


def _captured_device_puts(monkeypatch, run):
    seen = []
    put = jax.device_put

    def record(x, *args, **kwargs):
        seen.append(np.asarray(x))
        return put(x, *args, **kwargs)

    monkeypatch.setattr(jax, "device_put", record)
    run()
    return seen


@pytest.mark.parametrize("which", ["gather_tiles", "resident_match"])
def test_inputs_match_the_jax_harness(interpret, jp1, jp2, monkeypatch,
                                      which):
    """The arrays each JAX harness's main() puts on its device (run at a
    small size in interpret mode, its own check included) equal the port's
    make_inputs / build_inputs + probe_inputs."""
    if which == "gather_tiles":
        monkeypatch.setattr("sys.argv", ["pallas_probe.py", "10", "12"])
        seen = _captured_device_puts(monkeypatch, jp1.main)
        mine = G.make_inputs(10, 12)
    else:
        seen = _captured_device_puts(monkeypatch, jp2.main)
        host = R.build_inputs(R.N_CPU, R.LGB)
        rows, want, table128 = R.probe_inputs(*host)
        mine = (*host, rows, want.reshape(-1, 8, 1), table128)
        for seed in (0, 7):
            for a, b in zip(R.build_inputs(4096, 12, seed),
                            jp2.build_inputs(4096, 12, seed)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    assert len(seen) >= len(mine)
    for a, b in zip(mine, seen):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


ENTRY_POINTS = {
    "gather_tiles": (G.main, ["11", "12"],
                     "gather_tiles matches table[idx] on 2048 probes (cpu)"),
    "resident_match": (R.main, [],
                       f"resident match == gather+match on {R.N_CPU} probes"),
}


@pytest.mark.parametrize("which", list(ENTRY_POINTS))
def test_entry_point_runs_on_the_cpu(capsys, which):
    main, argv, line = ENTRY_POINTS[which]
    assert main(["--cpu", *argv]) == 0
    assert line in capsys.readouterr().out


@pytest.mark.parametrize("which", list(ENTRY_POINTS))
def test_entry_point_without_cuda_raises(monkeypatch, which):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv, _ = ENTRY_POINTS[which]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)


@pytest.mark.parametrize("case", ["gather_n", "gather_width", "match_n",
                                  "match_lengths", "match_width"])
def test_wrappers_refuse_bad_shapes(case):
    u32 = torch.uint32
    tiles = torch.zeros((64, 128), dtype=u32)
    idx = torch.zeros(G.CHUNK, dtype=torch.int32)
    rows = torch.zeros(R.CHUNK, dtype=torch.int32)
    want = torch.zeros(R.CHUNK, dtype=u32)
    t128 = torch.zeros((16, 128), dtype=u32)
    call = {
        "gather_n": lambda: G.gather_tiles(tiles, idx[:-8]),
        "gather_width": lambda: G.gather_tiles(tiles.view(-1, 64), idx),
        "match_n": lambda: R.resident_match(rows[:-8], want[:-8], t128),
        "match_lengths": lambda: R.resident_match(rows, want[:-8], t128),
        "match_width": lambda: R.resident_match(rows, want, t128.view(-1, 8)),
    }[case]
    with pytest.raises(ValueError):
        call()
