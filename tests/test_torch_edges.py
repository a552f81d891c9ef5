"""The edge pass of tests/test_torch_fuzz.py on the CPU, against shark_tpu.

run_edges draws the inputs that run_seed never draws: reads from 90 to
past 16384 bases (each band of pipeline._round_len's rules and K1's
long-read kernel), mate 2 taken from the gene of mate 1, --max-read-len
0 (the auto pre-scan), rounded, or not a multiple of 8 (the native engine
hands over u8 codes), -s, max_winners 1, 2 or 16 against a FASTA with
every gene written two or three times, and batches of 32 or 8192 reads.
EDGE_CPU_SEEDS are fixed seeds that together cover every band, both kinds
of --max-read-len, the unpacked engine path, a gene-derived pair that
emits, -s and rows recomputed by the host oracle; each runs through the
port's entry points (run_edges holds them to the oracle and to each
other) and its bytes are held to shark_tpu's run_pipeline on the same
config. The -b unit is shrunk to 2^20 bits in both packages, and torch
runs on one thread. The card runs the same body:
scripts/fuzz_soak_torch.py --edges and chip_smoke.py's phase (t).
"""

import dataclasses

import pytest
import torch

pytest.importorskip("jax")

from shark_tpu import config as jconfig  # noqa: E402
from shark_tpu.config import SharkConfig as JConfig  # noqa: E402
from shark_tpu.pipeline import run_pipeline as jrun_pipeline  # noqa: E402
from shark_tpu_torch import config as tconfig  # noqa: E402
from shark_tpu_torch.io import native  # noqa: E402
from test_torch_fuzz import edge_covers, run_edges  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

# seed: what it covers (edge_covers), all at B = 32
EDGE_CPU_SEEDS = {
    # an innie pair of 206 bases at L = 208; reads tied across two genes
    # overflow max_winners 1 and take the host recompute
    4: {"band0", "rounded", "W1", "B32", "classic", "pair_emits",
        "host_rows"},
    # -s; the auto pre-scan rounds the longest read (686) to 704
    0: {"band1", "auto", "W16", "B32", "xl", "single"},
    # --max-read-len 1126: the native engine hands over u8 codes, padded
    # to 1128 for the planar packing
    75: {"band2", "unpacked", "unpacked_engine", "W1", "B32", "classic",
         "single"},
    # a read of 16402 bases at --max-read-len 16402 (L = 16408): K1's
    # long-read path
    3709: {"band3", "unpacked", "unpacked_engine", "W1", "B32", "classic",
           "single"},
}
# edge seed of the soak's failure test: band 0, a fraction of a second
EDGE_SOAK_SEED, EDGE_SOAK_BAND = 4, 0
# what the seeds must cover together
CPU_COVERS = ("band0", "band1", "band2", "band3", "auto", "rounded",
              "unpacked", "unpacked_engine", "pair_emits", "single",
              "host_rows")


def test_edge_seeds_cover_every_edge():
    missing = set(CPU_COVERS) - set().union(*EDGE_CPU_SEEDS.values())
    assert not missing, f"no CPU edge seed covers {sorted(missing)}"
    bands = [s for s, c in EDGE_CPU_SEEDS.items() if "band3" in c]
    assert len(bands) == 1, "one CPU seed past 16384 bases, no more"


@pytest.mark.parametrize("seed", sorted(EDGE_CPU_SEEDS))
def test_edges_match_shark_tpu(tmp_path, monkeypatch, seed):
    """run_edges on the CPU (every output equal to the oracle's and to the
    other entry points'), then shark_tpu's run_pipeline on each group's
    config: the same ssv and FASTQ bytes."""
    if not native.available():
        pytest.skip("native engine unavailable")
    monkeypatch.setattr(jconfig, "BF_UNIT_BITS", 1 << 20)
    monkeypatch.setattr(tconfig, "BF_UNIT_BITS", 1 << 20)
    got = run_edges(tmp_path, seed, "cpu")
    assert edge_covers(got) == EDGE_CPU_SEEDS[seed]
    fields = {f.name for f in dataclasses.fields(JConfig)}
    for group, cfg in got["configs"].items():
        out = tmp_path / f"jax_{group}"
        kw = {k: v for k, v in cfg.items() if k in fields}
        kw.update(out1_path=f"{out}.1.fq", ssv_path=f"{out}.ssv",
                  out2_path=f"{out}.2.fq" if cfg["out2_path"] else "",
                  backend="cpu", compile_cache="")
        jrun_pipeline(JConfig(**kw))
        want = tuple(open(p, "rb").read() if p else b""
                     for p in (kw["ssv_path"], kw["out1_path"],
                               kw["out2_path"]))
        assert tuple(got["outputs"][group]) == want, (
            f"edge seed {seed}, group {group}: bytes differ from shark_tpu")


def test_edge_soak_names_the_failing_seed_and_band(monkeypatch, capsys):
    """A planted difference (one extra line in the oracle's ssv) fails an
    edge seed: scripts/fuzz_soak_torch.py --edges exits 1 and names the
    seed and its band."""
    if not native.available():
        pytest.skip("native engine unavailable")
    import sys

    import test_torch_fuzz
    from test_torch_fuzz import _load_soak

    soak = _load_soak()
    monkeypatch.setattr(native, "rebuild", lambda: 0.0)  # built already
    monkeypatch.setattr(tconfig, "BF_UNIT_BITS", 1 << 20)
    real = test_torch_fuzz._oracle_ssv
    monkeypatch.setattr(test_torch_fuzz, "_oracle_ssv",
                        lambda *a, **kw: real(*a, **kw) + "r0000 g0\n")
    monkeypatch.setattr(soak, "_load_fuzz_mod",
                        lambda: sys.modules["test_torch_fuzz"])
    seed = EDGE_SOAK_SEED
    assert soak.main(["--edges", "1", str(seed), "--cpu"]) == 1
    out, err = capsys.readouterr()
    band = EDGE_SOAK_BAND
    assert f"[soak] edge seed {seed} band {band} FAILED" in out
    assert f"1 failures (seeds {seed} (band {band}))" in out
    assert f"edge seed {seed}: native ssv differs from the oracle's" in err


def test_edge_soak_refuses_without_a_card(monkeypatch, capsys):
    """--edges without a card exits 2 and runs no seed."""
    from test_torch_fuzz import _load_soak

    soak = _load_soak()
    monkeypatch.setattr(soak, "_load_fuzz_mod", lambda: pytest.fail(
        "the soak went on to run seeds"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert soak.main(["--edges", "200", "20000"]) == 2
    assert "no CUDA device" in capsys.readouterr().out
