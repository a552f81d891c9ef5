"""The round-closing differential fuzz of shark_tpu_torch, and its gate.

The port's counterpart of tests/test_e2e_fuzz.py. One random workload per
seed (paired or single-end, k in {11, 15, 17}, quality masking, Ns,
lowercase, reads shorter than k, CRLF and multi-line FASTA, gzip), drawn
from np.random.default_rng(1000 + seed) in test_e2e_fuzz's order, so a
seed means the same workload and the same forced probe layout in both
packages. run_seed drives it through every entry point of the port and
holds every output to the oracle's ssv and to each other's FASTQs:

- the device path through the native engine and through the Python I/O,
  both on one classifier of the seed's layout (auto, classic or xl);
- --backend native (the C++ host classify) and --backend cpu;
- one extra path, drawn after the reference's draws: none, the Bloom
  filter in 8 shards on the device with a routing cap small enough that
  reprobe can fire, or the index replicated over [device, device];
- a paired seed's device path and --backend cpu at PAIRED_C (no pair
  reaches the reference's c = 0.6: mate 2 is random sequence);
- the ties pass: the device path and --backend cpu against a FASTA with
  every gene written two or three times, so that reads tie (the
  winner-pair stream, K4, and the finish's GROUP verdicts), which the
  reference's random genes almost never do.

On a CUDA device each run's kernel launches are read from
kernels.LAUNCHES: the front end, the layout's probe kernels and the finish
must have run, no other layout's probe, and none at all on the host
modes. scripts/fuzz_soak_torch.py and chip_smoke.py's phase (m) load this
file by path and call run_seed, so the soak certifies exactly what this
gate does. Nothing here imports jax or shark_tpu at module level (the card
machine has neither); the cases that compare with shark_tpu import it
inside the test.
"""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np
import pytest
import torch

from shark_tpu_torch import kernels
from shark_tpu_torch.classify.oracle import build_oracle_index, classify_read
from shark_tpu_torch.classify.step import Classifier
from shark_tpu_torch.config import SharkConfig
from shark_tpu_torch.io import native
from shark_tpu_torch.ops.kmers import encode_bytes
from shark_tpu_torch.parallel.data_parallel import DataParallelClassifier
from shark_tpu_torch.parallel.sharded_bf import ShardedBFClassifier
from shark_tpu_torch.pipeline import load_or_build_index, run_pipeline
from shark_tpu_torch.utils.timers import PhaseTimer

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

PROBES = ("auto", "classic", "xl")
EXTRAS = ("", "sharded", "replicated")
SHARDS = 8
SLACK = 0.05  # the sharded path's routing cap: small, so reprobe can fire
C = 0.6  # the reference's default threshold, every mode's
# Mate 2 of a paired workload is random sequence, so a fused pair covers at
# most about half its valid bases and no pair reaches C: a paired seed
# also runs the device path and --backend cpu at PAIRED_C, where its pairs
# emit.
PAIRED_C = 0.3

# the probe kernels of each layout; a run launches the front end, its
# layout's kernels and the finish, and no other layout's probe
LAYOUT_KERNELS = {
    "hashed": ("probe",),
    "xl": ("probe_xl",),
    "classic": ("classic",),
    "sharded": ("shard_route", "shard_probe", "shard_return"),
}
PROBE_KERNELS = {n for ks in LAYOUT_KERNELS.values() for n in ks}


def _random_workload(rng, tmp_path, seed):
    """tests/test_e2e_fuzz.py's generator, draw for draw."""
    k = int(rng.choice([11, 15, 17]))
    n_genes = int(rng.integers(2, 12))
    paired = bool(rng.integers(0, 2))
    minq = int(rng.choice([0, 10]))
    genes = []
    fa_lines = []
    for g in range(n_genes):
        glen = int(rng.integers(k, 400))
        seq = BASES[rng.integers(0, 4, size=glen)].tobytes()
        genes.append((f"g{g}", seq))
        # multi-line records with occasional CRLF
        eol = b"\r\n" if rng.random() < 0.3 else b"\n"
        fa_lines.append(b">g%d%s" % (g, eol))
        for i in range(0, len(seq), 60):
            fa_lines.append(seq[i : i + 60] + eol)
    fa = tmp_path / f"f{seed}.fa"
    fa.write_bytes(b"".join(fa_lines))

    n_reads = int(rng.integers(20, 120))
    reads1, reads2, quals1, quals2 = [], [], [], []
    for i in range(n_reads):
        src, sseq = genes[int(rng.integers(0, n_genes))]
        rlen = int(rng.integers(5, 90))
        if len(sseq) > rlen and rng.random() < 0.8:
            start = int(rng.integers(0, len(sseq) - rlen))
            r = bytearray(sseq[start : start + rlen])
        else:
            r = bytearray(BASES[rng.integers(0, 4, size=rlen)].tobytes())
        # sprinkle Ns and lowercase
        for _ in range(int(rng.integers(0, 3))):
            r[int(rng.integers(0, len(r)))] = ord("N")
        if rng.random() < 0.2:
            r = bytearray(bytes(r).lower())
        q = bytes(
            int(rng.integers(33 + 2, 33 + 40)) for _ in range(len(r))
        )
        reads1.append(bytes(r))
        quals1.append(q)
        if paired:
            r2 = BASES[rng.integers(0, 4, size=rlen)].tobytes()
            reads2.append(r2)
            quals2.append(
                bytes(int(rng.integers(33 + 2, 33 + 40)) for _ in range(rlen))
            )

    def write_fq(path, rs, qs, gz):
        data = b"".join(
            b"@r%04d\n%s\n+\n%s\n" % (i, r, q)
            for i, (r, q) in enumerate(zip(rs, qs))
        )
        if gz:
            with gzip.open(path, "wb") as f:
                f.write(data)
        else:
            path.write_bytes(data)

    gz = bool(rng.integers(0, 2))
    sfx = ".gz" if gz else ""
    fq1 = tmp_path / f"s{seed}_1.fq{sfx}"
    write_fq(fq1, reads1, quals1, gz)
    fq2 = None
    if paired:
        fq2 = tmp_path / f"s{seed}_2.fq{sfx}"
        write_fq(fq2, reads2, quals2, gz)
    return {
        "k": k,
        "minq": minq,
        "paired": paired,
        "gz": gz,
        "genes": genes,
        "fa": fa,
        "fq1": fq1,
        "fq2": fq2,
        "reads1": reads1,
        "reads2": reads2,
        "quals1": quals1,
        "quals2": quals2,
    }


def _oracle_ssv(w, c=C):
    """The expected ssv lines at threshold c, from the port's pure-host
    oracle, with the reference's quality mask (FastqSplitter.hpp:106: a
    base under the cut has 64 taken off its byte, which no base code
    survives)."""
    size_bits = 1 << 33
    oracle = build_oracle_index(w["genes"], w["k"], size_bits)
    lines = []
    for i, r1 in enumerate(w["reads1"]):
        seq = bytearray(r1)
        qual = bytearray(w["quals1"][i])
        if w["paired"]:
            seq += b"N" + w["reads2"][i]
            qual += b"\33" + w["quals2"][i]
        if w["minq"]:
            cut = w["minq"] + 33
            for j in range(min(len(seq), len(qual))):
                if qual[j] < cut:
                    seq[j] = (seq[j] - 64) % 256
        wins, _, _ = classify_read(
            oracle, encode_bytes(bytes(seq)), c, False
        )
        for g in wins:
            lines.append(f"r{i:04d} g{g}\n")
    return "".join(lines)


def draw_seed(tmp_path, seed: int):
    """The seed's workload and draws, in the reference's order: the
    workload, the forced probe layout, the host mode's -t; then the
    port's extra path. Returns (workload, probe, threads, extra)."""
    rng = np.random.default_rng(1000 + seed)
    w = _random_workload(rng, Path(tmp_path), seed)
    probe = str(rng.choice(list(PROBES)))
    threads = int(rng.integers(1, 4))
    extra = EXTRAS[int(rng.integers(0, len(EXTRAS)))]
    return w, probe, threads, extra


def _check_launches(tag: str, counts: dict, layout: str) -> None:
    need = ("front", *LAYOUT_KERNELS[layout], "finish")
    missing = [n for n in need if counts[n] == 0]
    other = [n for n in PROBE_KERNELS - set(LAYOUT_KERNELS[layout])
             if counts[n]]
    assert not missing and not other, (
        f"{tag}: the {layout} path launched {counts} (missing {missing}, "
        f"other layouts' {other})")


def _tied(w, tmp_path, seed):
    """The workload against a FASTA with each gene written twice (even
    ids) or three times (odd ids), named by their new ids: a read of a
    gene ties across its copies, two (the winner-pair stream, K4) or
    three (a group of the index, the finish's GROUP verdict)."""
    genes = [(f"g{j}", seq) for j, seq in enumerate(
        seq for i, (_, seq) in enumerate(w["genes"]) for _ in range(2 + i % 2)
    )]
    fa = tmp_path / f"t{seed}.fa"
    fa.write_bytes(b"".join(b">%s\n%s\n" % (n.encode(), q) for n, q in genes))
    return dict(w, genes=genes, fa=fa)


def run_seed(tmp_path, seed: int, device="cpu", extras=None) -> dict:
    """ONE fuzz seed's full differential through the port on `device`
    ("cpu" runs the plain PyTorch versions, "cuda:0" the kernels).
    `extras` overrides the drawn extra path (a tuple of EXTRAS entries).

    Runs, each against the oracle's ssv and the FASTQs of the first run
    of its group: at C, the device path through the native engine and
    the Python I/O, --backend cpu, --backend native and the extra paths;
    for a paired seed, the device path and --backend cpu at PAIRED_C;
    and the ties pass (_tied), the device path and --backend cpu at C
    (PAIRED_C for a paired seed). Raises AssertionError on any
    difference; returns what the seed ran: {"layout", "extras",
    "reprobe", "paired", "gz", "minq", "k", "n_reads", "associations"
    (ssv lines over the groups), "tie_pairs" (K4 launches of the ties
    pass on the card), "group_rows" (GROUP verdicts of the ties pass),
    "launches" (summed over the runs)}."""
    tmp_path = Path(tmp_path)
    device = torch.device(device)
    on_card = device.type == "cuda"
    w, probe, threads, extra = draw_seed(tmp_path, seed)
    if extras is None:
        extras = (extra,) if extra else ()
    layout = "hashed" if probe == "auto" else probe
    forced = None if probe == "auto" else probe
    tw = _tied(w, tmp_path, seed)
    tie_c = PAIRED_C if w["paired"] else C

    def cfg_of(wl, mode, **kw):
        return SharkConfig(
            fasta_path=str(wl["fa"]),
            sample1_path=str(w["fq1"]),
            sample2_path=str(w["fq2"]) if w["fq2"] else "",
            out1_path=str(tmp_path / f"{mode}{seed}.1.fq"),
            out2_path=str(tmp_path / f"{mode}{seed}.2.fq") if w["fq2"] else "",
            ssv_path=str(tmp_path / f"{mode}{seed}.ssv"),
            k=w["k"],
            min_quality=w["minq"],
            batch_size=32,  # several batches per run; even, for 2 replicas
            max_read_len=256,
            probe=probe,
            **kw,
        )

    # one index a FASTA for every mode but --backend native, which builds
    # its own; each classifier is built when its first run comes and
    # dropped after its last, so that few copies of the 1 GiB filter live
    index = load_or_build_index(cfg_of(w, "index"), PhaseTimer())
    launched = dict.fromkeys(kernels.KERNELS, 0)
    outs = {}  # group -> [(mode, ssv, fq1, fq2)]
    seen = {}

    def run(group, wl, mode, clf, path, **kw):
        """One run; `path` names the layout whose kernels the card must
        launch (None: a host run, which launches none)."""
        kernels.LAUNCHES.reset()
        stats = run_pipeline(cfg_of(wl, mode, **kw), classifier=clf)
        counts = kernels.LAUNCHES.snapshot()
        for name, n in counts.items():
            launched[name] += n
        assert stats.get("native", False) == (mode != "python"), mode
        if clf is None:
            assert stats["probe"] == "host"
        else:
            assert stats["probe"] == (path or layout), (mode, stats["probe"])
        if on_card and path is not None:
            _check_launches(f"seed {seed} {mode}", counts, path)
        else:
            assert not any(counts.values()), f"{mode} launched {counts}"
        outs.setdefault(group, []).append((mode, *(
            (tmp_path / f"{mode}{seed}.{x}").read_bytes()
            if x != "2.fq" or w["fq2"] else b""
            for x in ("ssv", "1.fq", "2.fq"))))
        seen[mode] = (stats, counts)

    def one_card(ix, c=C):
        clf = Classifier(ix, c=c, device=device, probe=forced)
        assert clf.probe == layout, (probe, clf.probe)
        return clf

    def host_cpu(ix, c=C):
        return Classifier(ix, c=c, device="cpu", probe=forced)

    clf = one_card(index)
    run(C, w, "native", clf, layout, use_native=True)
    run(C, w, "python", clf, layout, use_native=False)
    if on_card:
        clf = None
        clf = host_cpu(index)
    run(C, w, "cpu", clf, None, backend="cpu")
    clf = None
    run(C, w, "host", None, None, backend="native", threads=threads)
    reprobe = False
    for name in extras:
        if name == "sharded":
            clf = ShardedBFClassifier(index, c=C, devices=[device] * SHARDS,
                                      slack=SLACK)
            run(C, w, "sharded", clf, "sharded", sharded_bf=True)
            reprobe = clf.cap_mult > 1.0
        elif name == "replicated":
            clf = DataParallelClassifier(index, c=C, devices=[device, device],
                                         probe=forced)
            run(C, w, "replicated", clf, layout, devices=2)
        else:
            raise ValueError(f"unknown extra path {name!r}")
        clf = None
    if w["paired"]:
        clf = one_card(index, PAIRED_C)
        run(PAIRED_C, w, "native_low_c", clf, layout, c=PAIRED_C)
        clf = host_cpu(index, PAIRED_C) if on_card else clf
        run(PAIRED_C, w, "cpu_low_c", clf, None, backend="cpu", c=PAIRED_C)
        clf = None
    index = load_or_build_index(cfg_of(tw, "tindex"), PhaseTimer())
    clf = one_card(index, tie_c)
    run("ties", tw, "native_ties", clf, layout, c=tie_c)
    clf = host_cpu(index, tie_c) if on_card else clf
    run("ties", tw, "cpu_ties", clf, None, backend="cpu", c=tie_c)
    del clf, index

    wants = {C: _oracle_ssv(w), "ties": _oracle_ssv(tw, tie_c)}
    if w["paired"]:
        wants[PAIRED_C] = _oracle_ssv(w, PAIRED_C)
    for group, runs in outs.items():
        want = wants[group].encode()
        first = runs[0]
        for mode, ssv, fq1, fq2 in runs:
            assert ssv == want, (
                f"seed {seed}: {mode} ssv differs from the oracle's")
            assert fq1 == first[2], f"seed {seed}: {mode} FASTQ 1"
            assert fq2 == first[3], f"seed {seed}: {mode} FASTQ 2"
    return {
        "layout": layout,
        "extras": tuple(extras),
        "reprobe": reprobe,
        "paired": w["paired"],
        "gz": w["gz"],
        "minq": w["minq"],
        "k": w["k"],
        "n_reads": len(w["reads1"]),
        "associations": sum(v.count("\n") for v in wants.values()),
        "tie_pairs": seen["native_ties"][1]["pairs"],
        "group_rows": seen["native_ties"][0].get("group_rows", 0),
        "launches": launched,
    }


# ---------------------------------------------------------------------------
# the gate on the CPU
# ---------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("seed", range(20))
def test_workload_matches_shark_tpu(tmp_path, seed):
    """The port's generator writes test_e2e_fuzz's FASTA and FASTQ bytes
    (gzip's decompressed), and the probe and -t draws that follow are the
    reference's."""
    pytest.importorskip("jax")
    from test_e2e_fuzz import _random_workload as ref_workload

    rng = np.random.default_rng(1000 + seed)
    (tmp_path / "ref").mkdir()
    ref = ref_workload(rng, tmp_path / "ref", seed)
    ref_probe = str(rng.choice(["auto", "classic", "xl"]))
    ref_threads = int(rng.integers(1, 4))
    (tmp_path / "port").mkdir()
    w, probe, threads, extra = draw_seed(tmp_path / "port", seed)
    assert (probe, threads) == (ref_probe, ref_threads)
    assert extra in EXTRAS
    def content(path):  # a gzip header holds the time it was written
        return (gzip.decompress(path.read_bytes()) if path.suffix == ".gz"
                else path.read_bytes())

    for key in ("fa", "fq1", "fq2"):
        if ref[key] is None:
            assert w[key] is None
            continue
        assert w[key].name == ref[key].name
        assert content(w[key]) == content(ref[key]), key
    for key, val in ref.items():
        if key not in ("fa", "fq1", "fq2"):
            assert w[key] == val, key


# paired (minq 0), single with minq 10, single with minq 0 at k = 11
@pytest.mark.parametrize("seed", [1, 11, 13])
def test_oracle_ssv_matches_shark_tpu(tmp_path, monkeypatch, seed):
    """The port's oracle ssv is the reference's; a paired seed, which
    emits nothing at C, is also compared at PAIRED_C (the reference's
    classify_read given PAIRED_C in place of its fixed 0.6)."""
    pytest.importorskip("jax")
    import test_e2e_fuzz

    w = draw_seed(tmp_path, seed)[0]
    want = test_e2e_fuzz._oracle_ssv(w)
    assert _oracle_ssv(w) == want
    if w["paired"]:
        assert not want
        ref = test_e2e_fuzz.classify_read
        monkeypatch.setattr(test_e2e_fuzz, "classify_read",
                            lambda o, codes, c, single: ref(o, codes, PAIRED_C,
                                                            single))
        want = test_e2e_fuzz._oracle_ssv(w)
        assert _oracle_ssv(w, PAIRED_C) == want
    assert want, "the workload emits no association"


# seed 5: paired, gzip, minq 10, forced xl; seed 7: paired, minq 10,
# k = 11, forced classic. Both extra paths on torch CPU devices.
@pytest.mark.parametrize("seed", [5, 7])
def test_run_seed_on_cpu(tmp_path, seed):
    if not native.available():
        pytest.skip("native engine unavailable")
    got = run_seed(tmp_path, seed, "cpu", extras=("sharded", "replicated"))
    want = {5: dict(layout="xl", paired=True, gz=True, minq=10,
                    reprobe=True),
            7: dict(layout="classic", paired=True, minq=10, k=11)}[seed]
    assert {k: got[k] for k in want} == want
    assert got["extras"] == ("sharded", "replicated")
    assert not any(got["launches"].values())


def _load_soak():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "fuzz_soak_torch", ROOT / "scripts" / "fuzz_soak_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_soak_names_the_failing_seed(monkeypatch, capsys):
    """A planted difference (one extra line in the oracle's ssv) fails the
    seed: the soak exits 1 and names it."""
    if not native.available():
        pytest.skip("native engine unavailable")
    import sys

    soak = _load_soak()
    monkeypatch.setattr(native, "rebuild", lambda: 0.0)  # built already
    mod = sys.modules[__name__]
    real = mod._oracle_ssv
    monkeypatch.setattr(mod, "_oracle_ssv",
                        lambda w, c=C: real(w, c) + "r0000 g0\n")
    monkeypatch.setattr(soak, "_load_fuzz_mod", lambda: mod)
    # seed 6: 21 single-end reads, auto layout, no extra path
    assert soak.main(["1", "6", "--cpu"]) == 1
    out, err = capsys.readouterr()
    assert "[soak] seed 6 FAILED" in out
    assert "1 failures (seeds 6)" in out
    assert "seed 6: native ssv differs from the oracle's" in err


@pytest.mark.parametrize("missing", ["card", "native engine"])
def test_soak_refuses_without_card_or_engine(monkeypatch, capsys, missing):
    """Without a card the soak exits 2 unless --cpu is given, and it never
    soaks without the native engine; it runs no seed then."""
    soak = _load_soak()
    monkeypatch.setattr(soak, "_load_fuzz_mod", lambda: pytest.fail(
        "the soak went on to run seeds"))
    if missing == "card":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert soak.main(["1"]) == 2
        assert "no CUDA device" in capsys.readouterr().out
    else:
        monkeypatch.setattr(native, "rebuild", lambda: 0.0)
        monkeypatch.setattr(native, "available", lambda: False)
        assert soak.main(["1", "--cpu"]) == 2
        assert "native engine" in capsys.readouterr().out
