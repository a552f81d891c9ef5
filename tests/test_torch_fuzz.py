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

import dataclasses
import gzip
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from shark_tpu_torch import kernels, pipeline
from shark_tpu_torch.classify.oracle import build_oracle_index, classify_read
from shark_tpu_torch.classify.step import Classifier
from shark_tpu_torch.config import SharkConfig
from shark_tpu_torch.io import native
from shark_tpu_torch.ops.kmers import encode_bytes
from shark_tpu_torch.parallel.data_parallel import DataParallelClassifier
from shark_tpu_torch.parallel.sharded_bf import ShardedBFClassifier
from shark_tpu_torch.pipeline import load_or_build_index, run_pipeline
from shark_tpu_torch.utils.timers import PhaseTimer

try:  # pytest; the soak and chip_smoke.py load this file by path
    from test_torch_threads import one_torch_thread  # noqa: F401
except ImportError:
    pass

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


def _oracle_ssv(w, c=C, size_bits=1 << 33, single=False):
    """The expected ssv lines at threshold c, from the port's pure-host
    oracle, with the reference's quality mask (FastqSplitter.hpp:106: a
    base under the cut has 64 taken off its byte, which no base code
    survives); `single`: -s, one winner or none."""
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
            oracle, encode_bytes(bytes(seq)), c, single
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


def _outputs(prefix: Path, paired: bool):
    """The ssv and FASTQ bytes a run wrote under `prefix` (b"" for mate 2
    of a single-end run)."""
    return tuple(Path(f"{prefix}.{x}").read_bytes()
                 if x != "2.fq" or paired else b""
                 for x in ("ssv", "1.fq", "2.fq"))


def _hold_to_oracle(outs: dict, wants: dict, tag: str) -> None:
    """Every run's ssv equals its group's oracle ssv, and its FASTQs the
    group's first run's. `outs`: group -> [(mode, ssv, fq1, fq2)]."""
    for group, runs in outs.items():
        want = wants[group].encode()
        first = runs[0]
        for mode, ssv, fq1, fq2 in runs:
            assert ssv == want, f"{tag}: {mode} ssv differs from the oracle's"
            assert fq1 == first[2], f"{tag}: {mode} FASTQ 1"
            assert fq2 == first[3], f"{tag}: {mode} FASTQ 2"


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
        outs.setdefault(group, []).append(
            (mode, *_outputs(tmp_path / f"{mode}{seed}", w["paired"])))
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
    _hold_to_oracle(outs, wants, f"seed {seed}")
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
# the edge pass: the inputs run_seed never draws
# ---------------------------------------------------------------------------

# Bands of the longest fused read, by the length rule each reaches
# (pipeline._round_len): multiples of 8, multiples of 32, powers of two up
# to the staged front end's last length (16384), and K1's long-read kernel
# past it.
EDGE_BANDS = ((90, 256), (257, 1024), (1025, 16384), (16385, 20000))
# --max-read-len: 0 (the auto pre-scan), the rounded length, or a length
# that is not a multiple of 8 (the native engine hands over u8 codes)
EDGE_LENS = ("auto", "rounded", "unpacked")
EDGE_WINNERS = (1, 2, 16)
EDGE_BATCHES = (32, 8192)  # 8192: the CLI's default
# Past the second band a seed runs at B = 32: the host's plain-PyTorch
# run (--backend cpu) holds B x L windows of 64-bit hashes.
EDGE_BIG_BATCH_BANDS = 2
MATE_LENS = (90, 300)  # a paired seed's mates, so its pairs reach 601
MAX_GAP = 200  # bases between the mates of an innie pair
_COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _log_uniform(rng, lo: int, hi: int) -> int:
    return min(hi, max(lo, int(np.exp(rng.uniform(np.log(lo),
                                                  np.log(hi + 1))))))


def draw_edges(tmp_path, seed: int) -> dict:
    """The edge seed's workload and flags, from np.random.default_rng(5000
    + seed) (run_seed's draws stay as they are). The longest fused read
    falls in the band drawn (one or two reads past 16384 in the last band,
    the others shorter); a paired seed (first two bands only) takes mate
    2 from the same gene as mate 1: the reverse complement of a piece
    downstream of it, both mates 90-300 bases, so that its pairs reach C.
    Returns the workload dict of _random_workload plus "band", "longest",
    "lens" (EDGE_LENS), "max_read_len", "single", "max_winners",
    "batch_size", "probe", "threads"."""
    tmp_path = Path(tmp_path)
    rng = np.random.default_rng(5000 + seed)
    band = int(rng.integers(0, len(EDGE_BANDS)))
    lo, hi = EDGE_BANDS[band]
    k = int(rng.choice([11, 15, 17]))
    paired = bool(rng.integers(0, 2)) and 2 * MATE_LENS[1] + 1 >= lo
    minq = int(rng.choice([0, 10]))
    single = bool(rng.integers(0, 2))
    max_winners = int(rng.choice(EDGE_WINNERS))
    batch_size = int(rng.choice(EDGE_BATCHES))
    if band >= EDGE_BIG_BATCH_BANDS:
        batch_size = EDGE_BATCHES[0]
    lens = EDGE_LENS[int(rng.integers(0, len(EDGE_LENS)))]
    probe = str(rng.choice(list(PROBES)))
    threads = int(rng.integers(1, 4))
    n_reads = int(rng.integers(12, 41))

    # fused lengths: one read (one or two past 16384) in the band, the
    # rest shorter
    if paired:
        lo = max(lo, 2 * MATE_LENS[0] + 1)
        hi = min(hi, 2 * MATE_LENS[1] + 1)
    n_top = int(rng.integers(1, 3)) if band == len(EDGE_BANDS) - 1 else 1
    below = (2 * MATE_LENS[0] + 1) if paired else 90
    # log-uniform: each power of two of the band about as likely
    fused = [_log_uniform(rng, lo, hi) for _ in range(n_top)]
    top = (fused[0] if band < len(EDGE_BANDS) - 1
           else EDGE_BANDS[band - 1][1])
    fused += [_log_uniform(rng, below, top) for _ in range(n_reads - n_top)]
    order = rng.permutation(n_reads)
    fused = [fused[i] for i in order]
    mates = []
    for f in fused:
        if paired:
            l2 = int(rng.integers(max(MATE_LENS[0], f - 1 - MATE_LENS[1]),
                                  min(MATE_LENS[1], f - 1 - MATE_LENS[0])
                                  + 1))
            mates.append((f - 1 - l2, l2, int(rng.integers(0, MAX_GAP + 1))))
        else:
            mates.append((f, 0, 0))
    need = max(a + g + b for a, b, g in mates)

    n_genes = int(rng.integers(2, 7))
    genes = []
    for g in range(n_genes):
        glen = need + int(rng.integers(0, 500))
        genes.append((f"g{g}", BASES[rng.integers(0, 4, size=glen)].tobytes()))
    fa = tmp_path / f"e{seed}.fa"
    fa.write_bytes(b"".join(
        b">%s\n" % n.encode() + b"".join(
            q[i:i + 60] + b"\n" for i in range(0, len(q), 60))
        for n, q in genes))

    def noisy(r: bytes) -> bytes:
        r = bytearray(r)
        for _ in range(int(rng.integers(0, 3))):
            r[int(rng.integers(0, len(r)))] = ord("N")
        if rng.random() < 0.2:
            r = bytearray(bytes(r).lower())
        return bytes(r)

    def qual(n: int) -> bytes:
        # bench.py's profile, about 2% of bases under -q 10: a read keeps
        # enough whole k-mers to reach C
        q = rng.integers(33 + 20, 33 + 41, size=n)
        low = rng.random(n) < 0.02
        q[low] = rng.integers(33 + 2, 33 + 10, size=int(low.sum()))
        return q.astype(np.uint8).tobytes()

    reads1, reads2, quals1, quals2 = [], [], [], []
    for l1, l2, gap in mates:
        gseq = genes[int(rng.integers(0, n_genes))][1]
        from_gene = rng.random() < 0.85
        if from_gene:
            s = int(rng.integers(0, len(gseq) - (l1 + gap + l2) + 1))
            r1 = gseq[s:s + l1]
            r2 = gseq[s + l1 + gap:s + l1 + gap + l2].translate(_COMP)[::-1]
            if not paired and rng.random() < 0.5:
                r1 = r1.translate(_COMP)[::-1]
        else:
            r1 = BASES[rng.integers(0, 4, size=l1)].tobytes()
            r2 = BASES[rng.integers(0, 4, size=l2)].tobytes()
        reads1.append(noisy(r1))
        quals1.append(qual(l1))
        if paired:
            reads2.append(noisy(r2))
            quals2.append(qual(l2))

    def write_fq(path, rs, qs):
        path.write_bytes(b"".join(b"@r%04d\n%s\n+\n%s\n" % (i, r, q)
                                  for i, (r, q) in enumerate(zip(rs, qs))))

    fq1 = tmp_path / f"e{seed}_1.fq"
    write_fq(fq1, reads1, quals1)
    fq2 = None
    if paired:
        fq2 = tmp_path / f"e{seed}_2.fq"
        write_fq(fq2, reads2, quals2)
    longest = max(fused)
    max_read_len = {"auto": 0,
                    "rounded": pipeline._round_len(longest, k)}.get(lens)
    if lens == "unpacked":
        max_read_len = longest + int(rng.integers(0, 12))
        max_read_len += max_read_len % 8 == 0
    return {
        "k": k, "minq": minq, "paired": paired, "gz": False, "genes": genes,
        "fa": fa, "fq1": fq1, "fq2": fq2, "reads1": reads1, "reads2": reads2,
        "quals1": quals1, "quals2": quals2, "band": band, "longest": longest,
        "lens": lens, "max_read_len": max_read_len, "single": single,
        "max_winners": max_winners, "batch_size": batch_size,
        "probe": probe, "threads": threads,
    }


def run_edges(tmp_path, seed: int, device="cpu") -> dict:
    """ONE edge seed (draw_edges) through the port on `device`: the native
    engine, the Python I/O, --backend native and, on a card, --backend cpu
    (on the CPU the first two already run the plain versions), at C, on
    the seed's FASTA and then on _tied's, every run with the seed's
    max_read_len, batch size, -s and max_winners (the classifiers' and the
    config's). Every ssv equals the oracle's (the index's Bloom size, -s),
    and every FASTQ the first run's of its group; on a card each device
    run's layout kernels launched. The Bloom size is the config's (tests
    shrink config.BF_UNIT_BITS). Raises AssertionError on any difference,
    and when the seed's ties should overflow the winner list (-s off,
    max_winners 1, a read of the ties pass tied across two genes) and a
    device run of the ties pass recomputed no row on the host. Returns
    what it covered: "band",
    "longest", "L" (the geometries the device classifier ran), "lens",
    "max_read_len", "packed" (the engine handed over planar batches),
    "engine" (the device run went through the native engine: always, at
    any length), "auto_len", "single",
    "max_winners", "batch_size", "layout", "paired", "pair_emits" (reads
    of a paired seed emitted at C), "host_rows" (rows the host recomputed
    in the ties pass's device run), "should_overflow", "group_rows",
    "n_reads", "associations", "launches", "configs" and "outputs" (the
    native runs' config fields and bytes, by group)."""
    tmp_path = Path(tmp_path)
    device = torch.device(device)
    on_card = device.type == "cuda"
    w = draw_edges(tmp_path, seed)
    probe, W = w["probe"], w["max_winners"]
    layout = "hashed" if probe == "auto" else probe
    forced = None if probe == "auto" else probe
    tw = _tied(w, tmp_path, seed)

    def cfg_of(wl, mode, **kw):
        return SharkConfig(
            fasta_path=str(wl["fa"]),
            sample1_path=str(w["fq1"]),
            sample2_path=str(w["fq2"]) if w["fq2"] else "",
            out1_path=str(tmp_path / f"e{mode}{seed}.1.fq"),
            out2_path=(str(tmp_path / f"e{mode}{seed}.2.fq") if w["fq2"]
                       else ""),
            ssv_path=str(tmp_path / f"e{mode}{seed}.ssv"),
            k=w["k"], c=C, min_quality=w["minq"], single=w["single"],
            batch_size=w["batch_size"], max_read_len=w["max_read_len"],
            max_winners=W, probe=probe, **kw)

    launched = dict.fromkeys(kernels.KERNELS, 0)
    outs, seen, configs, geometries = {}, {}, {}, set()

    def run(group, wl, tag, mode, clf, path, **kw):
        name = tag + mode
        cfg = cfg_of(wl, name, **kw)
        configs.setdefault(group, dataclasses.asdict(cfg))
        kernels.LAUNCHES.reset()
        pipeline.HOST_ROWS.reset()
        stats = run_pipeline(cfg, classifier=clf)
        counts = kernels.LAUNCHES.snapshot()
        for kernel, n in counts.items():
            launched[kernel] += n
        native_run = mode != "python"
        assert stats.get("native", False) == native_run, (seed, name)
        if w["lens"] == "auto" and native_run:
            assert stats["auto_max_read_len"] == pipeline._round_len(
                w["longest"], w["k"]), (seed, name, stats)
        if clf is None:
            assert stats["probe"] == "host"
        else:
            assert stats["probe"] == layout, (seed, name, stats["probe"])
            if clf.device == device:
                geometries.update(clf._meta)
        if on_card and path is not None:
            _check_launches(f"edge seed {seed} {name}", counts, path)
        else:
            assert not any(counts.values()), f"{name} launched {counts}"
        outs.setdefault(group, []).append(
            (name, *_outputs(tmp_path / f"e{name}{seed}", w["paired"])))
        seen[name] = (stats, pipeline.HOST_ROWS.snapshot()["oracle"])

    def group_runs(group, wl, tag):
        index = load_or_build_index(cfg_of(wl, f"{tag}index"), PhaseTimer())
        clf = Classifier(index, max_winners=W, c=C, device=device,
                         probe=forced)
        assert clf.probe == layout, (probe, clf.probe)
        run(group, wl, tag, "native", clf, layout, use_native=True)
        run(group, wl, tag, "python", clf, layout, use_native=False)
        clf = None
        if on_card:  # on the CPU the runs above were the plain versions
            clf = Classifier(index, max_winners=W, c=C, device="cpu",
                             probe=forced)
            run(group, wl, tag, "cpu", clf, None, backend="cpu")
            clf = None
        run(group, wl, tag, "host", None, None, backend="native",
            threads=w["threads"])
        return index.size_bits

    size_bits = group_runs(C, w, "")
    group_runs("ties", tw, "t")
    wants = {C: _oracle_ssv(w, C, size_bits, w["single"]),
             "ties": _oracle_ssv(tw, C, size_bits, w["single"])}
    _hold_to_oracle(outs, wants, f"edge seed {seed}")
    per_read = Counter(ln.split()[0] for ln in wants["ties"].splitlines())
    should = not w["single"] and W == 1 and 2 in per_read.values()
    for name in ("tnative", "tpython", "tcpu"):
        assert seen.get(name, (None, 1))[1] or not should, (
            f"edge seed {seed}: reads tied across two genes at max_winners "
            f"1, and no row of {name} took the host recompute")
    host_rows = seen["tnative"][1]
    return {
        "band": w["band"], "longest": w["longest"], "L": sorted(geometries),
        "lens": w["lens"], "max_read_len": w["max_read_len"],
        "packed": w["lens"] != "unpacked", "engine": True,
        "auto_len": seen["native"][0].get("auto_max_read_len"),
        "single": w["single"], "max_winners": W,
        "batch_size": w["batch_size"], "layout": layout,
        "paired": w["paired"],
        "pair_emits": (len({ln.split()[0] for ln in wants[C].splitlines()})
                       if w["paired"] else 0),
        "host_rows": host_rows, "should_overflow": should,
        "group_rows": seen["tnative"][0].get("group_rows", 0),
        "n_reads": len(w["reads1"]),
        "associations": sum(v.count("\n") for v in wants.values()),
        "launches": launched,
        "configs": configs,
        "outputs": {g: runs[0][1:] for g, runs in outs.items()},
    }


# the auto length's longest read past which the engine, when it took one
# width for the whole sample, left the sample to the Python I/O
LONG_AUTO = 2048


def edge_covers(got: dict) -> set:
    """What one run_edges result covers: its band, max_winners, batch
    size, --max-read-len kind and layout, and where reached the unpacked
    engine path, the auto length past LONG_AUTO bases (on the engine,
    where the sample's one pre-scanned width once sent it to the Python
    I/O), a paired seed's emitting pairs, -s and the host recompute."""
    out = {f"band{got['band']}", f"W{got['max_winners']}",
           f"B{got['batch_size']}", got["lens"], got["layout"]}
    for key, on in (("unpacked_engine", got["lens"] == "unpacked"),
                    ("auto_long", got["lens"] == "auto"
                     and got["longest"] > LONG_AUTO),
                    ("pair_emits", got["pair_emits"]),
                    ("single", got["single"]),
                    ("host_rows", got["host_rows"])):
        if on:
            out.add(key)
    return out


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
