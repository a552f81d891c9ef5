"""The native engine's auto geometry, on the CPU: with no --max-read-len
the engine packs each batch at pipeline._round_len(its longest fused
read, k), and the device path runs without a pre-scan of the sample.

- An auto-length run through the engine writes the bytes of a run at a
  fixed --max-read-len of the sample's rounded longest read, of
  shark_tpu's run_pipeline and of shark_tpu's oracle, on samples of mixed
  lengths (35-151 bases), pairs with unequal mates, the longest read alone
  in the last batch, one batch holding a read past 2048 bases, gzip, an
  empty sample, a read count that is not a multiple of the batch, and a
  FIFO. Each run reports the pass's widths: batch_geometries,
  narrow_batches and auto_max_read_len, and one Classifier runs every
  width the pass needs.
- At a fixed max_len the engine hands over the arrays of shark_tpu's
  engine, byte for byte: packed and byte codes, single and paired, one and
  three encoder threads.
- --backend native still sizes its one width with the pre-scan.

The -b unit is shrunk to 2^20 bits in both packages; each pipeline run
has a time limit of its own.
"""

import gzip
import os
import threading
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")

from shark_tpu import config as jconfig  # noqa: E402
from shark_tpu.classify.oracle import (  # noqa: E402
    build_oracle_index,
    classify_read,
)
from shark_tpu.config import SharkConfig as JConfig  # noqa: E402
from shark_tpu.io import native as jnative  # noqa: E402
from shark_tpu.ops.kmers import encode_bytes  # noqa: E402
from shark_tpu.pipeline import run_pipeline as jrun_pipeline  # noqa: E402
from shark_tpu_torch import config as tconfig  # noqa: E402
from shark_tpu_torch import pipeline  # noqa: E402
from shark_tpu_torch.classify.step import Classifier  # noqa: E402
from shark_tpu_torch.config import SharkConfig  # noqa: E402
from shark_tpu_torch.io import native  # noqa: E402
from shark_tpu_torch.utils.timers import PhaseTimer  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
K, C, B = 19, 0.5, 8
RUN_S = 120  # each pipeline run's limit

# name: (reads, {read index: length} or a length range, mate 2's range,
# gzip, FIFO); B = 8 reads a batch
SAMPLES = {
    # adapter-trimmed lengths: batches of 8 differ in their longest read
    "mixed": (100, (35, 151), None, False, False),
    "paired_unequal": (60, (35, 151), (35, 151), False, False),
    # 40 reads of 100 bases and a 41st of 300, alone in the last batch
    "longest_last": (41, {40: 300}, None, False, False),
    # batch 2 holds a read of 2100 bases (L = 4096)
    "long_read": (40, {19: 2100}, None, False, False),
    "gzip": (50, (35, 151), None, True, False),
    "empty": (0, (35, 151), None, False, False),
    # 29 reads of 100 bases: one width, the last batch 5 reads
    "ragged": (29, {}, None, False, False),
    "fifo": (50, (35, 151), None, False, True),
}
# the widths of the batches of the samples whose lengths are set, in order
# (the others' follow from their drawn reads)
WIDTHS = {"longest_last": [104] * 5 + [320], "long_read": [104, 104, 4096,
                                                           104, 104],
          "ragged": [104] * 4, "empty": []}


@pytest.fixture
def small_bloom(monkeypatch):
    if not native.available():
        pytest.skip("the C++ engine (g++) is needed")
    monkeypatch.setattr(jconfig, "BF_UNIT_BITS", 1 << 20)
    monkeypatch.setattr(tconfig, "BF_UNIT_BITS", 1 << 20)


def _within(seconds, fn, *args, **kw):
    """fn(*args, **kw) on a thread of its own, failed when it takes longer
    than `seconds`."""
    out, err = [], []

    def body():
        try:
            out.append(fn(*args, **kw))
        except BaseException as e:  # noqa: BLE001 - reraised below
            err.append(e)

    th = threading.Thread(target=body, daemon=True)
    th.start()
    th.join(seconds)
    assert not th.is_alive(), f"{fn.__name__} ran past {seconds} s"
    if err:
        raise err[0]
    return out[0]


def _write_sample(tmp, name):
    """Genes and reads of SAMPLES[name] under tmp; returns the workload:
    paths, genes, reads and qualities of each mate, the longest fused
    read."""
    n, lens, lens2, gz, _ = SAMPLES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    genes = [BASES[rng.integers(0, 4, size=2600)].tobytes()
             for _ in range(6)]
    fa = tmp / "genes.fa"
    fa.write_bytes(b"".join(b">g%d\n%s\n" % (i, g)
                            for i, g in enumerate(genes)))

    def draw(i, spec):
        if isinstance(spec, dict):
            ln = spec.get(i, 100)
        else:
            ln = int(rng.integers(spec[0], spec[1] + 1))
        if rng.random() < 0.2:  # a read from no gene
            return BASES[rng.integers(0, 4, size=ln)].tobytes()
        g = genes[int(rng.integers(0, len(genes)))]
        s = int(rng.integers(0, len(g) - ln + 1))
        return g[s:s + ln]

    mates = [[draw(i, lens) for i in range(n)]]
    if lens2 is not None:
        mates.append([draw(i, lens2) for i in range(n)])
    paths = []
    for m, reads in enumerate(mates):
        quals = [(rng.integers(35, 74, size=len(r)).astype(np.uint8)
                  .tobytes()) for r in reads]
        body = b"".join(b"@r%04d\n%s\n+\n%s\n" % (i, r, q)
                        for i, (r, q) in enumerate(zip(reads, quals)))
        path = tmp / (f"reads_{m + 1}.fq" + (".gz" if gz else ""))
        path.write_bytes(gzip.compress(body, mtime=0) if gz else body)
        paths.append(path)
    fused = [sum(len(m[i]) for m in mates) + len(mates) - 1
             for i in range(n)]
    return {"fa": fa, "fq": paths, "genes": genes, "mates": mates,
            "longest": max(fused, default=0)}


def _cfg(w, tag, max_read_len=0, fq=None, **kw):
    fq = fq or w["fq"]
    paired = len(fq) == 2
    tmp = w["fa"].parent
    return SharkConfig(
        fasta_path=str(w["fa"]), sample1_path=str(fq[0]),
        sample2_path=str(fq[1]) if paired else "",
        out1_path=str(tmp / f"{tag}.1.fq"),
        out2_path=str(tmp / f"{tag}.2.fq") if paired else "",
        ssv_path=str(tmp / f"{tag}.ssv"), k=K, c=C, batch_size=B,
        max_read_len=max_read_len, **kw)


def _files(cfg):
    return tuple(open(p, "rb").read() if p else b""
                 for p in (cfg.ssv_path, cfg.out1_path, cfg.out2_path))


def _oracle_ssv(w, size_bits):
    """shark_tpu's oracle on every read (mates fused with 'N')."""
    oracle = build_oracle_index(
        [(f"g{i}", g) for i, g in enumerate(w["genes"])], K, size_bits)
    lines = []
    for i, r1 in enumerate(w["mates"][0]):
        seq = r1 + (b"N" + w["mates"][1][i] if len(w["mates"]) == 2 else b"")
        wins, _, _ = classify_read(oracle, encode_bytes(seq), C, False)
        lines += [f"r{i:04d} g{g}\n" for g in wins]
    return "".join(lines).encode()


def _serve_fifo(path, data):
    """A writer that hands `data` to the FIFO's first reader; returns a
    callable that unblocks the writer if no reader ever came."""
    os.mkfifo(path)

    def write():
        with open(path, "wb") as f:
            f.write(data)

    th = threading.Thread(target=write, daemon=True)
    th.start()

    def stop():
        if th.is_alive():
            os.close(os.open(path, os.O_RDONLY | os.O_NONBLOCK))
        th.join(10)

    return stop


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_auto_geometry_writes_the_bytes_of_every_reference(
        tmp_path, small_bloom, name):
    w = _write_sample(tmp_path, name)
    index = pipeline.load_or_build_index(_cfg(w, "index"), PhaseTimer())
    clf = Classifier(index, max_winners=16, c=C, device="cpu")
    fq, stop = w["fq"], None
    if SAMPLES[name][4]:
        fifo = tmp_path / "reads_fifo.fq"
        stop = _serve_fifo(str(fifo), w["fq"][0].read_bytes())
        fq = [fifo]
    auto = _cfg(w, "auto", fq=fq)
    try:
        stats = _within(RUN_S, pipeline.run_pipeline, auto, classifier=clf)
    finally:
        if stop is not None:
            stop()
    got = _files(auto)
    n = SAMPLES[name][0]
    assert stats["native"] is True and stats["n_reads"] == n
    assert "prescan_wait" not in stats["spans"]
    # the widths the pass ran, from the reads themselves
    widths = WIDTHS.get(name) or [
        pipeline._round_len(max(
            sum(len(m[i]) for m in w["mates"]) + len(w["mates"]) - 1
            for i in range(b, min(b + B, n))), K)
        for b in range(0, n, B)]
    widest = max(widths, default=0)
    narrow = sum(x < widest for x in widths)
    assert stats["batch_geometries"] == len(set(widths))
    assert stats["narrow_batches"] == narrow
    assert stats["spans"]["ring_wait"]["n"] == len(widths) + 1
    assert stats["spans"].get("warmup_batch", {"n": 0})["n"] == (
        1 if widths else 0)
    if widths:
        assert stats["auto_max_read_len"] == widest == pipeline._round_len(
            w["longest"], K)
        # the warm-up and every batch: each width once in the classifier
        assert set(clf._meta) == set(widths)
    else:
        assert "auto_max_read_len" not in stats and not any(got)
    if name in ("mixed", "longest_last", "long_read"):
        assert narrow > 0 and len(clf._meta) > 1

    fixed = _cfg(w, "fixed", max(widest, pipeline._round_len(0, K)))
    stats_f = _within(RUN_S, pipeline.run_pipeline, fixed, classifier=clf)
    assert stats_f["batch_geometries"] == min(1, n)
    assert stats_f["narrow_batches"] == 0
    assert "auto_max_read_len" not in stats_f
    assert _files(fixed) == got, f"{name}: auto and fixed bytes differ"

    jcfg = JConfig(**{**{f: getattr(_cfg(w, "jax"), f) for f in (
        "fasta_path", "sample1_path", "sample2_path", "out1_path",
        "out2_path", "ssv_path", "k", "c", "batch_size")},
        "backend": "cpu", "compile_cache": ""})
    _within(RUN_S, jrun_pipeline, jcfg)
    assert _files(jcfg) == got, f"{name}: bytes differ from shark_tpu"
    assert got[0] == _oracle_ssv(w, index.size_bits), (
        f"{name}: ssv differs from shark_tpu's oracle")


def _stream_all(mod, fq, max_len, packed, threads, mq):
    """Every batch a NativeStream of `mod` hands over, as bytes."""
    ns = mod.NativeStream(*fq, B, max_len, mq, packed=packed,
                          encode_threads=threads)
    out = []
    try:
        while True:
            nb = ns.next_batch()
            if nb is None:
                return out
            *arrays, slot, n = nb
            out.append((n, [a.tobytes() for a in arrays]))
            ns.release(slot)
    finally:
        ns.close()


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "codes"])
@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
@pytest.mark.parametrize("threads", [1, 3])
def test_fixed_geometry_hands_over_shark_tpus_arrays(tmp_path, small_bloom,
                                                     packed, paired,
                                                     threads):
    """At a fixed max_len (304 packed, 307 as byte codes; the longest pair
    fuses to 303 bases) the engine's batches are shark_tpu's engine's,
    byte for byte, with the quality mask (-q 20) on."""
    if jnative.get_lib() is None:
        pytest.skip("shark_tpu's engine did not build")
    w = _write_sample(tmp_path, "paired_unequal")
    fq = [str(p) for p in w["fq"][:2 if paired else 1]]
    fq += [""] * (2 - len(fq))
    max_len = 304 if packed else 307
    ours = _stream_all(native, fq, max_len, packed, threads, 20)
    theirs = _stream_all(jnative, fq, max_len, packed, threads, 20)
    assert len(ours) == -(-60 // B)
    assert ours == theirs


def test_native_backend_keeps_the_prescan(tmp_path, small_bloom):
    """--backend native still waits on one pre-scan (span prescan_wait)
    and classifies at the sample's one width."""
    w = _write_sample(tmp_path, "mixed")
    cfg = _cfg(w, "host", backend="native")
    stats = _within(RUN_S, pipeline.run_pipeline, cfg)
    assert stats["spans"]["prescan_wait"]["n"] == 1
    assert stats["auto_max_read_len"] == pipeline._round_len(w["longest"], K)
    ref = _cfg(w, "ref")
    index = pipeline.load_or_build_index(ref, PhaseTimer())
    _within(RUN_S, pipeline.run_pipeline, ref,
            classifier=Classifier(index, max_winners=16, c=C, device="cpu"))
    assert _files(cfg) == _files(ref)
