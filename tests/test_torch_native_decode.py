"""The drain's verdict decode in the engine (shk_decode_verdicts,
shk_expand_groups through io/native.py's VerdictDecoder), on the CPU.

- Batch by batch: pipeline._winner_pairs with a decoder gives the pairs,
  the drain's counts and the speculation state of _winner_pairs without
  one (the numpy path, its twin), on synthetic packed verdicts: single
  winners, ties through a pair stream (the pair (row 65535, gene 65535)
  that equals PAIR_SENTINEL among them), GROUP rows among tie and single
  rows, -s, an empty batch and one with nothing to emit, a speculated
  stream too short for the batch (decoded on a second call), padding
  rows past n with verdicts, and rows only the numpy path decodes (a
  device-overflowed row, one tied past max_winners).
- A whole pass on the engine's stream at the benchmark cells' shapes, cut
  small: every batch decodes in the engine (native_decode_batches equals
  the engine's batches), and the ssv and FASTQ bytes are those of the
  same pass with the engine's decode turned off and, where JAX is
  installed, shark_tpu's.
"""

import json
import os

import numpy as np
import pytest
import torch

from portbench import generate
from shark_tpu_torch import pipeline
from shark_tpu_torch.classify.step import (
    PACK_EMIT_SHIFT,
    PACK_GRP_SHIFT,
    PACK_NW_SHIFT,
    PACK_OVF_SHIFT,
    Classifier,
    GeneGroups,
    extract_pairs,
)
from shark_tpu_torch.config import SharkConfig
from shark_tpu_torch.index.build import build_index
from shark_tpu_torch.io import native
from shark_tpu_torch.io.fastx import read_fasta
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 4  # max_winners of the synthetic batches
# group g holds genes [10 g, 10 g + 3 + g): 3 to 7 members
GROUPS = GeneGroups(
    offsets=np.cumsum([0] + [3 + g for g in range(5)]).astype(np.int64),
    flat=np.concatenate([np.arange(10 * g, 10 * g + 3 + g)
                         for g in range(5)]).astype(np.uint16),
)


@pytest.fixture(autouse=True)
def engine():
    if not native.available():
        pytest.skip("the C++ engine (g++) is needed")


def _verdicts(rows, B):
    """(packed int32[B], winners int32[B, W]) from {row: (kind, arg)}:
    ("win", genes) emitted winners, ascending; ("group", gid); ("quiet",
    genes) winners under the coverage cut; ("ovf", None) a verdict the
    device flagged; ("many", n) n tied winners, the first W listed."""
    packed = np.zeros(B, np.int64)
    winners = np.zeros((B, W), np.int64)
    for r, (kind, arg) in rows.items():
        if kind == "group":
            packed[r] = (arg | (1 << PACK_NW_SHIFT) | (1 << PACK_EMIT_SHIFT)
                         | (1 << PACK_GRP_SHIFT))
            continue
        if kind == "ovf":
            packed[r] = (1 << PACK_OVF_SHIFT) | (1 << PACK_EMIT_SHIFT)
            continue
        genes = list(range(arg)) if kind == "many" else sorted(arg)
        nw = len(genes)
        packed[r] = genes[0] | (min(nw, 31) << PACK_NW_SHIFT)
        if kind != "quiet":
            packed[r] |= 1 << PACK_EMIT_SHIFT
        winners[r, :min(nw, W)] = genes[:W]
    return (torch.from_numpy(packed.astype(np.int32)),
            torch.from_numpy(winners.astype(np.int32)))


def _random_rows(rng, rows, kinds, n_genes=4096):
    out = {}
    for r in rows:
        kind = kinds[rng.integers(len(kinds))]
        if kind == "none":
            continue
        if kind == "group":
            out[int(r)] = ("group", int(rng.integers(len(GROUPS.offsets) - 1)))
        else:
            nw = 1 if kind == "win1" else int(rng.integers(1, W + 1))
            genes = rng.choice(n_genes, nw, replace=False).tolist()
            out[int(r)] = ("quiet" if kind == "quiet" else "win", genes)
    return out


def _case(name):
    """(B, n, rows, single, spec cap or None, decodes in the engine)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "single_winners":
        rows = _random_rows(rng, range(200), ["win1", "none", "quiet"])
        return 256, 200, rows, False, None, True
    if name == "ties_with_the_sentinel_pair":
        B = 1 << 16
        rows = _random_rows(rng, rng.choice(B - 1, 3000, replace=False),
                            ["win1", "win", "quiet"], n_genes=1 << 16)
        rows[B - 1] = ("win", [7, (1 << 16) - 1])  # (65535, 65535)
        return B, B, rows, False, 1 << 14, True
    if name == "ties_first_batch_no_stream":
        rows = _random_rows(rng, range(180), ["win1", "win", "none"])
        return 256, 180, rows, False, None, True
    if name == "ties_stream_too_short":
        rows = _random_rows(rng, range(256), ["win", "win"])
        return 256, 256, rows, False, 16, True
    if name == "groups_among_ties_and_singles":
        rows = _random_rows(rng, range(250),
                            ["win1", "win", "group", "group", "none"])
        rows[0] = ("group", 4)
        rows[249] = ("group", 0)
        return 256, 250, rows, False, 1 << 14, True
    if name == "groups_only":
        rows = _random_rows(rng, range(64), ["group", "none"])
        return 64, 64, rows, False, None, True
    if name == "single_mode":
        rows = _random_rows(rng, range(256),
                            ["win1", "win", "group", "none", "quiet"])
        return 256, 256, rows, True, None, True
    if name == "single_winners_spec_unused":
        rows = _random_rows(rng, range(128), ["win1", "none"])
        return 128, 128, rows, False, 1 << 14, True
    if name == "empty_batch":
        return 64, 0, {}, False, 1 << 14, True
    if name == "nothing_emitted":
        rows = _random_rows(rng, range(64), ["quiet", "none"])
        rows[3] = ("quiet", [5])
        return 64, 64, rows, False, 1 << 14, True
    if name == "padding_rows_past_n":
        rows = _random_rows(rng, range(256), ["win1", "win", "none"])
        return 256, 200, rows, False, None, False
    if name == "device_overflow_row":
        rows = _random_rows(rng, range(64), ["win1", "win"])
        rows[17] = ("ovf", None)
        return 64, 64, rows, False, 1 << 14, False
    if name == "tied_past_max_winners":
        rows = _random_rows(rng, range(64), ["win1", "win"])
        rows[40] = ("many", W + 2)
        return 64, 64, rows, False, None, False
    raise KeyError(name)


CASES = ["single_winners", "ties_with_the_sentinel_pair",
         "ties_first_batch_no_stream", "ties_stream_too_short",
         "groups_among_ties_and_singles", "groups_only", "single_mode",
         "single_winners_spec_unused", "empty_batch", "nothing_emitted",
         "padding_rows_past_n", "device_overflow_row",
         "tied_past_max_winners"]


@pytest.fixture(scope="module")
def tiny_index():
    """An index the host oracle recomputes the numpy path's overflowed
    rows against; the batches' reads are all N, so it finds no winner."""
    return build_index([("g", b"ACGTACGTTGCAACGTTGCA" * 4)], 11, 1 << 12)


@pytest.mark.parametrize("name", CASES)
def test_native_decode_equals_the_numpy_path(name, tiny_index):
    B, n, rows, single, spec_cap, engine_decodes = _case(name)
    packed, winners = _verdicts(rows, B)
    result = (packed, winners, None, None)
    codes = np.full((B, 32), 4, np.uint8)
    cfg = SharkConfig(c=0.6, single=single)
    got = {}
    for side in ("numpy", "engine"):
        spec = (None if spec_cap is None
                else (extract_pairs(packed, winners, spec_cap), spec_cap))
        state = {"cap": spec_cap or 0, "idle": 2}
        counts = {}
        pipeline.HOST_ROWS.reset()
        ri, gi = pipeline._winner_pairs(
            cfg, tiny_index, result, n, codes, W, packed_np=packed.numpy(),
            spec=spec, spec_state=state, groups=GROUPS, counters=counts,
            decoder=(native.verdict_decoder(GROUPS) if side == "engine"
                     else None))
        got[side] = (ri.copy(), gi.copy(), counts, state,
                     pipeline.HOST_ROWS.snapshot()["oracle"])
    (r0, g0, c0, s0, o0), (r1, g1, c1, s1, o1) = got["numpy"], got["engine"]
    np.testing.assert_array_equal(r1, r0)
    np.testing.assert_array_equal(g1, g0)
    assert r1.dtype == g1.dtype == np.int32
    assert c1.pop("native_decode_batches") == int(engine_decodes)
    assert c0.pop("native_decode_batches") == 0
    assert c1 == c0
    assert s1 == s0, "the speculation state differs"
    assert o1 == o0
    if name in ("device_overflow_row", "tied_past_max_winners"):
        assert o0 > 0  # the host oracle ran on both sides
    if name.startswith("groups"):
        assert c0["group_rows"] > 0
    if name == "ties_with_the_sentinel_pair":
        assert r0[-1] == g0[-1] == (1 << 16) - 1


def test_decode_statuses():
    """The engine's own answers for what it hands back: a stream too
    short asks again with the total, one that does not end at the total
    is refused."""
    rows = {0: ("win", [1, 2]), 3: ("win", [4]), 5: ("win", [0, 6, 9])}
    packed, winners = _verdicts(rows, 8)
    dec = native.verdict_decoder()
    got, _, _ = dec.decode(packed.numpy(), 8, None, W, False)
    assert got == native.DECODE_NEED_PAIRS and dec.info[3] == 6
    short = extract_pairs(packed, winners, 7).numpy()
    assert dec.decode(packed.numpy(), 8, short, W, False)[0] == (
        native.DECODE_NEED_PAIRS)
    stream = extract_pairs(packed, winners, 8).numpy().copy()
    got, ri, gi = dec.decode(packed.numpy(), 8, stream, W, False)
    assert got == 6 and dec.info[4] == 2 and dec.info[1] == 2
    assert ri.tolist() == [0, 0, 3, 5, 5, 5]
    assert gi.tolist() == [1, 2, 4, 0, 6, 9]
    stream[6] = 0  # a real key where the sentinel should be
    assert dec.decode(packed.numpy(), 8, stream, W, False)[0] == (
        native.DECODE_BAD_STREAM)
    packed[2] = 1 << PACK_OVF_SHIFT
    assert dec.decode(packed.numpy(), 8, stream, W, False)[0] == (
        native.DECODE_FALLBACK)


# ---------------------------------------------------------------------------
# whole passes at the cells' shapes
# ---------------------------------------------------------------------------

K, C, SIZE_BITS = 17, 0.6, 1 << 22
# cell: (configuration, traffic, genes block cut, reads, batch size)
SHAPES = {
    "panel": ("panel1385", "sample", {"count": 64}, 2048, 512),
    # families of 8 sharing a 600 bp core, so that pairs fall inside it
    # and B = 64 (under FIX_CAP2) makes GROUP verdicts
    "paired_families": ("txome20k", "paired",
                        {"count": 160, "length": 900, "family_core": 600,
                         "family_every": 16}, 512, 64),
    "tied_8_ways": ("isoform1385", "ties",
                    {"count": 128, "length": 240, "family_core": 160},
                    1024, 512),
}


def _cell_file(*parts):
    with open(os.path.join(ROOT, "portbench", *parts)) as f:
        return json.load(f)


@pytest.fixture(scope="module", params=sorted(SHAPES))
def shape(request, tmp_path_factory):
    conf_name, traffic_name, cut, reads, batch = SHAPES[request.param]
    conf = _cell_file("configs", f"{conf_name}.json")
    traffic = _cell_file("traffic", f"{traffic_name}.json")
    conf["genes"].update(cut)
    traffic["reads"] = reads
    d = tmp_path_factory.mktemp(request.param)
    paths = generate.write_inputs(str(d), conf, traffic, 2654435761)
    index = build_index(read_fasta(paths["fasta"]), K, SIZE_BITS)
    clf = Classifier(index, c=C, device="cpu")
    return {"name": request.param, "dir": d, "paths": paths, "clf": clf,
            "batch": batch}


def _pass(sh, tag, monkeypatch=None):
    d, fq = sh["dir"], sh["paths"]["fastq"]
    paired = len(fq) == 2
    cfg = SharkConfig(
        fasta_path=sh["paths"]["fasta"], sample1_path=fq[0],
        sample2_path=fq[1] if paired else "", k=K, c=C,
        out1_path=str(d / f"{tag}.1.fq"),
        out2_path=str(d / f"{tag}.2.fq") if paired else "",
        ssv_path=str(d / f"{tag}.ssv"), batch_size=sh["batch"],
        backend="cpu")
    stats = pipeline.run_pipeline(cfg, classifier=sh["clf"])
    assert stats["native"]
    out = [(d / f"{tag}.ssv").read_bytes(), (d / f"{tag}.1.fq").read_bytes()]
    if paired:
        out.append((d / f"{tag}.2.fq").read_bytes())
    return stats, out


def test_a_pass_decodes_every_batch_in_the_engine(shape, monkeypatch):
    stats, got = _pass(shape, "engine")
    assert stats["native_decode_batches"] == stats["engine"]["batches"] > 1
    assert stats["assoc"] == stats["n_associations"] > 0
    if shape["name"] == "paired_families":
        assert stats["group_rows"] > 0  # GROUP verdicts expanded natively
    if shape["name"] == "tied_8_ways":
        assert stats["tied_reads"] > 0
    monkeypatch.setattr(native, "verdict_decoder", lambda groups=None: None)
    plain, want = _pass(shape, "numpy")
    assert plain["native_decode_batches"] == 0
    assert got == want, "the engine's decode changed the output bytes"
    for name in pipeline.DRAIN_COUNTS[:-1]:
        assert stats[name] == plain[name], name


def test_a_pass_writes_shark_tpus_bytes(shape):
    """shark_tpu's run_pipeline on its own index of the same files."""
    pytest.importorskip("jax")
    from shark_tpu.classify.step import Classifier as JClassifier
    from shark_tpu.config import SharkConfig as JConfig
    from shark_tpu.index.build import build_index as jbuild_index
    from shark_tpu.io.fastx import read_fasta as jread_fasta
    from shark_tpu.pipeline import run_pipeline as jrun

    _, got = _pass(shape, "engine_j")
    d, fq = shape["dir"], shape["paths"]["fastq"]
    paired = len(fq) == 2
    jindex = jbuild_index(jread_fasta(shape["paths"]["fasta"]), K, SIZE_BITS)
    jcfg = JConfig(
        fasta_path=shape["paths"]["fasta"], sample1_path=fq[0],
        sample2_path=fq[1] if paired else "", k=K, c=C,
        out1_path=str(d / "jax.1.fq"),
        out2_path=str(d / "jax.2.fq") if paired else "",
        ssv_path=str(d / "jax.ssv"), batch_size=shape["batch"],
        compile_cache="")
    jrun(jcfg, classifier=JClassifier(jindex, c=C))
    want = [(d / "jax.ssv").read_bytes(), (d / "jax.1.fq").read_bytes()]
    if paired:
        want.append((d / "jax.2.fq").read_bytes())
    assert got == want
