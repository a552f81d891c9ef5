"""-s/--single through shark_tpu_torch, against shark_tpu.

In single mode a read is reported only when exactly one gene wins it: a
GROUP verdict (>= 3 tied members by construction) and every other tie are
dropped, and the pair stream and its speculation are skipped
(shark_tpu_torch/pipeline.py, the `cfg.single` branches).
- the port's `_winner_pairs` with single=True on tests/test_groups.py's
  family workload (60 core reads, tied across a family, with GROUP
  verdicts, and 60 flank reads) equals shark_tpu's `_winner_pairs` and the
  port's oracle (classify_read(..., only_single=True)); no core read is
  emitted and some flank read is;
- the `-s` CLI writes shark_tpu's CLI's ssv and FASTQ bytes on a family
  workload (tests/test_torch_pipeline.py's, -b unit shrunk to 2^20 bits)
  through the native engine, the Python I/O (--no-native) and
  --backend native;
- on a card (marked `cuda`), the `-s` CLI on cuda:0 writes the bytes of
  its --backend cpu run, with the front end, the probe and the finish
  launched.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from shark_tpu import cli as jcli  # noqa: E402
from shark_tpu import config as jconfig  # noqa: E402
from shark_tpu.classify.step import Classifier as JClassifier  # noqa: E402
from shark_tpu.config import SharkConfig as JConfig  # noqa: E402
from shark_tpu.pipeline import _winner_pairs as j_winner_pairs  # noqa: E402
from shark_tpu_torch import cli as tcli  # noqa: E402
from shark_tpu_torch import config as tconfig  # noqa: E402
from shark_tpu_torch import kernels  # noqa: E402
from shark_tpu_torch.classify.oracle import (  # noqa: E402
    build_oracle_index,
    classify_read,
)
from shark_tpu_torch.classify.step import (  # noqa: E402
    PACK_GRP_SHIFT,
    Classifier,
)
from shark_tpu_torch.config import SharkConfig  # noqa: E402
from shark_tpu_torch.convert import index_from_arrays  # noqa: E402
from shark_tpu_torch.io import native  # noqa: E402
from shark_tpu_torch.ops.kmers import encode_bytes  # noqa: E402
from shark_tpu_torch.pipeline import _winner_pairs  # noqa: E402
from test_groups import _encode, _sample, family_workload  # noqa: E402,F401
from test_torch_pipeline import _family_fastx, _outputs  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

N_CORE = N_FLANK = 60


def test_single_winner_pairs_match_shark_tpu_and_oracle(family_workload):
    records, index, _ = family_workload
    rng = np.random.default_rng(4)
    reads = _sample(rng, records, N_CORE, "core") + _sample(
        rng, records, N_FLANK, "flank")
    codes = _encode(reads)
    tindex = index_from_arrays(vars(index))
    clf = Classifier(tindex, max_winners=8, c=0.6, device="cpu")
    res = clf(codes)
    grp = (res[0].numpy() >> PACK_GRP_SHIFT) & 1
    assert int(grp[:N_CORE].sum()) > 0, "no GROUP verdict to drop"
    ri, gi = _winner_pairs(SharkConfig(c=0.6, single=True), tindex, res,
                           len(reads), codes, 8, groups=clf.groups)

    jclf = JClassifier(index, max_winners=8, c=0.6)
    jres = tuple(np.asarray(x) for x in jclf(codes))
    want_r, want_g = j_winner_pairs(JConfig(c=0.6, single=True), index, jres,
                                    len(reads), codes, 8,
                                    groups=jclf.groups)
    np.testing.assert_array_equal(ri, want_r)
    np.testing.assert_array_equal(gi, want_g)

    oracle = build_oracle_index(records, tindex.k, tindex.size_bits)
    ora_r, ora_g = [], []
    for i, r in enumerate(reads):
        w, _, _ = classify_read(oracle, encode_bytes(r), 0.6, True)
        ora_r += [i] * len(w)
        ora_g += w
    np.testing.assert_array_equal(ri, ora_r)
    np.testing.assert_array_equal(gi, ora_g)
    assert ri.size > 0 and set(ri.tolist()).isdisjoint(range(N_CORE))
    assert np.unique(ri).size == ri.size  # one gene a read


def _cli_argv(fa, fq, tmp_path, tag, extra):
    return ["-r", fa, "-1", fq[0], "-o", str(tmp_path / f"{tag}.1.fq"),
            "--ssv", str(tmp_path / f"{tag}.ssv"), "-k", "15", "-c", "0.5",
            "-b", "1", "-s", "--batch-size", "64", *extra]


def _single_ssv_ok(ssv: bytes) -> None:
    reads = [line.split()[0] for line in ssv.splitlines()]
    assert reads, "workload emitted no association"
    assert len(set(reads)) == len(reads), "a read reported twice under -s"


@pytest.mark.parametrize("extra", [
    ["--backend", "cpu"],
    ["--backend", "cpu", "--no-native"],
    ["--backend", "native", "-t", "2"],
], ids=["native-engine", "python-io", "backend-native"])
def test_single_cli_matches_shark_tpu(tmp_path, monkeypatch, extra):
    if not native.available():
        pytest.skip("native engine unavailable")
    monkeypatch.setattr(jconfig, "BF_UNIT_BITS", 1 << 20)
    monkeypatch.setattr(tconfig, "BF_UNIT_BITS", 1 << 20)
    fa, fq = _family_fastx(tmp_path, np.random.default_rng(41), False)
    outs = {}
    for tag, cli in (("jax", jcli), ("torch", tcli)):
        jit = ["--compile-cache", ""] if "native" not in extra else []
        assert cli.main(_cli_argv(fa, fq, tmp_path, tag, extra + jit)) == 0
        outs[tag] = _outputs(tmp_path, tag, False)
    _single_ssv_ok(outs["jax"][0])
    assert outs["torch"] == outs["jax"]


@pytest.mark.cuda
def test_single_cli_on_the_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if not native.available():
        pytest.skip("native engine unavailable")
    monkeypatch.setattr(tconfig, "BF_UNIT_BITS", 1 << 20)
    fa, fq = _family_fastx(tmp_path, np.random.default_rng(41), False)
    assert tcli.main(_cli_argv(fa, fq, tmp_path, "cpu",
                               ["--backend", "cpu"])) == 0
    kernels.LAUNCHES.reset()
    assert tcli.main(_cli_argv(fa, fq, tmp_path, "card", [])) == 0
    n = kernels.LAUNCHES.snapshot()
    assert n["front"] > 0 and n["probe"] > 0 and n["finish"] > 0, n
    want = _outputs(tmp_path, "cpu", False)
    _single_ssv_ok(want[0])
    assert _outputs(tmp_path, "card", False) == want
