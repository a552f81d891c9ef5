"""The port's K1 and K3 stage profilers and the FIX_CAP2 A/B
(scripts/profile_front_torch.py, profile_finish_torch.py,
ab_fixcap_torch.py), on the CPU at a tiny size.

bench_gpu.py's panel, homolog and txome generators at 20, 24 and 40
genes, 2000 reads, batches of 512, the -b unit shrunk to 2^22 bits
(config.BF_UNIT_BITS):
- each script's --cpu run prints its JSON line with every check true;
- every variant text is made from the committed csrc/front.cu and
  csrc/finish.cu with each anchor found once, and the top rungs' texts
  (front's m, finish's f) are the committed sources; a source without an
  anchor, or with one twice, makes variant_texts() raise, so a later
  edit to K1 or K3 that breaks a script fails here, not on the card;
- the FIX_CAP2 A/B on a small homolog batch: caps at or above the impure
  count give production's verdicts, a cap below it no GROUP bit and the
  full branch's verdicts (the plain finish given that cap, which
  tests/test_torch_finish.py::test_finish_tier_past_fix_cap2 holds to
  shark_tpu); with jax, production's verdicts equal shark_tpu's
  call_packed on the same batch;
- the three scripts import neither jax nor shark_tpu, nor bench/.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_gpu
from shark_tpu_torch import config
from shark_tpu_torch.classify import step
from shark_tpu_torch.io import native
from test_torch_profile_e2e import _script
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READS = 2000
TINY = dict(N_GENES=20, HOMOLOG_GENES=24, TXOME_GENES=40, BATCH=512)
SCRIPTS = ("profile_front_torch", "profile_finish_torch", "ab_fixcap_torch")


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    if shutil.which("g++") is None or not native.available():
        pytest.skip("the C++ engine (g++) is needed")
    monkeypatch.setattr(config, "BF_UNIT_BITS", 1 << 22)
    for name, v in TINY.items():
        monkeypatch.setattr(bench_gpu, name, v)
    # size_workloads sets these from --reads; the fixture restores them
    for name in ("CACHE", "N_READS", "N_PAIRS", "HOMOLOG_READS",
                 "TXOME_READS"):
        monkeypatch.setattr(bench_gpu, name, getattr(bench_gpu, name))
    return ["--cpu", "--reads", str(READS), "--cache",
            str(tmp_path / "cache")]


def _line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("wl", ["txome", "panel"])
def test_profile_front_cpu_line(tiny, capsys, wl):
    rc = _script("profile_front_torch").main(["--workload", wl, *tiny])
    line = _line(capsys)
    assert rc == 0 and all(v is True for v in line["checks"].values())
    assert set(line["checks"]) >= {"variant_texts_built",
                                   "m_text_is_committed",
                                   "plain_lengths_count_valid_bases",
                                   "plain_m2_in_range"}
    assert (line["batch_size"], line["max_read_len"]) == (512, 104)
    assert line["windows"] == 104 - 16 and line["device"] == "cpu"
    rungs = line["rungs"]
    assert list(rungs) == ["s", "d", "c", "h", "m", "m2", "l"]
    # the cumulative rungs' bounds do not fall; m's is chip_smoke.py's
    bounds = [rungs[r]["bound_ms"] for r in ("s", "d", "c", "h", "m")]
    assert bounds == sorted(bounds) and bounds[0] > 0
    n = 512 * 88
    assert rungs["m"]["operations"] == 50 * n
    assert rungs["m"]["bytes"] == 512 * (26 + 13) + 9 * n + 512 * 4
    assert all("device_ms" not in r for r in rungs.values())  # no card


def test_profile_finish_cpu_line(tiny, capsys):
    rc = _script("profile_finish_torch").main(tiny)
    line = _line(capsys)
    assert rc == 0 and all(v is True for v in line["checks"].values())
    assert {"panel_padding_windows_empty", "homolog_a5_plain_equals_plain",
            "f_text_is_committed"} <= set(line["checks"])
    wls = line["workloads"]
    assert set(wls) == {"panel", "homolog"}
    homolog = wls["homolog"]
    assert homolog["group_pass"]
    for wl in wls.values():
        assert ("g" in wl["rungs"]) == wl["group_pass"]
        sh = wl["shares"]
        assert sh["sort_skipped"] + sh["block_path"] + sh["no_key"] <= 1
        assert sh["one_gene"] <= 1 - sh["block_path"] - sh["no_key"] + 1e-9
        assert wl["keys"] > 0 and wl["max_nk"] >= 1
        b = wl["rungs"]
        assert b["k"]["bound_ms"] <= b["s"]["bound_ms"] <= b["c"][
            "bound_ms"] <= b["f"]["bound_ms"]
    # the tiny homolog's first batch is past its FIX_CAP2 (65 impure reads
    # of 512, cap 64): its core reads take full verdicts, a family of 8
    # genes a window, past the warp's 256 keys, so the block path
    sh = homolog["shares"]
    assert sh["group_verdicts"] == 0 and sh["block_path"] > 0.3
    assert homolog["block_reads"] == round(sh["block_path"] * 512)


def test_warp_path_shares_match_the_keys(tiny):
    """The shares come from the keys in the order the warp builds them:
    a read's keys ascend when its sorted keys equal them."""
    pf = _script("profile_finish_torch")
    pf.pe.size_workloads(READS, tiny[-1])
    b = bench_gpu.Bench(torch.device("cpu"), float("inf"))
    cfg, clf = pf.pe.workload_config(b, "homolog")
    packed, vmask = pf.first_batches(cfg, 1)[0]
    tags = clf.tags(packed, vmask)
    keys, _ = pf.warp_keys(clf, tags)
    sh = pf.path_shares(clf, tags)
    nk = (keys >= 0).sum(dim=1)
    assert torch.equal(nk, sh["nk"]) and int(nk.sum()) == sh["keys"]
    heavy = step.finish_heavy_reads_plain(
        tags[0], tags[1], rows3=clf.dix.rows3, ext_mat=clf.dix.ext_mat,
        meta=clf._geometry(104)[0], L=104, has_rows=clf._has_rows)
    assert int(heavy.sum()) == sh["block_reads"]
    for i in range(keys.shape[0]):
        k = keys[i][keys[i] >= 0]
        ascends = torch.equal(k, torch.sort(k).values)
        assert bool(sh["needs_sort"][i]) == (not ascends and not heavy[i])
    padded = sh["padded"]
    assert padded.shape == (keys.shape[0], sh["max_nk"])
    assert torch.equal((padded != 0x7FFFFFFF).sum(dim=1), nk)


def test_ab_fixcap_cpu_line(tiny, capsys):
    fc = _script("ab_fixcap_torch")
    rc = fc.main(tiny)
    line = _line(capsys)
    assert rc == 0 and all(v is True for v in line["checks"].values())
    assert line["checks"]["one_fix_cap2"] is True
    sw = line["sweep"]
    assert sw["production"]["fix_cap2"] == step.fix_caps(512)[1]
    assert {r["fix_cap2"] for r in sw["by_fix_div"].values()} == {
        step.fix_caps(512)[1]}
    assert len(line["batches"]) == 2
    cap = step.fix_caps(512)[1]
    for batch in line["batches"]:
        impure = batch["impure"]
        assert impure > 0, "cap 0 must fall below the batch's demand"
        for r in batch["caps"]:
            assert r["verdicts_equal_plain"] is True
            if r["fix_cap2"] >= impure:
                assert r["branch"] == "group" and r["group_bits"] > 0
            else:
                assert r["branch"] == "full" and r["group_bits"] == 0
            # production's verdicts wherever the cap falls on its side
            assert r.get("verdicts_equal_production") is (
                True if (r["fix_cap2"] >= impure) == (cap >= impure)
                else None)
            assert r["associations"] > 0 and r["winner_pairs_ms"] > 0
        # the full branch lists the family's genes through K4's stream
        rows = {r["fix_cap2"]: r for r in batch["caps"]}
        assert rows[0]["pairs"] > rows[65536]["pairs"]


def test_fix_caps_at_is_step_fix_caps():
    fc = _script("ab_fixcap_torch")
    for B in (512, 8192, 65536, 262144):
        assert fc.fix_caps_at(B, step.FIX_DIV) == step.fix_caps(B)
    assert fc.sweep(65536)["one_fix_cap2"]
    assert {fc.fix_caps_at(65536, d)[0] for d in fc.FIX_DIVS} == {
        4096, 1024, 512, 256}


def test_fixcap_production_equals_shark_tpu(tiny, tmp_path, monkeypatch):
    pytest.importorskip("jax")
    from shark_tpu import config as jconfig
    from shark_tpu.classify.step import Classifier as JClassifier
    from shark_tpu.index.structure import SharkIndex as JIndex

    monkeypatch.setattr(jconfig, "BF_UNIT_BITS", 1 << 22)
    fc = _script("ab_fixcap_torch")
    fc.pe.size_workloads(READS, tiny[-1])
    b = bench_gpu.Bench(torch.device("cpu"), float("inf"))
    cfg, clf = fc.pe.workload_config(b, "homolog")
    clf.index.save(str(tmp_path / "homolog.d"))
    jclf = JClassifier(JIndex.load(str(tmp_path / "homolog.d")),
                       max_winners=cfg.max_winners, c=cfg.c)
    groups = 0
    for packed, vmask, _ in fc.first_batches(cfg, 2):
        tags = clf.tags(packed, vmask)
        got = clf.finish(tags, fix_cap2=step.fix_caps(tags[0].shape[0])[1])
        want = jclf.call_packed(packed, vmask)
        groups += int(((got[0] >> step.PACK_GRP_SHIFT) & 1).sum())
        for x, y in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert groups > 0  # one batch within the cap, one past it


def _texts():
    pf = _script("profile_front_torch")
    pfin = _script("profile_finish_torch")
    return pf, pfin


def test_variant_texts_come_from_the_committed_sources():
    pf, pfin = _texts()
    front, finish = pf.committed("front.cu"), pfin.pf.committed("finish.cu")
    ft, kt = pf.variant_texts(), pfin.variant_texts()
    assert set(ft) == {"s", "d", "c", "h", "m", "l"}
    assert set(kt) == {"k", "s", "c", "f", "a1", "sort-always"}
    assert pf.rung_source("m", front) == front
    assert pfin.rung_source("f", finish) == finish
    assert ft["m"] == front + pf.OCCUPANCY
    assert kt["f"] == finish + pfin.OCCUPANCY
    assert len(set(ft.values())) == len(ft)
    assert len(set(kt.values())) == len(kt)
    head = "__device__ __forceinline__ void emit_rung("
    c_fn = pf.function_text(ft["c"], head, "c")
    h_fn = pf.function_text(ft["h"], head, "h")
    assert "xxh64_8" not in c_fn and "xxh64_8(fwd < rc ? fwd : rc)" in h_fn
    assert "win_valid" not in c_fn + h_fn and "mod_mode" not in h_fn
    assert "emit_rung(a, row + j" in ft["c"]
    assert "emit_window(a, row + j" not in ft["d"]
    assert "stage(sp, a.packed" not in ft["l"]
    assert "__reduce_xor_sync" in kt["k"] and "warp_bitonic_sort<NR>(key" \
        not in kt["k"].split("// The verdict of read b")[0].split(
            "finish_warp(")[-1]
    assert "if (!__all_sync(kFull, ordered))" not in kt["sort-always"]


FRONT_ANCHORS = ("ANCHOR_KERNEL", "ANCHOR_LOOP", "ANCHOR_LOOP_END",
                 "ANCHOR_EMIT_LOOP", "ANCHOR_STAGE_CODES")
FINISH_ANCHORS = ("ANCHOR_SORT", "ANCHOR_AFTER_SORT", "ANCHOR_WARP_END",
                  "ANCHOR_ONE_GENE_OUT", "ANCHOR_ONE_GENE_END",
                  "ANCHOR_WINNERS", "ANCHOR_KEY_COUNT", "ANCHOR_SORT_SKIP")


@pytest.mark.parametrize("how", ["removed", "doubled"])
@pytest.mark.parametrize("script,anchor", [
    *(("profile_front_torch", a) for a in FRONT_ANCHORS),
    ("profile_front_torch", "__device__ __forceinline__ void emit_window("),
    *(("profile_finish_torch", a) for a in FINISH_ANCHORS),
])
def test_a_missing_anchor_raises(monkeypatch, script, anchor, how):
    mod = _script(script)
    pf = mod if script == "profile_front_torch" else mod.pf
    text = getattr(mod, anchor, anchor)
    src = "front.cu" if script == "profile_front_torch" else "finish.cu"
    real = pf.committed(src)
    assert real.count(text) == 1
    broken = real.replace(text, "" if how == "removed" else text + text)
    monkeypatch.setattr(pf, "committed", lambda name: broken)
    with pytest.raises(pf.VariantError):
        mod.variant_texts()


def test_stage_profilers_load_without_jax():
    """The three scripts and what they bring import neither jax nor
    shark_tpu, nor bench.py or bench/."""
    code = (
        "import importlib.util, sys\n"
        f"for name in {SCRIPTS!r}:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, f'scripts/{name}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'shark_tpu', 'bench')); print(bad); "
        "sys.exit(bool(bad))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stdout + out.stderr
