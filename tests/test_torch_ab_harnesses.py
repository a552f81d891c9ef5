"""The port's process-state, batch-size, table-layout and group-split
harnesses (scripts/*_torch.py), on the CPU at a tiny size.

bench_gpu.py's panel and homolog generators at 20 and 24 genes, 2000
reads, batches of 256-1024 reads, the -b unit shrunk to 2^22 bits
(config.BF_UNIT_BITS) in both packages; each script's main(argv,
device="cpu") runs the plain versions:
- scripts/ab_batch_torch.py writes the same ssv and FASTQ bytes and
  association count at every batch size, and each size's serial pass
  writes its passes' bytes;
- scripts/ab_layout_torch.py builds every variant (bucket counts pinned
  below and above the production one, 6 and 4 slots, entry8), and each
  gives through the plain probe the verdicts of the production
  Classifier; with jax, the verdicts of shark_tpu's Classifier on the
  same reads too;
- scripts/homolog_split_torch.py's per-batch counts equal a reference
  computation in numpy over shark_tpu's (tag, payload) windows of the same
  reads (with jax), and its impure count the port's plain group count;
- scripts/repro_contamination_torch.py prints every step, and every
  pass's bytes equal the first pass's;
- each of the four, and the K1 and K3 stage profilers and the FIX_CAP2
  A/B (tests/test_torch_stage_profiles.py), runs on the card unless
  --cpu is given: without a card it exits 1.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import bench_gpu
from shark_tpu_torch import config
from shark_tpu_torch.classify import step
from shark_tpu_torch.io import native
from test_torch_profile_e2e import _script
from test_torch_threads import one_torch_thread  # noqa: F401

READS = 2000
TINY = dict(N_GENES=20, HOMOLOG_GENES=24, BATCH=512)


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
    return ["--reads", str(READS), "--cache", str(tmp_path / "cache")]


def _line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("wl", ["panel", "homolog"])
def test_ab_batch_writes_equal_bytes_at_every_size(tiny, capsys, wl):
    rc = _script("ab_batch_torch").main(
        ["256", "512", "1024", "--workload", wl, *tiny], device="cpu")
    line = _line(capsys)
    assert rc == 0 and line["exact"] is True
    sizes = line["sizes"]
    assert [s["batch_size"] for s in sizes] == [256, 512, 1024]
    assert [s["batches"] for s in sizes] == [-(-READS // B)
                                            for B in (256, 512, 1024)]
    assert len({s["n_associations"] for s in sizes}) == 1
    assert sizes[0]["n_associations"] > 0
    assert len({tuple(s["digest"]) for s in sizes}) == 1
    assert all(s["serial_bytes_equal"] and s["bytes_equal_first"]
               for s in sizes)
    assert all(s["first_batch_parse_ms"] >= 0 for s in sizes)
    assert "max_memory_allocated_mb" not in sizes[0]  # no card
    assert line["device"] == "cpu"


def test_ab_layout_variants_give_the_production_verdicts(tiny, capsys):
    rc = _script("ab_layout_torch").main(["--batches", "2", *tiny],
                                         device="cpu")
    line = _line(capsys)
    assert rc == 0 and line["verdicts_equal"] is True
    built = [r for r in line["rows"] if r["buildable"]]
    assert all(r["verdicts_equal"] for r in built)
    prod = line["production"]
    assert (prod["entry"], prod["slots"]) == ("entry16", 8)
    lgbs = {r["lgB"] for r in built if r["entry"] == "entry16"
            and r["slots"] == 8}
    assert lgbs - {prod["lgB"]}, "no pinned bucket count besides production"
    assert line["natural_lgB"] in lgbs
    by_slots = {r["slots"]: r for r in built if "b_slots" in r["parts"]
                and r["lgB"] == prod["lgB"]}
    assert set(by_slots) == {8, 6, 4}
    assert by_slots[6]["route"] == "variant"
    assert by_slots[6]["table_mb"] == prod["table_mb"] * 6 / 8
    assert by_slots[4]["stash_real"] > by_slots[6]["stash_real"] > 0
    assert {r["lgB"] for r in built if r["entry"] == "entry8"} >= {
        line["natural_lgB"] - 1, line["natural_lgB"]}
    assert all("probe_device_ms" not in r for r in built)  # no card


def test_ab_layout_verdicts_equal_shark_tpu(tiny, monkeypatch):
    pytest.importorskip("jax")
    from shark_tpu import config as jconfig
    from shark_tpu.classify.step import Classifier as JClassifier
    from shark_tpu.index.structure import SharkIndex as JIndex

    monkeypatch.setattr(jconfig, "BF_UNIT_BITS", 1 << 22)
    al = _script("ab_layout_torch")
    al.pe.size_workloads(READS, tiny[-1])
    b = bench_gpu.Bench(torch.device("cpu"), float("inf"))
    cfg, clf = al.pe.workload_config(b, "panel")
    batches = al.first_batches(cfg, 2)
    fronts = al.fronts_of(clf, batches)
    _, cands = al.candidates(clf.index, clf, 3, [8, 6, 4], True)
    jclf = JClassifier(JIndex.load(os.path.join(bench_gpu.CACHE, "main",
                                                "index.d")),
                       max_winners=cfg.max_winners, c=cfg.c)
    want = [[np.asarray(x) for x in jclf.call_packed(p, v)[:3]]
            for p, v in batches]
    checked = 0
    for name, _, build in cands:
        built = build()
        if isinstance(built, str):
            continue
        lay = al.Layout(name, *built, clf.device)
        for got, ref in zip(al.verdicts(clf, lay, fronts), want):
            for x, y in zip(got, ref):
                np.testing.assert_array_equal(x.numpy(), y, err_msg=name)
        checked += 1
    assert checked >= 5


def _split_reference(codes, index, meta_rows_bits):
    """The split of homolog_split.py over shark_tpu's classic tags of
    `codes` (numpy)."""
    from test_torch_finish import shark_tpu_tags

    (tagv, payv, _), _, _ = shark_tpu_tags(index, codes)
    t, p = tagv.astype(np.int64), payv.astype(np.int64)
    is_row = t == step.TAG_ROW
    direct = (t == step.TAG_D1) | (t == step.TAG_D2)
    gid = p >> meta_rows_bits
    any_row, any_direct = is_row.any(1), direct.any(1)
    gmax = np.where(is_row, gid, -1).max(1)
    gmin = np.where(is_row, gid, 0x7FFFFFFF).min(1)
    pure = any_row & ~any_direct & (gmax == gmin)
    return {"row_reads": int(any_row.sum()), "pure": int(pure.sum()),
            "impure": int((any_row & ~pure).sum()),
            "direct_only": int((any_direct & ~any_row).sum()),
            "empty": int((~any_direct & ~any_row).sum()),
            "row_windows": int(is_row.sum()),
            "direct_windows": int(direct.sum())}


def test_homolog_split_counts_match_the_group_pass(tiny, capsys):
    hs = _script("homolog_split_torch")
    rc = hs.main(["--batch", "512", *tiny], device="cpu")
    line = _line(capsys)
    assert rc == 0 and line["probe"] == "hashed"
    batches = line["batches"]
    assert len(batches) == -(-READS // 512)
    for x in batches:
        assert x["pure"] + x["impure"] == x["row_reads"]
        assert (x["row_reads"] + x["direct_only"] + x["empty"]
                == x["reads"])
        assert (x["fix_cap"], x["fix_cap2"]) == step.fix_caps(512)
    assert line["total"]["pure"] > 0  # core reads tie across families
    assert line["total"]["reads"] == READS
    # the impure count is the finish's group pass count (plain version)
    b = bench_gpu.Bench(torch.device("cpu"), float("inf"))
    cfg, clf = hs.pe.workload_config(b, "homolog")
    ns = hs.pe.open_stream(cfg)
    try:
        packed, vmask, slot, n = ns.next_batch()
        tagv, payv, _, L = clf.tags(packed, vmask)
    finally:
        ns.close()
    n_fix = torch.zeros(1, dtype=torch.int32)
    step.finish_group_count(tagv, payv, n_fix, meta=clf._geometry(L)[0],
                            has_rows=clf._has_rows)
    assert int(n_fix) == batches[0]["impure"]


def test_homolog_split_equals_shark_tpu_tags(tiny, capsys, tmp_path,
                                             monkeypatch):
    pytest.importorskip("jax")
    from shark_tpu import config as jconfig
    from shark_tpu.index.structure import SharkIndex as JIndex

    from shark_tpu_torch.io.native import NativeStream

    monkeypatch.setattr(jconfig, "BF_UNIT_BITS", 1 << 22)
    hs = _script("homolog_split_torch")
    assert hs.main(["--batch", "512", *tiny], device="cpu") == 0
    got = _line(capsys)["batches"]
    b = bench_gpu.Bench(torch.device("cpu"), float("inf"))
    cfg, clf = hs.pe.workload_config(b, "homolog")
    clf.index.save(str(tmp_path / "homolog.d"))
    jindex = JIndex.load(str(tmp_path / "homolog.d"))
    rows_bits = step.StaticMeta.for_index(clf.index, 104).rows_bits
    assert rows_bits > 0
    ns = NativeStream(cfg.sample1_path, "", 512, cfg.max_read_len, 0)
    try:
        for x in got:
            codes, slot, n = ns.next_batch()
            want = _split_reference(np.array(codes[:n]), jindex, rows_bits)
            ns.release(slot)
            assert {k: x[k] for k in want} == want
    finally:
        ns.close()


def test_repro_contamination_prints_every_step(tiny, capsys):
    rc = _script("repro_contamination_torch").main(tiny, device="cpu")
    line = _line(capsys)
    assert rc == 0 and line["bytes_equal"] is True
    steps = line["steps"]
    assert list(steps) == ["before", "stage", "after", "after-gc",
                           "after-sync"]
    assert {"serial_before", "serial_before2"} <= set(steps["before"])
    for name in ("before", "after", "after-gc", "after-sync"):
        s = steps[name]
        assert len(s["overlapped_reads_per_sec"]) == 3
        assert s[f"serial_{name}"]["serial_total_s"] > 0
        for key in ("python_threads", "native_threads", "gc_count",
                    "dirty_mb", "writeback_mb", "loadavg", "rss_mb"):
            assert key in s["diag"], key
    assert steps["stage"]["workload"] == "panel"
    assert steps["stage"]["n_associations"] > 0
    assert set(line["reads_per_sec_best"]) == {"before", "after",
                                              "after-gc", "after-sync"}
    assert isinstance(line["moved"], dict)


@pytest.mark.parametrize("name", ["ab_batch_torch", "ab_layout_torch",
                                  "homolog_split_torch",
                                  "repro_contamination_torch",
                                  "profile_front_torch",
                                  "profile_finish_torch", "ab_fixcap_torch"])
def test_harness_without_a_card_exits_1(name, monkeypatch, capsys):
    # each runs on cuda:0 unless --cpu is given, and never falls back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _script(name).main([]) == 1
    assert "no CUDA card" in capsys.readouterr().err
