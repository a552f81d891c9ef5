"""The port's K2, K6 and K5 stage profilers and the dedup's price
(scripts/profile_probe_torch.py, profile_txome_torch.py,
sort_bench_torch.py), on the CPU at a tiny size.

bench_gpu.py's panel, homolog and txome generators at 20, 24 and 40
genes, 2000 reads, batches of 512, the -b unit shrunk to 2^22 bits
(config.BF_UNIT_BITS):
- each script's --cpu run prints its JSON line with every check true
  (the probe ladder on the panel with the classic/hashed A/B and on the
  homolog; the txome's with its XL_SLOTS = 2 build; the sort bench at
  2^17 positions);
- every variant text is made from the committed csrc/probe.cu, xl.cu and
  classic.cu with each anchor found once, and the top rungs' texts (p, s,
  y) are the committed sources; a source without an anchor, or with one
  twice, makes variant_texts() raise;
- the XL_SLOTS = 2 build restores hashed.XL_SLOTS, also when it raises;
- the three scripts, and the modules of the repository they import,
  import neither jax nor shark_tpu, nor bench/ (a source scan);
- without a card and without --cpu, each script exits 1.
"""

import ast
import os

import pytest

from shark_tpu_torch.classify import hashed
from test_torch_profile_e2e import _script
from test_torch_stage_profiles import _line, tiny  # noqa: F401
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("profile_probe_torch", "profile_txome_torch", "sort_bench_torch")


@pytest.mark.parametrize("script,argv", [
    ("profile_probe_torch", ["--ab"]),
    ("profile_probe_torch", ["--workload", "homolog"]),
    ("profile_txome_torch", []),
    ("sort_bench_torch", ["--n", str(1 << 17)]),
], ids=["probe-panel-ab", "probe-homolog", "txome", "sort"])
def test_cpu_line(tiny, capsys, script, argv):  # noqa: F811
    rc = _script(script).main([*argv, *tiny])
    line = _line(capsys)
    assert rc == 0 and line["checks"]
    assert all(v is True for v in line["checks"].values()), line["checks"]
    assert line["device"] == "cpu"
    if script == "profile_probe_torch":
        c = line["counts"]
        assert (line["batch_size"], line["windows_a_read"]) == (512, 88)
        assert c["windows"] == 512 * 88 and c["stash_rows"] <= 32
        b = [line["rungs"][r]["bound_ms"] for r in ("w", "b", "m", "p")]
        assert b == sorted(b) and b[0] > 0
        assert all("device_ms" not in r for r in line["rungs"].values())
        if "ab" in line:
            assert list(line["ab"]["setups"]) == [
                "classic_L128", "classic_L104", "hashed_L104"]
        else:  # the homolog: its degree-8 core spans two lanes
            assert c["two_lane_windows"] > c["valid_windows"] // 4
    elif script == "profile_txome_torch":
        xl = line["xl"]
        assert xl["counts"]["side_windows"] > 0 and xl["has_side"]
        assert set(xl["rungs"]) == {"g", "x", "s"}
        assert set(line["classic"]["rungs"]) == {"r", "y"}
        assert line["slots2"]["slots2_buildable"]
        assert line["slots2"]["lgB"] == xl["lgB"] + 1
    else:
        assert line["n"] == 1 << 17 and line["distinct"] > 0
        assert "panel_k2" in line and "dedup_ms" not in line


def _texts():
    return _script("profile_probe_torch"), _script("profile_txome_torch")


def test_variant_texts_come_from_the_committed_sources():
    pp, pt = _texts()
    probe = pp.pf.committed("probe.cu")
    xl, k5 = pp.pf.committed("xl.cu"), pp.pf.committed("classic.cu")
    kt = pp.variant_texts()
    xt, ct = pt.variant_texts()
    assert set(kt) == {"w", "b", "m", "p"}
    assert set(xt) == {"g", "x", "s", "slots2"} and set(ct) == {"r", "y"}
    assert kt["p"] == probe + pp.OCCUPANCY
    assert xt["s"] == xl + pt.XL_OCCUPANCY
    assert ct["y"] == k5 + pt.K5_OCCUPANCY
    for texts in (kt, xt, ct):
        assert len(set(texts.values())) == len(texts)
    for r in ("w", "b", "m"):
        assert "n_real = 0;" in kt[r]
    assert "stash_slot(lo, hi" not in kt["b"] and "row[q]" not in kt["w"]
    assert "has_side = 0;" in xt["x"] and "has_side = 0;" in xt["g"]
    assert "kRestMask" not in xt["g"].split("probe_xl_kernel(")[1].split(
        "extern")[0]
    assert "load_row8(" in xt["slots2"] and "s < 2; ++s" in xt["slots2"]
    assert "pay[wr.y" not in ct["r"] and pt.ANCHOR_K5_MISS not in ct["r"]


ANCHORS = [
    *(("profile_probe_torch", "probe.cu", a) for a in (
        "ANCHOR_LOADS", "ANCHOR_MATCH", "ANCHOR_KERNEL_END", "ANCHOR_ENTRY")),
    *(("profile_txome_torch", "xl.cu", a) for a in (
        "ANCHOR_XL_MATCH", "ANCHOR_XL_STORE", "ANCHOR_XL_ENTRY",
        "ANCHOR_XL_KERNEL", "ANCHOR_XL_LOAD", "ANCHOR_XL_SLOTS")),
    *(("profile_txome_torch", "classic.cu", a) for a in (
        "ANCHOR_K5_MISS", "ANCHOR_K5_PAY", "ANCHOR_K5_OUT", "ANCHOR_K5_END")),
]


@pytest.mark.parametrize("how", ["removed", "doubled"])
@pytest.mark.parametrize("script,src,anchor", ANCHORS)
def test_a_missing_anchor_raises(monkeypatch, script, src, anchor, how):
    mod = _script(script)
    pf = mod.pf
    text = getattr(mod, anchor)
    real = pf.committed
    assert real(src).count(text) == 1
    broken = real(src).replace(text, "" if how == "removed" else text * 2)
    monkeypatch.setattr(pf, "committed",
                        lambda name: broken if name == src else real(name))
    with pytest.raises(pf.VariantError):
        mod.variant_texts()


def test_slots2_build_restores_xl_slots(monkeypatch):
    pt = _script("profile_txome_torch")
    seen = []

    def build(index):
        seen.append(hashed.XL_SLOTS)
        raise MemoryError("refused")
    monkeypatch.setattr(hashed, "build_hashed_xl", build)
    with pytest.raises(MemoryError):
        pt.build_slots2(None)
    assert seen == [2] and hashed.XL_SLOTS == 4
    monkeypatch.setattr(hashed, "build_hashed_xl",
                        lambda index: seen.append(hashed.XL_SLOTS))
    assert pt.build_slots2(None) is None  # refused: recorded, not raised
    assert seen == [2, 2] and hashed.XL_SLOTS == 4


def _imports(path):
    """(line, top-level name) of every absolute import in the file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def test_probe_profilers_import_no_jax():
    """The three scripts and every module of the repository's root and
    scripts/ that they import, followed through, name neither jax nor
    shark_tpu, nor bench.py or bench/ (shark_tpu_torch/ itself is
    tests/test_torch_isolation.py's). A source scan: a process of its own
    that imports them would spend its time importing torch."""
    dirs = (ROOT, os.path.join(ROOT, "scripts"))
    todo = [os.path.join(dirs[1], f"{n}.py") for n in SCRIPTS]
    seen = set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for line, name in _imports(path):
            assert name not in ("jax", "jaxlib", "shark_tpu", "bench"), (
                f"{path}:{line} imports {name}")
            todo += [p for p in (os.path.join(d, f"{name}.py") for d in dirs)
                     if os.path.exists(p)]
    names = {os.path.basename(p) for p in seen}
    assert {"bench_gpu.py", "chip_smoke.py", "profile_front_torch.py",
            "profile_e2e_torch.py"} <= names


def test_without_a_card_the_scripts_exit_1(monkeypatch, capsys):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    for name in SCRIPTS:
        assert _script(name).main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and out.err.count("no CUDA card") == len(SCRIPTS)
