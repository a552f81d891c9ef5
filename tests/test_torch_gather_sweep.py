"""The gather-rate sweep (scripts/gather_sweep_torch.py) and the bare row
gathers it times (shark_tpu_torch/floors.py, csrc/floors/gathers.cu).

On the CPU: every row width's plain gather equals a numpy xor fold of the
rows; the sweep's index draw is fixed by its seed; main(argv,
device="cpu") at a tiny size gives every (size, width, order) row with
the gather equal to its plain version and no device number. Marked
`cuda` (skipped without a card): the 4-, 64- and 128-byte gathers (and
the older widths) equal their plain versions on the card, also on a
table past 2^31 bytes, read at its last rows.
"""

import json

import numpy as np
import pytest
import torch

from shark_tpu_torch import floors
from test_torch_profile_e2e import _script


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _fold(words, idx):
    return np.bitwise_xor.reduce(words[idx], axis=1)


@pytest.mark.parametrize("row_bytes", floors.ROW_BYTES)
def test_plain_gather_folds_each_width(row_bytes):
    rng = np.random.default_rng(row_bytes)
    words = rng.integers(0, 1 << 32, size=(97, row_bytes // 4),
                         dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, 97, size=300).astype(np.int32)
    got = floors.rows(torch.from_numpy(words.view(np.int32)),
                      torch.from_numpy(idx), row_bytes)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(
        got.view(torch.int32).numpy().view(np.uint32), _fold(words, idx))


def test_index_draw_is_fixed_by_its_seed():
    gs = _script("gather_sweep_torch")
    a = gs.draw_indices(1000, 5000, 7, "cpu")
    assert a.dtype == torch.int32 and a.shape == (5000,)
    assert int(a.min()) >= 0 and int(a.max()) < 1000
    assert torch.equal(a, gs.draw_indices(1000, 5000, 7, "cpu"))
    assert not torch.equal(a, gs.draw_indices(1000, 5000, 8, "cpu"))
    t = gs.make_table(1 << 12, 3, "cpu")
    assert t.numel() == 1 << 10
    assert torch.equal(t, gs.make_table(1 << 12, 3, "cpu"))


def test_sweep_main_on_the_cpu(capsys):
    gs = _script("gather_sweep_torch")
    rc = gs.main(["--sizes-mb", "1", "2", "--n", "2048", "--reps", "1"],
                 device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["all_equal_plain"] is True
    assert line["device"] == "cpu"
    rows = line["rows"]
    assert len(rows) == 2 * len(floors.ROW_BYTES) * 2
    assert {(r["size_mb"], r["width"], r["order"]) for r in rows} == {
        (s, w, o) for s in (1, 2) for w in floors.ROW_BYTES
        for o in ("random", "sorted")}
    assert all(r["cpu_ms"] > 0 and "device_ms" not in r for r in rows)
    assert line["summary"] == {}  # no device rate on the CPU


def test_sweep_without_a_card_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _script("gather_sweep_torch").main(["--sizes-mb", "1"]) == 1
    assert "no CUDA card" in capsys.readouterr().err


@pytest.mark.cuda
@pytest.mark.parametrize("row_bytes", floors.ROW_BYTES)
def test_gathers_equal_plain_on_the_card(cuda, row_bytes):
    g = torch.Generator(device=cuda)
    g.manual_seed(row_bytes)
    table = torch.empty(3 << 20, dtype=torch.int32, device=cuda).random_(
        generator=g)
    rows = table.numel() * 4 // row_bytes
    idx = torch.randint(0, rows, (100_003,), generator=g, device=cuda,
                        dtype=torch.int32)
    for ix in (idx, torch.sort(idx).values):
        got = floors.rows(table, ix, row_bytes)
        torch.cuda.synchronize()
        assert torch.equal(got, floors.rows_plain(table, ix, row_bytes))


@pytest.mark.cuda
@pytest.mark.parametrize("row_bytes", [4, 64, 128])
def test_gathers_read_a_table_past_2_31_bytes(cuda, row_bytes):
    nbytes = (9 << 28)  # 2.25 GiB
    table = torch.empty(nbytes // 4, dtype=torch.int32, device=cuda)
    table.copy_(torch.arange(table.numel(), dtype=torch.int32,
                             device=cuda))
    rows = nbytes // row_bytes
    idx = torch.cat([torch.arange(rows - 1000, rows, device=cuda),
                     torch.randint(0, rows, (10_000,), device=cuda)]).to(
        torch.int32)
    got = floors.rows(table, idx, row_bytes)
    torch.cuda.synchronize()
    assert torch.equal(got, floors.rows_plain(table, idx, row_bytes))
