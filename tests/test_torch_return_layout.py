"""K7c, the sharded Bloom filter's return, on both reply layouts, against
shark_tpu.

shark_tpu sends each owner's replies back through an all_to_all and
scatters them to their windows (shark_tpu/parallel/sharded_bf.py
_route_probe_return, :252-263) before decode_pay_words. The port's
shard_return gathers each window's reply where it lies: in a contiguous
[source, owner] buffer (what an exchange between devices copies) or in
place, in the owner probe's [owner, source] replies transposed (what the
shards of one device exchange, a view). On CPU tensors the wrapper and
its plain version must give the same (tag, payload) on both layouts, and
shark_tpu's values: its slot order (a numpy copy of its sort, from
tests/test_torch_route_edges.py) and its decode_pay_words, at a window
count per source that is 0, 1, 2 and 3 mod 4, under 4, a batch where no
window gets a slot, one whose probes overflow the cap, one shard, and one
window. The wrapper refuses replies whose last two strides are not
(2, 1). Through ShardedBFClassifier on ["cpu"] * n the return reads the
owner probe's replies in place, and on two devices a copy, and all five
outputs equal shark_tpu's on the workloads of tests/test_sharded_bf.py.
Inputs are made with numpy from seeds; every comparison is exact.

return_inputs (no jax) is shared with the card tests of
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from shark_tpu_torch.parallel import sharded_bf as tsharded

WPS = (1 << 20) + 3
# name: (sources S, reads a source b, windows a read Ls, shards n, cap, kind)
CASES = {
    "pn_mod0": (2, 8, 88, 8, 200, "random"),  # Pn = 704
    "pn_mod1": (3, 5, 73, 8, 100, "random"),  # Pn = 365; S * Pn % 4 = 3
    "pn_mod2": (3, 2, 73, 4, 60, "random"),  # Pn = 146
    "pn_mod3": (3, 1, 75, 2, 80, "random"),  # Pn = 75
    "pn_under4": (3, 1, 3, 2, 8, "random"),  # Pn = 3
    "no_slot": (2, 8, 88, 8, 64, "invalid"),
    "overflow": (2, 8, 88, 8, 16, "random"),
    "one_shard": (2, 8, 88, 1, 800, "random"),
    "one_window": (1, 1, 1, 1, 8, "random"),
}


def return_inputs(case, seed):
    """(hi, lo, valid u32/bool [S, b, Ls] windows, reply u32 [n, S, cap,
    2] as the owner probe gives it (random words: every tag), and the
    plain router's owner and slot i32 [S, b, Ls]), on the CPU."""
    S, b, Ls, n, cap, kind = CASES[case]
    rng = np.random.default_rng(seed)
    words = rng.integers(0, n * WPS, size=(S, b, Ls), dtype=np.int64)
    addr = words.astype(np.uint64) * np.uint64(32) + rng.integers(
        0, 32, size=words.shape).astype(np.uint64)
    valid = rng.random(words.shape) < 0.9
    if kind == "invalid":
        valid[:] = False
    hi = (addr >> np.uint64(32)).astype(np.uint32)
    lo = (addr & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    _, slot, owner, _ = tsharded.shard_route_plain(
        torch.from_numpy(hi), torch.from_numpy(lo), torch.from_numpy(valid),
        n=n, wps=WPS, wide=False, cap=cap)
    reply = torch.from_numpy(rng.integers(
        0, 1 << 32, size=(n, S, cap, 2), dtype=np.uint64).astype(np.uint32))
    return hi, lo, valid, reply, owner, slot


def _layouts(reply):
    """The reply as the return reads it on one device (a view) and as a
    copy between devices delivers it (contiguous)."""
    view = reply.transpose(0, 1)
    return view, view.contiguous()


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("case", list(CASES))
def test_return_layouts_match_shark_tpu(case):
    jnp = pytest.importorskip("jax.numpy")
    from shark_tpu.classify.step import decode_pay_words
    from test_torch_route_edges import shark_tpu_route

    S, b, Ls, n, cap, kind = CASES[case]
    hi, lo, valid, reply, owner, slot = return_inputs(case, seed=len(case))
    view, contig = _layouts(reply)
    assert not view.is_contiguous() or n == 1 or S == 1
    want = tsharded.shard_return_plain(contig, owner, slot)
    for back in (view, contig):
        _equal(tsharded.shard_return(back, owner, slot), want)
        _equal(tsharded.shard_return_plain(back, owner, slot), want)
    # shark_tpu: its slot order, its scatter of back[owner, slot] to each
    # routed window, zeros elsewhere, then its decode
    _, j_slot, j_owner, j_ovf = shark_tpu_route(hi, lo, valid, n=n, wps=WPS,
                                                wide=False, cap=cap)
    np.testing.assert_array_equal(slot.numpy(), j_slot)
    back = contig.numpy()
    ok = j_slot >= 0
    src = np.broadcast_to(np.arange(S)[:, None, None], ok.shape)
    pw = np.zeros(ok.shape + (2,), np.uint32)
    pw[ok] = back[src[ok], j_owner[ok], j_slot[ok]]
    tagv, payv = decode_pay_words(jnp.asarray(pw[..., 0]),
                                  jnp.asarray(pw[..., 1]))
    _equal(want, (tagv, payv))
    if kind == "invalid":
        assert not ok.any() and not want[0].numpy().any()
    if case == "overflow":
        assert (j_ovf > 0).all()
    else:
        assert j_ovf.sum() == 0
    if ok.sum() >= 64:
        assert set(np.unique(np.asarray(tagv)[ok])) == {0, 1, 2, 3}


@pytest.mark.parametrize("bad", ["minor_transposed", "wide_rows",
                                 "odd_offset"])
def test_return_refuses_other_strides(bad):
    """Replies whose last two strides are not (2, 1), or whose 8-byte
    rows are not aligned, raise on the CPU as on the card."""
    _, _, _, reply, owner, slot = return_inputs("pn_mod0", seed=3)
    back = reply.transpose(0, 1).contiguous()
    S, n, cap, _ = back.shape
    if bad == "minor_transposed":
        back = back.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "wide_rows":
        wide = torch.zeros((S, n, cap, 4), dtype=torch.uint32)
        wide[..., :2] = back
        back = wide[..., :2]
    else:
        flat = torch.zeros(back.numel() + 1, dtype=torch.uint32)
        flat[1:] = back.reshape(-1)
        back = flat[1:].view(S, n, cap, 2)
    assert torch.equal(back, reply.transpose(0, 1))
    with pytest.raises(ValueError, match="shard_return"):
        tsharded.shard_return(back, owner, slot)


@pytest.mark.parametrize("n,wide,devices", [
    (8, False, "one"), (8, True, "one"), (1, False, "one"),
    (8, False, "two")])
def test_classifier_reads_replies_in_place(workload, jax_results, n, wide,
                                           devices, monkeypatch):
    """One device: the return gets the owner probe's replies transposed,
    a view of the same memory (no copy); two devices: a contiguous copy.
    All five outputs equal shark_tpu's either way."""
    pytest.importorskip("jax")
    from test_torch_sharded import _assert_equal, _port

    index, codes = workload
    seen = {}
    probe, ret = tsharded.shard_probe, tsharded.shard_return

    def shard_probe(recv, bf_rank, pay):
        seen.setdefault("replies", []).append(probe(recv, bf_rank, pay))
        return seen["replies"][-1]

    def shard_return(back, owner, slot):
        seen.setdefault("backs", []).append(back)
        return ret(back, owner, slot)
    monkeypatch.setattr(tsharded, "shard_probe", shard_probe)
    monkeypatch.setattr(tsharded, "shard_return", shard_return)
    devs = ["cpu"] * n if devices == "one" else ["cpu", "cpu:0"] * (n // 2)
    clf = tsharded.ShardedBFClassifier(_port(index), max_winners=8, c=0.6,
                                       devices=devs, force_wide=wide)
    _assert_equal(clf(codes), jax_results[n, wide])
    reply, back = seen["replies"][0], seen["backs"][0]
    if devices == "one":
        assert len(seen["backs"]) == 1
        assert back.data_ptr() == reply.data_ptr()
        assert back.stride() == reply.transpose(0, 1).stride()
        assert not back.is_contiguous() or n == 1
    else:
        assert len(seen["backs"]) == 2 and back.is_contiguous()
        assert back.data_ptr() != reply.data_ptr()


@pytest.fixture(scope="module")
def workload():
    pytest.importorskip("jax")
    from test_sharded_bf import workload as make

    return make.__wrapped__()


@pytest.fixture(scope="module")
def jax_results(workload):
    from test_torch_sharded import jax_results as make

    return make.__wrapped__(workload)
