"""K7a, the sharded Bloom filter's router, at its edges, against shark_tpu.

shark_tpu packs each source shard's probes for their owners by sorting
the keys owner * Pn + flat position (shark_tpu/parallel/sharded_bf.py
_route_probe_return, :195-237): within an owner the slots follow the
window's position, the probes past `cap` are dropped and counted, and
every slot no probe took holds 0xFFFFFFFF in both lanes. That part of
_route_probe_return runs inside its shard_map, between the owner split
and the first all_to_all, so it is copied here in numpy, step for step,
on shark_tpu's own shard_owner_local. The port's plain shard_route_plain
(what a CPU tensor runs, and what the card's kernel is held to) must give
the same send buffer, the same per-window slot and owner, and the same
overflow count, bit for bit, at the router's edges: one window, fewer
windows than one of the kernel's tiles and a count that is no multiple of
it, one shard and 1024, every window owned by one shard (with
overflow), a cap past every total (all of the buffer is tail), a cap of
8 with heavy overflow, every window invalid, and the wide (64-bit word)
split past 2^36 bits. Inputs are made with numpy from seeds."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from shark_tpu.parallel import sharded_bf as jsharded  # noqa: E402
from shark_tpu_torch.parallel import sharded_bf as tsharded  # noqa: E402

SENTINEL = 0xFFFFFFFF
WIDE_BITS = (1 << 37) + (5 << 33)

# name: (sources, reads a source, windows a read, shards, cap, windows)
CASES = {
    "one_window": (2, 1, 1, 8, 8, "random"),
    "under_one_tile": (1, 3, 88, 2, 200, "random"),
    "ragged_tiles": (3, 61, 88, 8, 800, "random"),
    "one_shard": (2, 40, 88, 1, 4000, "random"),
    "n64": (2, 100, 88, 64, 200, "random"),
    "n1024": (2, 64, 88, 1024, 8, "random"),
    "one_owner": (3, 50, 88, 8, 3000, "one_owner"),
    "all_tail": (2, 30, 88, 8, 2 * 30 * 88, "random"),
    "cap8": (2, 50, 88, 8, 8, "random"),
    "all_invalid": (2, 20, 88, 8, 64, "invalid"),
    "wide": (2, 50, 88, 8, 700, "wide"),
}


def _windows(case, seed):
    """(hi, lo u32[S, b, Ls], valid bool[S, b, Ls], n, wps, wide, cap)."""
    S, b, Ls, n, cap, kind = CASES[case]
    rng = np.random.default_rng(seed)
    wide = kind == "wide"
    wps = WIDE_BITS // 32 // n if wide else (1 << 20) + 3
    words = rng.integers(0, n * wps, size=(S, b, Ls), dtype=np.int64)
    if kind == "one_owner":
        words = 3 * wps + words % wps
    addr = words.astype(np.uint64) * np.uint64(32) + rng.integers(
        0, 32, size=words.shape).astype(np.uint64)
    valid = rng.random(words.shape) < 0.9
    if kind == "invalid":
        valid[:] = False
    hi = (addr >> np.uint64(32)).astype(np.uint32)
    lo = (addr & np.uint64(SENTINEL)).astype(np.uint32)
    return hi, lo, valid, n, wps, wide, cap


def shark_tpu_route(hi, lo, valid, *, n, wps, wide, cap):
    """shark_tpu's send buffer, per-window slot and owner, and overflow:
    its owner split, then _route_probe_return's sort, slot and pack
    (:195-237) for each source, in numpy."""
    S, b, Ls = lo.shape
    Pn = b * Ls
    owner, local, bit = (np.asarray(x) for x in jsharded.shard_owner_local(
        jnp.asarray(hi), jnp.asarray(lo), n=n, wps=wps, wide=wide))
    send = np.full((S, n, cap, 2), SENTINEL, np.uint32)
    slots = np.full((S, Pn), -1, np.int32)
    owners = np.where(valid, owner, -1).reshape(S, Pn).astype(np.int32)
    overflow = np.zeros(S, np.int32)
    for s in range(S):
        f_owner = owner[s].reshape(Pn).astype(np.int64)
        f_valid = valid[s].reshape(Pn)
        key = np.where(f_valid, f_owner * Pn + np.arange(Pn), n * Pn)
        skey = np.sort(key)
        s_owner, s_pos = skey // Pn, skey % Pn
        s_valid = s_owner < n
        idx = np.arange(Pn)
        prev = np.concatenate([[-1], s_owner[:-1]])
        seg_start = s_valid & (s_owner != prev)
        slot = idx - np.maximum.accumulate(np.where(seg_start, idx, 0))
        ok = s_valid & (slot < cap)
        overflow[s] = int((s_valid & (slot >= cap)).sum())
        pos = s_pos[ok]
        send[s, s_owner[ok], slot[ok], 0] = local[s].reshape(Pn)[pos]
        send[s, s_owner[ok], slot[ok], 1] = bit[s].reshape(Pn)[pos]
        slots[s, pos] = slot[ok]
    return send, slots.reshape(S, b, Ls), owners.reshape(S, b, Ls), overflow


@pytest.mark.parametrize("case", list(CASES))
def test_shard_route_plain_matches_shark_tpu_slot_order(case):
    hi, lo, valid, n, wps, wide, cap = _windows(case, seed=len(case))
    route = dict(n=n, wps=wps, wide=wide, cap=cap)
    want = shark_tpu_route(hi, lo, valid, **route)
    got = tsharded.shard_route_plain(torch.from_numpy(hi),
                                     torch.from_numpy(lo),
                                     torch.from_numpy(valid), **route)
    for name, g, w in zip(("send", "slot", "owner", "overflow"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    send, slot, _, overflow = want
    routed = int((slot >= 0).sum())
    tail = int((send[..., 0] == SENTINEL).sum())
    assert routed + tail == send.shape[0] * n * cap
    if case in ("one_owner", "cap8", "n1024"):
        assert (overflow > 0).all()
    if case == "all_tail":
        assert overflow.sum() == 0 and tail > routed
    if case == "all_invalid":
        assert routed == 0 and overflow.sum() == 0
