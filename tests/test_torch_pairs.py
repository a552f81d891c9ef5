"""K4, extract_pairs of shark_tpu_torch, against shark_tpu's.

The port's plain version (a sort of the masked key matrix, as in
shark_tpu) must give shark_tpu's stream bit for bit, including the
sentinel-colliding pair (row 65535, gene 65535) of a full 65536-read
batch. The CUDA kernel (csrc/pairs.cu: count, scan, scatter) is held
against it on the card by chip_smoke.py."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from shark_tpu.classify import step as jstep  # noqa: E402
from shark_tpu_torch.classify import step as tstep  # noqa: E402


def random_verdicts(rng, B: int, W: int, n_genes: int = 5000):
    """Packed verdicts and ascending winner lists with every flag the
    stream must exclude (overflow, group, saturated, nw > W, not emitted)."""
    nw = rng.integers(0, W + 3, size=B)
    nw[rng.random(B) < 0.05] = 31
    emit = rng.random(B) < 0.8
    ovf = rng.random(B) < 0.05
    grp = rng.random(B) < 0.05
    winners = np.full((B, W), -1, np.int32)
    for r in range(B):
        m = min(int(nw[r]), W)
        winners[r, :m] = np.sort(rng.choice(n_genes, size=m, replace=False))
    packed = (
        np.maximum(winners[:, 0], 0)
        | (np.minimum(nw, 31) << 16)
        | (emit.astype(np.int64) << 21)
        | (ovf.astype(np.int64) << 22)
        | (grp.astype(np.int64) << 23)
    ).astype(np.int32)
    return packed, winners


def run_both(packed, winners, cap):
    want = np.asarray(
        jstep.extract_pairs(jnp.asarray(packed), jnp.asarray(winners), cap)
    )
    got = tstep.extract_pairs(
        torch.from_numpy(packed), torch.from_numpy(winners), cap
    )
    assert got.dtype == torch.uint32
    return want, got.numpy()


@pytest.mark.parametrize("B,W,cap", [(512, 8, 1 << 14), (300, 16, 256)])
def test_extract_pairs_matches_shark_tpu(B, W, cap):
    rng = np.random.default_rng(B + W)
    packed, winners = random_verdicts(rng, B, W)
    want, got = run_both(packed, winners, cap)
    assert want.shape == got.shape == (min(cap, B * W),)
    np.testing.assert_array_equal(got, want)
    assert (got != jstep.PAIR_SENTINEL).sum() > 0


def test_extract_pairs_sentinel_collision_batch():
    """The batch of test_homology.test_pair_sentinel_collision_boundary:
    65536 reads, only the last one emitted, tied across genes 65534 and
    65535; its second pair encodes to the sentinel itself."""
    B, W = 65536, 8
    packed = np.zeros(B, np.int32)
    winners = np.full((B, W), -1, np.int32)
    winners[B - 1, :2] = [65534, 65535]
    packed[B - 1] = 65534 | (2 << 16) | (1 << 21)
    want, got = run_both(packed, winners, 1 << 14)
    np.testing.assert_array_equal(got, want)
    assert got[0] == (65535 << 16) | 65534
    assert got[1] == jstep.PAIR_SENTINEL


def test_extract_pairs_rejects_large_batches():
    with pytest.raises(ValueError):
        tstep.extract_pairs(
            torch.zeros(65537, dtype=torch.int32),
            torch.zeros((65537, 2), dtype=torch.int32), 16,
        )
