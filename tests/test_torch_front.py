"""K1, the front end of shark_tpu_torch, against shark_tpu's.

The port's plain PyTorch front end (front_end on CPU tensors: planar
unpack, canonical k-mers, XXH64, mod Bloom size, window slice, read
length) must equal shark_tpu.classify.step.unpack_codes + bloom_positions
bit for bit: the same inputs, made with numpy from a seed, go through
both. The CUDA kernel (csrc/front.cu) is held against this plain version
on the card by chip_smoke.py."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from shark_tpu.classify import step as jstep  # noqa: E402
from shark_tpu_torch.classify import step as tstep  # noqa: E402
from shark_tpu_torch.ops.xxh64 import xxh64_int, xxh64_torch  # noqa: E402
from test_xxh64 import VECTORS  # noqa: E402

SIZES = [1 << 30, 1 << 33, 3 << 33]  # the three _mod_size cases


def planar_pack(codes: np.ndarray):
    """u8[B, L] codes (4 = invalid) -> the planar (packed, vmask) pair of
    shark_tpu.classify.step.unpack_codes."""
    B, L = codes.shape
    valid = codes < 4
    c = np.where(valid, codes, 0).astype(np.uint8)
    packed = np.zeros((B, L // 4), np.uint8)
    vmask = np.zeros((B, L // 8), np.uint8)
    for r in range(4):
        packed |= c[:, r * (L // 4):(r + 1) * (L // 4)] << (2 * r)
    for r in range(8):
        vmask |= valid[:, r * (L // 8):(r + 1) * (L // 8)].astype(np.uint8) << r
    return packed, vmask


def random_codes(rng, B: int, L: int) -> np.ndarray:
    """Reads of random lengths with Ns, padded with invalid codes."""
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.03] = 4  # Ns
    lens = rng.integers(0, L + 1, size=B)
    codes[np.arange(L)[None, :] >= lens[:, None]] = 4  # padding
    return codes


class _Meta:
    def __init__(self, k, size_bits):
        self.k = k
        self.size_bits = size_bits


@pytest.mark.parametrize("size_bits", SIZES)
@pytest.mark.parametrize("k", [11, 15, 17, 31])
def test_front_end_matches_shark_tpu(k, size_bits):
    rng = np.random.default_rng(1000 * k + size_bits % 997)
    B, L = 24, 104
    packed, vmask = planar_pack(random_codes(rng, B, L))
    meta = _Meta(k, size_bits)
    codes_j = jstep.unpack_codes(jnp.asarray(packed), jnp.asarray(vmask))
    want_hi, want_lo, want_valid = (
        np.asarray(x) for x in jstep.bloom_positions(codes_j, meta)
    )
    want_len = np.asarray((codes_j < 4).sum(axis=1))
    hi, lo, valid, length = tstep.front_end(
        torch.from_numpy(packed), torch.from_numpy(vmask), meta
    )
    assert hi.dtype == torch.uint32 and lo.dtype == torch.uint32
    np.testing.assert_array_equal(hi.numpy(), want_hi)
    np.testing.assert_array_equal(lo.numpy(), want_lo)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    np.testing.assert_array_equal(length.numpy(), want_len)
    assert want_valid.any() and not want_valid.all()


def test_pack_codes_inverts_unpack():
    rng = np.random.default_rng(3)
    codes = random_codes(rng, 16, 208)
    packed, vmask = planar_pack(codes)
    tp, tv = tstep.pack_codes(torch.from_numpy(codes))
    np.testing.assert_array_equal(tp.numpy(), packed)
    np.testing.assert_array_equal(tv.numpy(), vmask)
    np.testing.assert_array_equal(
        tstep.unpack_codes(tp, tv).numpy(), codes
    )


def test_xxh64_twin_known_answers():
    keys = [key for key, _ in VECTORS]
    # int64 bit patterns of the u64 keys
    x = torch.tensor([k - (1 << 64) if k >= 1 << 63 else k for k in keys])
    got = [int(h) & ((1 << 64) - 1) for h in xxh64_torch(x)]
    assert got == [h for _, h in VECTORS]
    assert got == [xxh64_int(k) for k in keys]


def test_fastmod_magic_matches_division():
    """The front end kernel reduces the hash's high word modulo d =
    size >> 32 as ((magic * a mod 2**64) * d) >> 64; that must equal
    a - (a // d) * d for every 32-bit a and divisor. Checked over divisors
    1..3000, the powers of two and their neighbours, and random 32-bit
    divisors, each at word edges, multiples of d and their neighbours,
    and random words."""
    rng = np.random.default_rng(8)
    top = (1 << 32) - 1
    divisors = list(range(1, 3001))
    divisors += [(1 << s) + e for s in range(1, 32) for e in (-1, 0, 1)]
    divisors += [int(d) for d in rng.integers(1, 1 << 32, size=2000)] + [top]
    for d in divisors:
        magic = tstep._fastmod_magic(d)
        assert 0 <= magic < 1 << 64
        q = top // d
        words = [0, 1, d - 1, d, d + 1, top - 1, top, q * d, q * d - 1]
        words += [int(a) for a in rng.integers(0, 1 << 32, size=8)]
        for a in words:
            if 0 <= a <= top:
                assert ((magic * a) & ((1 << 64) - 1)) * d >> 64 == \
                    a - (a // d) * d, (a, d)


def test_mod_size_rejects_other_sizes():
    with pytest.raises(ValueError):
        tstep._mod_size_params(3 << 20)
