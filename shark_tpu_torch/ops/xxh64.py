"""Bit-exact XXH64 of a single 8-byte little-endian key, seed 0.

This is the only hash the pipeline needs: the reference hashes each packed
canonical k-mer as XXH64(&kmer, 8, 0) (reference: kmer_utils.hpp:81-83). For
len == 8 and seed == 0 the XXH64 algorithm (reference: xxhash.hpp:427-433,
449-453, 487-489) reduces to:

    h  = PRIME5 + 8
    k1 = rotl64(x * PRIME2, 31) * PRIME1
    h ^= k1
    h  = rotl64(h, 27) * PRIME1 + PRIME4
    h ^= h >> 33;  h *= PRIME2;  h ^= h >> 29;  h *= PRIME3;  h ^= h >> 32

Three implementations: a torch int64 version (the plain twin of shark_tpu's
limb-pair xxh64_u64; the CUDA front-end kernel uses native 64-bit integers),
a vectorized numpy uint64 version for the host index builder / oracle, and a
scalar Python one as the test oracle.
"""

from __future__ import annotations

import numpy as np
import torch

PRIME1 = 11400714785074694791
PRIME2 = 14029467366897019727
PRIME3 = 1609587929392839161
PRIME4 = 9650029242287828579
PRIME5 = 2870177450012600261

_MASK64 = (1 << 64) - 1
_H_INIT = (PRIME5 + 8) & _MASK64


def _i64(v: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def shr64(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64 (0 < s < 64): torch's
    `>>` on int64 is arithmetic, so the sign-extended bits are masked."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _rotl64(x: torch.Tensor, s: int) -> torch.Tensor:
    return (x << s) | shr64(x, 64 - s)


def xxh64_torch(x: torch.Tensor) -> torch.Tensor:
    """XXH64 (seed 0) of 8-byte keys held as int64 bit patterns; returns
    the u64 hash bits as int64. Elementwise. int64 multiplication wraps
    mod 2**64, which is the arithmetic XXH64 needs."""
    x = x.to(torch.int64)
    k1 = _rotl64(x * _i64(PRIME2), 31) * _i64(PRIME1)
    h = _i64(_H_INIT) ^ k1
    h = _rotl64(h, 27) * _i64(PRIME1) + _i64(PRIME4)
    h = h ^ shr64(h, 33)
    h = h * _i64(PRIME2)
    h = h ^ shr64(h, 29)
    h = h * _i64(PRIME3)
    h = h ^ shr64(h, 32)
    return h


def _rotl_np(x: np.ndarray, s: int) -> np.ndarray:
    s64 = np.uint64(s)
    inv = np.uint64(64 - s)
    return (x << s64) | (x >> inv)


def xxh64_np(x: np.ndarray) -> np.ndarray:
    """Host numpy XXH64 of 8-byte key(s), seed 0. x: uint64 array."""
    x = np.asarray(x, dtype=np.uint64)
    p1 = np.uint64(PRIME1)
    p2 = np.uint64(PRIME2)
    p3 = np.uint64(PRIME3)
    p4 = np.uint64(PRIME4)
    k1 = _rotl_np(x * p2, 31) * p1
    h = np.uint64(_H_INIT) ^ k1
    h = _rotl_np(h, 27) * p1 + p4
    h ^= h >> np.uint64(33)
    h *= p2
    h ^= h >> np.uint64(29)
    h *= p3
    h ^= h >> np.uint64(32)
    return h


def xxh64_int(x: int) -> int:
    """Pure-Python scalar XXH64 of one 8-byte key, seed 0 (test oracle)."""

    def rotl(v: int, s: int) -> int:
        return ((v << s) | (v >> (64 - s))) & _MASK64

    k1 = rotl((x * PRIME2) & _MASK64, 31) * PRIME1 & _MASK64
    h = _H_INIT ^ k1
    h = (rotl(h, 27) * PRIME1 + PRIME4) & _MASK64
    h ^= h >> 33
    h = (h * PRIME2) & _MASK64
    h ^= h >> 29
    h = (h * PRIME3) & _MASK64
    h ^= h >> 32
    return h
