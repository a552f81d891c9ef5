"""Canonical k-mer extraction.

Base encoding: A/a=0, C/c=1, G/g=2, T/t=3, anything else = INVALID (4).
(The reference keeps a 1-based table and subtracts 1 at use sites,
kmer_utils.hpp:29-41 and KmerBuilder.hpp:61; we encode 0-based directly.)

A k-mer is any length-k window of consecutive valid bases; its packed value
places the leftmost base in the most-significant 2 bits (reference
build_kmer/lsappend, kmer_utils.hpp:57-75). The canonical form is
min(kmer, revcomp(kmer)) as 2k-bit integers. The reference's rebuild-after-
invalid-char rolling scan (KmerBuilder.hpp:52-67) enumerates exactly the set
of all-valid windows in left-to-right order; we compute all windows in
parallel and mask, which yields the identical multiset with end positions.

Host (numpy uint64) and batched torch (int64) implementations. The torch
version is the plain twin of shark_tpu.ops.kmers.canonical_kmers_jax; the
CUDA front-end kernel (csrc/front.cu) computes the same values per window.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

INVALID = 4

# byte -> code lookup table (0..3 bases, 4 otherwise), covering 0..255
BYTE_TO_CODE = np.full(256, INVALID, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    BYTE_TO_CODE[ord(_ch)] = _code
    BYTE_TO_CODE[ord(_ch.lower())] = _code


def encode_bytes(seq: bytes) -> np.ndarray:
    """ASCII sequence -> uint8 codes (0..3, INVALID)."""
    return BYTE_TO_CODE[np.frombuffer(seq, dtype=np.uint8)]


# ---------------------------------------------------------------------------
# Host path (numpy, native uint64)
# ---------------------------------------------------------------------------


def canonical_kmers_np(codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """All-window canonical k-mers of one 1-D code array.

    Returns (canon, end_pos): uint64 canonical values and int64 end positions
    (index of the window's last base) for each *valid* window, in increasing
    end-position order — the same order as the reference's rolling scan.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    if n < k:
        return np.empty(0, np.uint64), np.empty(0, np.int64)
    valid = codes != INVALID
    c = np.where(valid, codes, 0).astype(np.uint64)
    nwin = n - k + 1
    fwd = np.zeros(nwin, dtype=np.uint64)
    rc = np.zeros(nwin, dtype=np.uint64)
    allvalid = np.ones(nwin, dtype=bool)
    top = np.uint64(2 * k - 2)
    for j in range(k):
        cj = c[j : j + nwin]
        fwd = (fwd << np.uint64(2)) | cj
        rc = (rc >> np.uint64(2)) | ((np.uint64(3) ^ cj) << top)
        allvalid &= valid[j : j + nwin]
    canon = np.minimum(fwd, rc)
    end_pos = np.nonzero(allvalid)[0] + (k - 1)
    return canon[allvalid], end_pos


# ---------------------------------------------------------------------------
# Batched torch path (int64) — [B, L]
# ---------------------------------------------------------------------------


def canonical_kmers_torch(
    codes: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Canonical k-mers for every window of a padded batch.

    codes: uint8 [B, L] (values 0..3 valid, >= 4 invalid/padding).
    Returns (canon int64[B, L], window_valid bool[B, L]): index e holds the
    window *ending* at position e (entries with e < k-1 or any invalid
    base are masked False; their canon value is unspecified), exactly as
    shark_tpu's canonical_kmers_jax. A 2k-bit k-mer (k <= 31) is below
    2**62, so int64 holds it without a sign bit and its shifts are
    logical; the rolling form below is the numpy host path's, batched."""
    B, L = codes.shape
    valid = codes < INVALID
    c = torch.where(valid, codes, torch.zeros_like(codes)).to(torch.int64)
    fwd = torch.zeros((B, L), dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    win_valid = torch.ones((B, L), dtype=torch.bool, device=codes.device)
    top = 2 * k - 2
    for j in range(k):
        # base at window offset j: position e - (k - 1) + j
        shift = k - 1 - j
        cj = _shift_right(c, shift, 0)
        fwd = (fwd << 2) | cj
        rc = (rc >> 2) | ((3 ^ cj) << top)
        win_valid &= _shift_right(valid, shift, False)
    pos = torch.arange(L, device=codes.device)[None, :]
    win_valid &= pos >= (k - 1)
    return torch.minimum(fwd, rc), win_valid


def _shift_right(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    """x[b, i] -> x[b, i - n], filling the first n columns with `fill`."""
    if n == 0:
        return x
    out = torch.full_like(x, fill)
    if n < x.shape[1]:
        out[:, n:] = x[:, : x.shape[1] - n]
    return out
