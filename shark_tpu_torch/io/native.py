"""ctypes bindings for the native host I/O engine (shark_native.cpp).

Compiled on first use with g++ (cached next to the source); every entry
point has a pure-Python fallback in shark_tpu_torch.io, so absence of a compiler
degrades performance, not correctness.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import List

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "..", "native", "shark_native.cpp")
_SO = os.path.join(_DIR, "..", "native", "_shark_native.so")

_lib = None
_lib_lock = threading.Lock()


def _build() -> bool:
    # build under a private name and publish by rename: several processes
    # (test workers, a CLI child) may build at once, and none may load a
    # half-written library
    tmp = f"{_SO}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread", "-o", tmp, _SRC, "-lz",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        print(
            f"[shark-tpu-torch] native build failed: {e}\n"
            f"{detail.decode(errors='replace')}",
            file=sys.stderr,
        )
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def rebuild() -> float:
    """Build the native engine from its source now, even when a library
    exists; returns the seconds taken, raises when it does not build.
    Call before the process's first get_lib()."""
    import time

    t0 = time.perf_counter()
    if not _build():
        raise RuntimeError("native engine build failed (g++ and zlib needed)")
    return time.perf_counter() - t0


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib or None
        try:
            stale = not os.path.exists(_SO) or os.path.getmtime(
                _SO
            ) < os.path.getmtime(_SRC)
        except OSError:
            # source missing (prebuilt-.so deployment): use the .so if it
            # exists; available() must return a bool, never raise
            stale = not os.path.exists(_SO)
        if stale:
            if not _build():
                _lib = False
                return None
        lib = ctypes.CDLL(_SO)
        lib.shk_open.restype = ctypes.c_void_p
        lib.shk_open.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.shk_next.restype = ctypes.c_int
        lib.shk_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.shk_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.shk_set_output.restype = ctypes.c_int
        lib.shk_set_output.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.shk_tell.restype = ctypes.c_int
        lib.shk_tell.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ]
        lib.shk_register_genes.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ]
        lib.shk_emit.restype = ctypes.c_int
        lib.shk_emit.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
        ]
        lib.shk_build.restype = ctypes.c_void_p
        lib.shk_build.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        ]
        lib.shk_build_sizes.restype = ctypes.c_int
        lib.shk_build_sizes.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.shk_build_error.restype = ctypes.c_char_p
        lib.shk_build_error.argtypes = [ctypes.c_void_p]
        lib.shk_build_fill.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_char_p,
        ]
        lib.shk_build_free.argtypes = [ctypes.c_void_p]
        lib.shk_set_positions.restype = ctypes.c_int64
        lib.shk_set_positions.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, ctypes.c_int,
        ]
        lib.shk_pack_xl.restype = ctypes.c_int64
        lib.shk_pack_xl.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int64, ctypes.c_int,
        ]
        lib.shk_scan_max_fused.restype = ctypes.c_long
        lib.shk_scan_max_fused.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.shk_n_associations.restype = ctypes.c_long
        lib.shk_n_associations.argtypes = [ctypes.c_void_p]
        lib.shk_n_reads_out.restype = ctypes.c_long
        lib.shk_n_reads_out.argtypes = [ctypes.c_void_p]
        lib.shk_error.restype = ctypes.c_char_p
        lib.shk_error.argtypes = [ctypes.c_void_p]
        lib.shk_ring_capacity.restype = ctypes.c_int
        lib.shk_ring_capacity.argtypes = []
        lib.shk_close.restype = ctypes.c_int
        lib.shk_close.argtypes = [ctypes.c_void_p]
        lib.shk_host_classify.restype = ctypes.c_void_p
        lib.shk_host_classify.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_uint64, ctypes.c_int,
        ]
        lib.shk_host_pairs.restype = ctypes.c_int64
        lib.shk_host_pairs.argtypes = [ctypes.c_void_p]
        lib.shk_host_fill.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.shk_host_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativeStream:
    """Streaming parse/encode + output write through the native engine.

    Usage:
        ns = NativeStream(fq1, fq2, batch_size, max_len, min_quality)
        ns.set_output(ssv_fd_or_path, out1, out2)
        ns.register_genes(names)
        for codes, slot, n in ns.batches():   # codes: uint8 [B, L]
            ... dispatch to device ...
            ns.emit(slot, read_idx, gene_idx)
    """

    def __init__(
        self,
        fq1: str,
        fq2: str,
        batch_size: int,
        max_len: int,
        min_quality: int,
        packed: bool = False,
        encode_threads: int = 1,
    ):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native engine unavailable")
        self._lib = lib
        self._h = lib.shk_open(
            fq1.encode(),
            (fq2 or "").encode(),
            batch_size,
            max_len,
            min_quality,
            1 if packed else 0,
            encode_threads,
        )
        if not self._h:
            raise OSError(f"cannot open {fq1} / {fq2} (max_len % 8 != 0?)")
        self.batch_size = batch_size
        self.max_len = max_len
        self.packed = packed
        self._names_ref = None  # keep char* array alive

    def set_output(
        self,
        ssv_fd: int,
        ssv_path: str,
        out1: str,
        out2: str,
        append: bool = False,
    ):
        rc = self._lib.shk_set_output(
            self._h, ssv_fd, ssv_path.encode(), out1.encode(), out2.encode(),
            1 if append else 0,
        )
        if rc != 0:
            raise OSError("cannot open output files")

    def tell(self):
        """Flush output buffers; return (ssv_off, out1_off, out2_off) byte
        offsets (-1 where absent/unseekable). Valid truncate targets for
        checkpoint/resume."""
        offs = (ctypes.c_long * 3)()
        if self._lib.shk_tell(self._h, offs) != 0:
            raise OSError("output flush failed")
        return int(offs[0]), int(offs[1]), int(offs[2])

    def register_genes(self, names: List[str]) -> None:
        arr = (ctypes.c_char_p * len(names))(*[n.encode() for n in names])
        self._names_ref = arr
        self._lib.shk_register_genes(self._h, arr, len(names))

    def next_batch(self):
        """Byte-codes mode: returns (codes uint8[B,L], slot, n) or None at
        EOF. Packed mode: returns (packed u8[B,L/4], vmask u8[B,L/8], slot,
        n) or None."""
        slot = ctypes.c_int(-1)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        if self.packed:
            packed = np.empty(
                (self.batch_size, self.max_len // 4), dtype=np.uint8
            )
            vmask = np.empty(
                (self.batch_size, self.max_len // 8), dtype=np.uint8
            )
            n = self._lib.shk_next(
                self._h,
                None,
                packed.ctypes.data_as(u8p),
                vmask.ctypes.data_as(u8p),
                ctypes.byref(slot),
            )
            out = (packed, vmask, slot.value, n)
        else:
            codes = np.empty((self.batch_size, self.max_len), dtype=np.uint8)
            n = self._lib.shk_next(
                self._h, codes.ctypes.data_as(u8p), None, None,
                ctypes.byref(slot),
            )
            out = (codes, slot.value, n)
        if n < 0:
            raise ValueError(self._lib.shk_error(self._h).decode())
        if n == 0:
            return None
        return out

    def release(self, slot: int) -> None:
        self._lib.shk_release(self._h, slot)

    def emit(self, slot: int, read_idx: np.ndarray, gene_idx: np.ndarray):
        n = len(read_idx)
        if n == 0:
            self._lib.shk_release(self._h, slot)
            return
        read_idx = np.ascontiguousarray(read_idx, dtype=np.int32)
        gene_idx = np.ascontiguousarray(gene_idx, dtype=np.int32)
        rc = self._lib.shk_emit(
            self._h,
            slot,
            read_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            gene_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n,
        )
        if rc == -2:
            raise OSError(self._lib.shk_error(self._h).decode())
        if rc != 0:
            raise ValueError("emit failed (bad read/gene index)")

    @property
    def n_associations(self) -> int:
        return self._lib.shk_n_associations(self._h)

    @property
    def n_reads_out(self) -> int:
        return self._lib.shk_n_reads_out(self._h)

    def close(self) -> None:
        if self._h:
            rc = self._lib.shk_close(self._h)
            self._h = None
            if rc != 0:
                raise OSError(
                    "output write error (disk full?): outputs are truncated"
                )

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def build_index_native(
    fasta_path: str, k: int, size_bits: int, threads: int = None
):
    """Build a SharkIndex via the C++ engine. Returns None if unavailable;
    raises on build errors (bad file, gene-capacity overflow)."""
    lib = get_lib()
    if lib is None:
        return None
    from shark_tpu_torch.index.structure import SharkIndex

    if not (1 <= k <= 31):
        # reference limit (argument_parser.hpp:115); matches build_index
        raise ValueError("k must be in the range [1, 31]")
    if threads is None:
        threads = min(4, os.cpu_count() or 1)
    h = lib.shk_build(fasta_path.encode(), k, size_bits, max(1, threads))
    try:
        sizes = (ctypes.c_int64 * 4)()
        if lib.shk_build_sizes(h, sizes) != 0:
            raise ValueError(lib.shk_build_error(h).decode())
        n_words, n_off, n_assoc, names_len = (int(x) for x in sizes)
        # np.zeros = calloc: pages stay untouched until C++ writes the set
        # words — the fill-in-place ABI avoids touching the 2 GiB of dense
        # arrays twice (build, then copy)
        bf_words = np.zeros(n_words, dtype=np.uint32)
        word_rank = np.empty(n_words, dtype=np.uint32)
        offsets = np.empty(max(n_off, 1), dtype=np.int32)
        offsets[0] = 0
        gene_ids = np.empty(max(n_assoc, 1), dtype=np.uint16)
        names_buf = ctypes.create_string_buffer(names_len)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.shk_build_fill(
            h,
            bf_words.ctypes.data_as(u32p),
            word_rank.ctypes.data_as(u32p),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            gene_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            names_buf,
        )
        names = (
            names_buf.raw[:names_len].decode().splitlines() if names_len else []
        )
        return SharkIndex(
            k=k,
            size_bits=size_bits,
            bf_words=bf_words,
            word_rank=word_rank,
            offsets=offsets[:n_off] if n_off else offsets[:1],
            gene_ids=gene_ids[:n_assoc],
            gene_names=names,
        )
    finally:
        lib.shk_build_free(h)


def set_positions_native(
    bf_words: np.ndarray, n_set: int, threads: int = None
):
    """Ascending set-bit positions (uint64[n_set]) of a Bloom bit-vector
    via the native parallel scan, or None if the engine is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if threads is None:
        threads = min(4, os.cpu_count() or 1)
    out = np.empty(max(n_set, 1), dtype=np.uint64)
    got = lib.shk_set_positions(
        bf_words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        bf_words.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out.size,  # capacity: C++ reports (writes nothing) on mismatch
        max(1, threads),
    )
    if got != n_set:
        raise ValueError(
            f"bit-vector popcount {got} != index n_set_bits {n_set}"
        )
    return out[:n_set]


def pack_xl_native(
    index,
    d3_payload: np.ndarray,
    lgB: int,
    slots: int,
    entry16: bool,
    spill_cap: int,
    threads: int = None,
):
    """Pack a hashed probe table straight from the index's bit-vector/CSR
    via the native engine (entry streams + bucket fill in one pass —
    semantics identical to classify.hashed._pack_table, equality-tested).
    Returns (table, spill_rows) — spill_rows in (bucket, position) order,
    the numpy pack's stable bucket-sort order (bucket-major, position-
    ascending within a bucket; NOT global position order) — or None when
    the engine is unavailable OR the geometry spills past `spill_cap`
    (caller retries a larger one)."""
    lib = get_lib()
    if lib is None:
        return None
    if threads is None:
        threads = min(4, os.cpu_count() or 1)
    bf = np.ascontiguousarray(index.bf_words)
    offsets = np.ascontiguousarray(index.offsets, dtype=np.int32)
    gene_ids = np.ascontiguousarray(index.gene_ids, dtype=np.uint16)
    assert offsets.size == index.n_set_bits + 1, (
        offsets.size, index.n_set_bits,
    )
    d3 = np.ascontiguousarray(
        d3_payload if d3_payload.size else np.zeros(1, np.uint32),
        dtype=np.uint32,
    )
    shape = (1 << lgB, slots) if entry16 else (1 << lgB, 2, 8)
    table = np.zeros(shape, np.uint32)
    cap = max(int(spill_cap), 1)
    spill = np.empty((cap, 4), np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    got = lib.shk_pack_xl(
        bf.ctypes.data_as(u32p),
        bf.size,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(index.n_set_bits),
        gene_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        d3.ctypes.data_as(u32p),
        lgB,
        slots,
        1 if entry16 else 0,
        table.ctypes.data_as(u32p),
        spill.ctypes.data_as(u32p),
        cap,
        max(1, threads),
    )
    if got == -2:
        raise ValueError(
            "bit-vector popcount disagrees with index n_set_bits "
            "(corrupt or mixed index files)"
        )
    if got < 0:
        return None
    return table, spill[:got].copy()


def host_classify(
    index, codes: np.ndarray, n: int, c: float, single: bool,
    threads: int = 1,
):
    """Pure-CPU classify of `n` rows of a [B, L] byte-code batch against
    the index arrays (the --backend native serving path; oracle-exact
    semantics, see shk_host_classify). Returns (read_idx i32[P],
    gene_idx i32[P]) in reference emission order (reads ascending, genes
    ascending within a read). Raises if the engine is unavailable."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native engine unavailable")
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    bf = np.ascontiguousarray(index.bf_words)
    wr = np.ascontiguousarray(index.word_rank)
    offsets = np.ascontiguousarray(index.offsets, dtype=np.int32)
    gene_ids = np.ascontiguousarray(index.gene_ids, dtype=np.uint16)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    h = lib.shk_host_classify(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(n),
        codes.shape[1],
        int(index.k),
        float(c),
        1 if single else 0,
        bf.ctypes.data_as(u32p),
        wr.ctypes.data_as(u32p),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        gene_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        int(index.size_bits),
        max(1, threads),
    )
    try:
        p = int(lib.shk_host_pairs(h))
        ri = np.empty(max(p, 1), np.int32)
        gi = np.empty(max(p, 1), np.int32)
        if p:
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.shk_host_fill(
                h, ri.ctypes.data_as(i32p), gi.ctypes.data_as(i32p)
            )
        return ri[:p], gi[:p]
    finally:
        lib.shk_host_free(h)


def scan_max_fused(fq1: str, fq2: str = "") -> int:
    """Longest FUSED read length in the sample (parse-only native pass;
    pairing stops at either EOF, like the classify run). Returns 0 for an
    empty sample; raises if the input cannot be opened or is malformed."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native engine unavailable")
    n = lib.shk_scan_max_fused(fq1.encode(), (fq2 or "").encode())
    if n == -1:
        raise OSError(f"cannot open {fq1} / {fq2}")
    if n < 0:
        raise ValueError(f"malformed or corrupt sample input: {fq1} / {fq2}")
    return int(n)


def available() -> bool:
    return get_lib() is not None


def ring_capacity() -> int:
    """Prefetch-ring slot count (kRing): the ceiling on simultaneously
    pinned (consumed-but-unreleased) batches."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native engine unavailable")
    return int(lib.shk_ring_capacity())
