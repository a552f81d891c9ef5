"""Build, load and count the hand-written CUDA kernels (csrc/*.cu).

The device kernels of the classify paths, and of the two experiments in
shark_tpu_torch/experiments/, are CUDA C++ for sm_90a with a plain C
interface. They are compiled with nvcc into one shared library,
build/shark_tpu_torch/libshark_kernels.so at the repository root, at first
use and again whenever a source is newer than the library, and loaded with
ctypes. Every pointer and the stream cross as c_void_p. Each C entry point
launches on the stream it is given (the caller's
torch.cuda.current_stream()) and returns cudaGetLastError() as an int,
which the wrapper turns into an exception.

Nothing here runs at import: tests import every module on hosts that have
no nvcc and no card, so nvcc is only called when a CUDA tensor reaches a
kernel wrapper, or when chip_smoke.py builds on purpose.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "shark_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libshark_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

# The kernels of the classify paths: the front end, the three probes
# (hashed, xl, classic), the finish, the pair stream, and the sharded
# Bloom filter's routing round (route, owner probe, return; all three in
# csrc/route.cu). The finish takes two launches of its source (a
# batch-wide pass, then one block per read) and the route three (count,
# scan, scatter); each counts as one kernel. The last two are the
# experiment kernels (the per-probe tile gather and the resident-table
# bucket match of shark_tpu_torch/experiments/), which no classify path
# launches.
KERNELS = ("front", "probe", "finish", "pairs", "probe_xl", "classic",
           "shard_route", "shard_probe", "shard_return", "gather_tiles",
           "resident_match")

_lib = None
_lock = threading.Lock()


class LaunchCounter:
    """Launches per kernel since the last reset. A wrapper adds one where
    it launches its kernel, and nowhere else; the plain-PyTorch branch of
    a wrapper never counts."""

    def __init__(self, names: Iterable[str]):
        self._lock = threading.Lock()
        self._n: Dict[str, int] = {n: 0 for n in names}

    def add(self, name: str) -> None:
        with self._lock:
            self._n[name] += 1

    def reset(self) -> None:
        with self._lock:
            for n in self._n:
                self._n[n] = 0

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._n)


LAUNCHES = LaunchCounter(KERNELS)


def sources() -> List[str]:
    return sorted(
        os.path.join(CSRC, f)
        for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built"
    )


def stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in sources())


def build(ptxas_info: bool = False, force: bool = False) -> Tuple[float, str]:
    """Compile every csrc/*.cu (one nvcc per source, all started together)
    and link them into LIB_PATH, published by atomic rename. Returns
    (seconds, compiler log); raises RuntimeError with nvcc's output when a
    source does not compile. A fresh library is left alone unless
    `force`."""
    if not force and not stale():
        return 0.0, ""
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    extra = ["-Xptxas", "-v"] if ptxas_info else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        for src in sources():
            if not src.endswith(".cu"):
                continue
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append(
                (
                    src,
                    subprocess.Popen(
                        [nvcc, *NVCC_FLAGS, *extra, "-I", CSRC, "-c", src,
                         "-o", obj],
                        stdout=subprocess.PIPE,
                        stderr=subprocess.STDOUT,
                        text=True,
                    ),
                )
            )
        log = []
        failed = []
        for src, p in procs:
            out, _ = p.communicate()
            log.append(f"== {os.path.basename(src)}\n{out}")
            if p.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(
                "nvcc failed for " + ", ".join(failed) + "\n" + "\n".join(log)
            )
        tmp_lib = os.path.join(tmp, "libshark_kernels.so")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_lib, *objs],
            capture_output=True,
            text=True,
        )
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout + link.stderr)
        os.replace(tmp_lib, LIB_PATH)
    return time.perf_counter() - t0, "\n".join(log)


_VP = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U64 = ctypes.c_ulonglong

_SIGNATURES = {
    # packed, vmask, B, L, k, mod_mode, mod_arg, idx_hi, idx_lo,
    # win_valid, length, stream
    "shkk_front": [_VP, _VP, _I, _I, _I, _I, _U64, _VP, _VP, _VP, _VP, _VP],
    # idx_hi, idx_lo, win_valid, n, table, lgB, entry16, slots, stash,
    # n_stash, tagv, payv, stream
    "shkk_probe": [_VP, _VP, _VP, _L, _VP, _I, _I, _I, _VP, _I, _VP, _VP,
                   _VP],
    # tagv, payv, B, Ls, rb, flags, gmax, n_fix, stream
    "shkk_finish_groups": [_VP, _VP, _I, _I, _I, _VP, _VP, _VP, _VP],
    # (see csrc/finish.cu: FinishArgs field order)
    "shkk_finish_reads": [
        _VP, _VP, _VP, _VP,  # tagv, payv, length, thresh
        _VP, _I, _I, _I,  # rows3, n3, rows3_w, D
        _VP, _I,  # ext_mat (or 0), ext_w
        _I, _I, _I, _I, _I, _I, _I, _I,  # B, Ls, L, k, pos_bits,
        # n_genes, rows_bits, W
        _I, _I,  # has_rows, groups (0/1)
        _VP, _VP, _VP, _I,  # flags, gmax, n_fix, fix_cap2
        _I, _I, _VP,  # key_cap, grid, scratch (or 0)
        _VP, _VP, _VP,  # packed, winners, best_cov
        _VP,  # stream
    ],
    # packed, winners, B, W, out, out_len, offsets (B + 1), stream
    "shkk_pairs": [_VP, _VP, _I, _I, _VP, _L, _VP, _VP],
    # idx_hi, idx_lo, win_valid, n, table, lgB, side, side_lgB, has_side,
    # side_stash, n_side_stash, tagv, payv, stream
    "shkk_probe_xl": [_VP, _VP, _VP, _L, _VP, _I, _VP, _I, _I, _VP, _I, _VP,
                      _VP, _VP],
    # idx_hi, idx_lo, win_valid, n, bf_rank, pay, tagv, payv, stream
    "shkk_classic": [_VP, _VP, _VP, _L, _VP, _VP, _VP, _VP, _VP],
    # idx_hi, idx_lo, win_valid, n_src, Pn, n, wps, wide, cap, counts,
    # offs, send, slot, owner, overflow, stream
    "shkk_shard_route": [_VP, _VP, _VP, _I, _L, _I, _L, _I, _L, _VP, _VP,
                         _VP, _VP, _VP, _VP, _VP],
    # recv, per_owner, total, bf_rank, wps, pay, rows_max, reply, stream
    "shkk_shard_probe": [_VP, _L, _L, _VP, _L, _VP, _L, _VP, _VP],
    # back, Pn, total, n, cap, owner, slot, tagv, payv, stream
    "shkk_shard_return": [_VP, _L, _L, _I, _L, _VP, _VP, _VP, _VP, _VP],
    # table_tiles, idx, n, out, stream
    "shkk_gather_tiles": [_VP, _VP, _L, _VP, _VP],
    # rows, want, table128, n, out, stream
    "shkk_resident_match": [_VP, _VP, _VP, _L, _VP, _VP],
}


def lib():
    """The loaded kernel library, built first when missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            so = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            so.shkk_error_string.argtypes = [ctypes.c_int]
            so.shkk_error_string.restype = ctypes.c_char_p
            so.shkk_max_smem_optin.argtypes = []
            so.shkk_max_smem_optin.restype = ctypes.c_int
            _lib = so
        return _lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error (a refused launch
    never runs, and torch.cuda.synchronize() would not report it)."""
    if rc != 0:
        msg = lib().shkk_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} (error {rc})")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    """Validate what a kernel takes before its pointer crosses to C."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
