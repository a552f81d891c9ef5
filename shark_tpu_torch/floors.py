"""The bare row gathers that the probes are held to (csrc/floors/gathers.cu).

Measurement tools, not kernels of the port: no classify path calls them,
and they count no launch. chip_smoke.py holds K2, K5, K6 and K7b to them,
and bench_gpu.py takes the 32-byte gather as the card's gather ceiling.
Each gather folds a row to one u32 by xor, so its loads cannot be dropped.

The source is compiled with nvcc on first use into
build/shark_tpu_torch/floors/libgathers.so (rebuilt when the source is
newer), apart from the kernels' library, and loaded with ctypes; nothing
runs at import. A CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
import time

import torch

from shark_tpu_torch import kernels

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                   "floors", "gathers.cu")
LIB_PATH = os.path.join(kernels.BUILD_DIR, "floors", "libgathers.so")

_lib = None
_lock = threading.Lock()


def build() -> float:
    """Compile SRC into LIB_PATH (published by rename); returns seconds,
    raises RuntimeError with nvcc's output when it does not compile."""
    t0 = time.perf_counter()
    d = os.path.dirname(LIB_PATH)
    os.makedirs(d, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=d) as tmp:
        so = os.path.join(tmp, "libgathers.so")
        r = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS,
                            "-shared", "-o", so, SRC],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError("nvcc failed for the bare gathers\n"
                               + r.stdout + r.stderr)
        os.replace(so, LIB_PATH)
    return time.perf_counter() - t0


def lib():
    """The loaded library, built first when missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if not os.path.exists(LIB_PATH) or (
                    os.path.getmtime(LIB_PATH) < os.path.getmtime(SRC)):
                build()
            so = ctypes.CDLL(LIB_PATH)
            vp, ll = ctypes.c_void_p, ctypes.c_longlong
            so.gather_rows_launch.argtypes = [vp, vp, ll, ctypes.c_int, vp,
                                              vp]
            so.gather_two_level_launch.argtypes = [vp, vp, vp, vp, ll, vp,
                                                   vp]
            so.set_l2_fetch_granularity.argtypes = [ll, ctypes.POINTER(ll)]
            for fn in (so.gather_rows_launch, so.gather_two_level_launch,
                       so.set_l2_fetch_granularity):
                fn.restype = ctypes.c_int
            _lib = so
        return _lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed (CUDA error {rc})")


def _fold(rows32: torch.Tensor) -> torch.Tensor:
    """Each row of an int32 [n, w] tensor folded to one word by xor."""
    x = rows32[:, 0]
    for c in range(1, rows32.shape[1]):
        x = x ^ rows32[:, c]
    return x.view(torch.uint32)


def rows_plain(table: torch.Tensor, idx: torch.Tensor,
               row_bytes: int) -> torch.Tensor:
    """rows()'s plain version."""
    t = table.reshape(-1).view(torch.int32).view(-1, row_bytes // 4)
    return _fold(t[idx.long()])


def rows(table: torch.Tensor, idx: torch.Tensor,
         row_bytes: int) -> torch.Tensor:
    """u32[n]: the xor of the words of row idx[i] (i32) of `table` (any
    contiguous dtype), read as rows of row_bytes (8, 16 or 32)."""
    if row_bytes not in (8, 16, 32):
        raise ValueError(f"row_bytes {row_bytes} is not 8, 16 or 32")
    if not table.is_cuda:
        return rows_plain(table, idx, row_bytes)
    kernels.require(idx, "idx", torch.int32, 1, table.device)
    if not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError("table must be contiguous and 16-byte aligned")
    out = torch.empty(idx.numel(), dtype=torch.uint32, device=idx.device)
    _check(lib().gather_rows_launch(
        table.data_ptr(), idx.data_ptr(), idx.numel(), row_bytes,
        out.data_ptr(), kernels.stream(table.device)), "gather_rows")
    return out


def two_level_plain(words, widx, pay, pidx) -> torch.Tensor:
    """two_level()'s plain version."""
    w = _fold(words.reshape(-1).view(torch.int32).view(-1, 2)[widx.long()])
    p = _fold(pay.reshape(-1).view(torch.int32).view(-1, 2)[
        pidx.clamp(min=0).long()])
    return torch.where(pidx >= 0, w ^ p, w)


def two_level(words: torch.Tensor, widx: torch.Tensor, pay: torch.Tensor,
              pidx: torch.Tensor) -> torch.Tensor:
    """u32[n]: the xor of words' 8-byte row widx[i] and, where pidx[i] >=
    0, pay's 8-byte row pidx[i], loaded after the word."""
    if not words.is_cuda:
        return two_level_plain(words, widx, pay, pidx)
    dev = words.device
    kernels.require(widx, "widx", torch.int32, 1, dev)
    kernels.require(pidx, "pidx", torch.int32, 1, dev)
    out = torch.empty(widx.numel(), dtype=torch.uint32, device=dev)
    _check(lib().gather_two_level_launch(
        words.data_ptr(), widx.data_ptr(), pay.data_ptr(), pidx.data_ptr(),
        widx.numel(), out.data_ptr(), kernels.stream(dev)),
        "gather_two_level")
    return out


def l2_fetch_granularity(nbytes: int = 0) -> int:
    """The device's cudaLimitMaxL2FetchGranularity before this call; sets
    it to nbytes when nbytes > 0 (device-wide: measurement only)."""
    was = ctypes.c_longlong(0)
    _check(lib().set_l2_fetch_granularity(nbytes, ctypes.byref(was)),
           "cudaDeviceSetLimit(L2 fetch granularity)")
    return was.value
