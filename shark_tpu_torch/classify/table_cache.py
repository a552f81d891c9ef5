"""On-disk cache of packed probe tables, shared with shark_tpu.

The index itself serializes via --save-index (SharkIndex.save), but the
device probe tables are built from it at classifier construction. This
module caches the packed tables next to the index so a warm start skips
the pack. The key and format are shark_tpu's, so either package loads the
other's hashed tables; an xl entry (a layout not in the port yet) raises
rather than being rebuilt into another layout.

Staleness is the failure mode this design is built against (a stale table
would silently corrupt the byte-exact output invariant):

- The cache key embeds a STRONG CONTENT DIGEST of the index arrays
  (blake2b-256 over k, size_bits, bf_words, offsets, gene_ids,
  gene_names), so a rebuilt/modified index can never match a cache built
  from different content. SharkIndex.save stores the digest beside the
  arrays (guarded by per-file size+mtime stats, recomputed if they moved);
  an in-memory index pays one hashing pass the first time.
- The key also embeds FORMAT_VERSION plus every build-time constant and
  derived geometry that shapes table content (bucket budgets, slot
  layouts, the rows3/group geometry whose indices are EMBEDDED in tag-3
  payloads). Bump FORMAT_VERSION whenever the table layout, the
  _pack_table semantics, or the rows3/group-id assignment changes.
- Each cached array carries a crc32; a torn or corrupted file is detected
  at load (full verify) and the cache is ignored + rebuilt.
- Writes go to a ".partial" directory published by atomic rename, so an
  interrupted save never leaves a half-written cache at the final path.

On any mismatch the loader returns None and the classifier rebuilds from
the index — the cache can only ever trade time, never correctness.

The cache is SINGLE-SLOT: one (request_probe, geometry) variant lives in
the directory at a time, so alternating --probe flags against one index
rebuild+rewrite on each switch (correct, just not cached both ways). The
dominant use — one serving configuration per index — pays nothing for
this, and a single slot cannot accumulate stale geometry files.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import threading
import zlib
from typing import List, Optional, Tuple

import numpy as np

from shark_tpu_torch.index.structure import SharkIndex

# Bump whenever cached-table CONTENT could change for the same index
# bytes: _pack_table layout, HashedMeta semantics, bucket-count selection
# policy, rows3 compaction order, or group-id assignment (_group_info_impl)
# — tag-3 payloads embed rows3 indices + group ids, so those algorithms
# are part of the format.
FORMAT_VERSION = 1

DIGEST_FILE = "digest.json"

_pending: List[Tuple[threading.Thread, List[BaseException]]] = []


def _array_digest_update(h, arr: np.ndarray) -> None:
    h.update(np.ascontiguousarray(arr).view(np.uint8).reshape(-1))


def compute_index_digest(index: SharkIndex) -> str:
    """blake2b-256 hex digest of the index content (order-fixed)."""
    import hashlib

    h = hashlib.blake2b(digest_size=32)
    h.update(
        json.dumps(
            [int(index.k), int(index.size_bits), list(index.gene_names)]
        ).encode()
    )
    for name in ("bf_words", "offsets", "gene_ids"):
        arr = np.asarray(getattr(index, name))
        h.update(f"{name}:{arr.dtype.str}:{arr.shape}".encode())
        _array_digest_update(h, arr)
    return h.hexdigest()


def _file_stats(dir_path: str) -> dict:
    out = {}
    for name in ("bf_words", "offsets", "gene_ids"):
        p = os.path.join(dir_path, name + ".npy")
        st = os.stat(p)
        out[name] = [st.st_size, st.st_mtime_ns]
    return out


def write_index_digest(dir_path: str, index: SharkIndex) -> None:
    """Store the content digest beside a directory-format index save, so
    later loads skip the hashing pass. Guarded by per-file stats: if the
    array files are touched after the save, the digest is recomputed."""
    digest = compute_index_digest(index)
    with open(os.path.join(dir_path, DIGEST_FILE), "w") as f:
        json.dump({"digest": digest, "files": _file_stats(dir_path)}, f)
    index.__dict__["_content_digest"] = digest


def index_digest(index: SharkIndex) -> str:
    """Content digest, from (in order): the in-memory cached value, a
    trusted digest file beside a directory-loaded index, or a fresh
    hashing pass (cached on the instance afterwards)."""
    cached = index.__dict__.get("_content_digest")
    if cached:
        return cached
    src = index.__dict__.get("_source_dir")
    if src:
        try:
            with open(os.path.join(src, DIGEST_FILE)) as f:
                rec = json.load(f)
            if rec.get("files") == _file_stats(src):
                index.__dict__["_content_digest"] = rec["digest"]
                return rec["digest"]
        except (OSError, ValueError, KeyError):
            pass
    digest = compute_index_digest(index)
    index.__dict__["_content_digest"] = digest
    return digest


def _cache_key(
    index: SharkIndex,
    request_probe: Optional[str],
    lgB: Optional[int],
    side_lgB: Optional[int],
) -> dict:
    """Everything that determines table content and layout selection for
    this index. Derived rows3/group geometry is computed LIVE so drift in
    those algorithms (beyond a missed FORMAT_VERSION bump) still misses."""
    from shark_tpu_torch.classify import hashed as H
    from shark_tpu_torch.classify import step as S

    gi = S.group_info(index)
    return {
        "version": FORMAT_VERSION,
        "digest": index_digest(index),
        "request_probe": request_probe or "auto",
        "lgB": lgB,
        "side_lgB": side_lgB,
        "k": int(index.k),
        "size_bits": int(index.size_bits),
        "n_genes": int(index.n_genes),
        "n_set": int(index.n_set_bits),
        "geometry3": list(S.index_geometry3(index)),
        "rows_bits": int(gi[2]) if gi is not None else 0,
        "consts": [
            H.BUCKET_SLOTS, H.STASH_CAP, H.SMALL_STASH, H.STASH_MIN,
            H.MAX_TABLE_BYTES, H.XL_SLOTS, H.XL_REST_BITS, H.XL_FLAG_BIT,
            H.XL_SIDE_CAP, H.XL_SIDE_STASH_CAP, H.XL_MAX_LGB,
            list(S.GENE_D_CHOICES), S.GENE_MAT_BUDGET, S.EXT_MAX_W,
        ],
    }


_ARRAYS = {"hashed": ("table", "stash"), "xl": ("table", "side", "side_stash")}


def load_tables(
    cache_dir: str,
    index: SharkIndex,
    request_probe: Optional[str],
    lgB: Optional[int] = None,
    side_lgB: Optional[int] = None,
):
    """(kind, arrays) from a valid cache, or None (missing / key mismatch /
    corrupted — the caller rebuilds). kind "hashed" -> (table, stash,
    HashedMeta); "xl" -> (table, side, side_stash, HashedMeta)."""
    meta_path = os.path.join(cache_dir, "meta.json")
    try:
        with open(meta_path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    try:
        if rec["key"] != _cache_key(index, request_probe, lgB, side_lgB):
            return None
        kind = rec["kind"]
        if kind == "xl":
            # a valid entry for this index, written by shark_tpu, whose
            # layout the port cannot run: say so rather than rebuild
            # silently into another layout
            from shark_tpu_torch.config import not_ported

            raise not_ported("a cached xl probe table", "xl probe")
        names = _ARRAYS[kind]
        arrays = []
        for name in names:
            arr = np.load(os.path.join(cache_dir, name + ".npy"))
            if zlib.crc32(np.ascontiguousarray(arr)) != rec["crc"][name]:
                print(
                    f"[shark-tpu-torch] probe-table cache corrupt ({name}); "
                    "rebuilding",
                    file=sys.stderr,
                )
                return None
            arrays.append(arr)
        from shark_tpu_torch.classify.hashed import HashedMeta

        hmeta = HashedMeta(**rec["hmeta"])
    except (OSError, ValueError, KeyError, TypeError, EOFError) as e:
        # EOFError: np.load on a ZERO-length .npy (a torn write surfaced
        # by power loss) raises EOFError, not ValueError — missing it
        # would crash every classifier construction instead of rebuilding
        print(
            f"[shark-tpu-torch] probe-table cache unreadable ({e}); rebuilding",
            file=sys.stderr,
        )
        return None
    return kind, tuple(arrays) + (hmeta,)


def save_tables_async(
    cache_dir: str,
    index: SharkIndex,
    request_probe: Optional[str],
    kind: str,
    arrays: tuple,
    lgB: Optional[int] = None,
    side_lgB: Optional[int] = None,
) -> None:
    """Write the cache on a background thread (the arrays are done being
    read by device_put by the time the classifier constructor returns, and
    a 1 GiB table write would otherwise sit on the cold-start path this
    cache exists to shorten). join_pending() surfaces failures; writers
    publish with an atomic rename so interruption leaves no partial
    cache."""
    *arrs, hmeta = arrays
    key = _cache_key(index, request_probe, lgB, side_lgB)
    err: List[BaseException] = []

    def _bg():
        try:
            tmp = cache_dir.rstrip("/") + ".partial"
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            crc = {}
            for name, arr in zip(_ARRAYS[kind], arrs):
                arr = np.ascontiguousarray(arr)
                path = os.path.join(tmp, name + ".npy")
                with open(path, "wb") as f:
                    np.save(f, arr)
                    f.flush()
                    os.fsync(f.fileno())  # data durable BEFORE the rename
                crc[name] = zlib.crc32(arr)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(
                    {
                        "key": key,
                        "kind": kind,
                        "crc": crc,
                        "hmeta": dataclasses.asdict(hmeta),
                    },
                    f,
                )
                f.flush()
                os.fsync(f.fileno())
            if os.path.isdir(cache_dir):
                shutil.rmtree(cache_dir)
            os.replace(tmp, cache_dir)
        except BaseException as e:  # noqa: BLE001 - surfaced on join
            # the serving path never joins (only bench/tests do) — say
            # WHY the cache keeps not materializing instead of silently
            # re-paying the cold pack on every start
            print(
                f"[shark-tpu-torch] probe-table cache write failed: {e}",
                file=sys.stderr,
            )
            err.append(e)

    th = threading.Thread(target=_bg, daemon=False)
    th.start()
    _pending.append((th, err))


def join_pending() -> None:
    """Join outstanding background cache writes, re-raising any failure.
    bench.py's settle() calls this so disk flushes never overlap timed
    passes; tests call it for determinism."""
    while _pending:
        th, err = _pending.pop()
        th.join()
        if err:
            raise err[0]
