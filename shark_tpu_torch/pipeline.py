"""End-to-end driver: build/load index, stream sample batches through the
device classifier, threshold + write on the host.

PyTorch counterpart of shark_tpu/pipeline.py, with the same phases and the
same output bytes: one host pass builds the whole index; the sample loop is
a software pipeline — while the card classifies batch i, the host encodes
batch i+1 and a drain thread decodes batch i-1's verdicts. Verdicts leave
the card through non-blocking copies into pinned host memory, each with a
CUDA event the drain thread waits on (shark_tpu's copy_to_host_async).
"""

from __future__ import annotations

import os
import sys
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from shark_tpu_torch.classify.step import (
    PACK_EMIT_SHIFT,
    PACK_GRP_SHIFT,
    PACK_NW_BITS,
    PACK_NW_SHIFT,
    PACK_OVF_SHIFT,
    PAIR_SENTINEL,
    Classifier,
    _ragged_cols,
    extract_pairs,
    resolve_device,
)
from shark_tpu_torch.config import SharkConfig
from shark_tpu_torch.index.build import build_index
from shark_tpu_torch.index.structure import SharkIndex
from shark_tpu_torch.io.encode import ReadBatch, encode_batch, fused_length
from shark_tpu_torch.io.fastx import read_fasta, read_fastq_pairs
from shark_tpu_torch.io.writer import OutputWriter
from shark_tpu_torch.utils.timers import PhaseTimer

FastqRecord = Tuple[str, bytes, bytes]

# Auto-length ceiling for the fixed-geometry native path: a sample whose
# longest fused read exceeds this uses the Python per-batch-padded path
# instead (short-read RNA-Seq — this tool's domain — sits far below it).
AUTO_NATIVE_MAX_LEN = 2048


def _round_len(n: int, k: int) -> int:
    """Bucket padded lengths as shark_tpu does, keeping probe windows
    tight: multiples of 8 up to 256, of 32 up to 1024, then powers of
    two."""
    n = max(n, k, 8)
    if n <= 256:
        return (n + 7) & ~7
    if n <= 1024:
        return (n + 31) & ~31
    return 1 << int(np.ceil(np.log2(n)))


class _HostCopy:
    """A device tensor's copy into pinned host memory, started without
    blocking the dispatch thread; numpy() waits for it on a CUDA event.
    A CPU tensor needs no copy."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _np(x) -> np.ndarray:
    """Host view of a device result (waits for the card)."""
    if isinstance(x, _HostCopy):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _batches(
    cfg: SharkConfig,
) -> Iterator[ReadBatch]:
    recs1: List[FastqRecord] = []
    recs2: Optional[List[FastqRecord]] = [] if cfg.paired else None
    max_fused = 0
    pairs = read_fastq_pairs(cfg.sample1_path, cfg.sample2_path or None)
    fixed_len = cfg.max_read_len

    def flush() -> ReadBatch:
        nonlocal recs1, recs2, max_fused
        L = fixed_len or _round_len(max_fused, cfg.k)
        batch = encode_batch(
            recs1, recs2, cfg.min_quality, cfg.batch_size, L
        )
        recs1 = []
        recs2 = [] if cfg.paired else None
        max_fused = 0
        return batch

    for r1, r2 in pairs:
        recs1.append(r1)
        if recs2 is not None:
            assert r2 is not None
            recs2.append(r2)
        max_fused = max(max_fused, fused_length(r1, r2))
        if len(recs1) == cfg.batch_size:
            yield flush()
    if recs1:
        yield flush()


class _ShimAssoc:
    """dict-like probe view over a SharkIndex for the oracle fallback."""

    def __init__(self, index: SharkIndex):
        self._index = index

    def get(self, p: int):
        genes = self._index.membership(p)
        return genes.tolist() if genes.size else None


class _ShimIndex:
    def __init__(self, index: SharkIndex):
        self.k = index.k
        self.size_bits = index.size_bits
        self.assoc = _ShimAssoc(index)
        self.gene_names = index.gene_names


def _drain(
    cfg: SharkConfig,
    index: SharkIndex,
    batch: ReadBatch,
    result,
    writer: OutputWriter,
    max_winners: int,
    groups=None,
) -> None:
    """Decode one batch's verdicts and emit through the Python writer
    (non-native path); shares all verdict/overflow logic with the native
    path via _winner_pairs."""
    ri, gi = _winner_pairs(
        cfg, index, result, batch.n, batch.codes, max_winners,
        groups=groups,
    )
    names = index.gene_names
    rec2 = batch.recs2
    n = len(ri)
    i = 0
    while i < n:
        r = ri[i]
        j = i
        while j < n and ri[j] == r:
            j += 1
        writer.emit_read(
            [names[g] for g in gi[i:j]],
            batch.recs1[r],
            rec2[r] if rec2 is not None else None,
        )
        i = j


def _winner_pairs(
    cfg: SharkConfig,
    index: SharkIndex,
    result,
    n: int,
    codes: np.ndarray,
    max_winners: int,
    packed_np: Optional[np.ndarray] = None,
    spec=None,
    spec_state: Optional[dict] = None,
    groups=None,
    counters: Optional[dict] = None,
):
    """Device result -> (read_idx, gene_idx) association arrays, read-ascending,
    genes ascending within a read (the reference's emission order,
    ReadAnalyzer.hpp:104-108 + ReadOutput.hpp:43-48). `packed_np` supplies a
    pre-fetched packed-verdict array (grouped-fetch fast path); `groups`
    (GeneGroups) expands
    device GROUP verdicts (PACK_GRP: tie-heavy reads scored as one deduped
    gene set) into their member lists.

    `spec` carries a SPECULATIVE (pairs _HostCopy, cap) pre-dispatched by
    the main loop right after the classify kernels (its d2h copy overlaps
    later batches' device work instead of round-tripping from the drain
    thread); it is used when this batch's winner stream fits `cap`,
    recomputed exactly otherwise. `spec_state` ({"cap": int}) is how this
    function tells the main loop that the workload is tie-heavy and which
    capacity to speculate with (0 = don't)."""
    ri1, gi1, grp_rows, packed = _winner_pairs_base(
        cfg, index, result, n, codes, max_winners,
        packed_np=packed_np, spec=spec, spec_state=spec_state,
    )
    if counters is not None:
        counters["group_rows"] = counters.get("group_rows", 0) + int(
            grp_rows.size
        )
    if grp_rows.size == 0:
        return ri1, gi1
    if groups is None:
        raise RuntimeError(
            "device emitted GROUP verdicts but no GeneGroups is attached "
            "to this classifier"
        )
    # expand each group verdict into its member list (ascending ids, as
    # stored — the reference's emission order within a read)
    off_g = groups.offsets
    gids = (packed[grp_rows] & 0xFFFF).astype(np.int64)
    cnt2 = (off_g[gids + 1] - off_g[gids]).astype(np.int64)
    ri2 = np.repeat(grp_rows, cnt2).astype(np.int32)
    gi2 = groups.flat[
        np.repeat(off_g[gids], cnt2) + _ragged_cols(cnt2)
    ].astype(np.int32)
    if ri1.size == 0:
        return ri2, gi2
    # merge, preserving read-ascending order: each read's pairs live in
    # exactly one source and both sources are read-ascending, so place by
    # per-read offsets instead of re-sorting the concatenation
    c1 = np.bincount(ri1, minlength=n)
    c2 = np.bincount(ri2, minlength=n)
    start = np.concatenate([[0], np.cumsum(c1 + c2)])
    out_r = np.empty(ri1.size + ri2.size, np.int32)
    out_g = np.empty_like(out_r)
    for r_, g_, c_ in ((ri1, gi1, c1), (ri2, gi2, c2)):
        first = (np.cumsum(c_) - c_)[r_]
        dst = start[r_] + (np.arange(r_.size, dtype=np.int64) - first)
        out_r[dst] = r_
        out_g[dst] = g_
    return out_r, out_g


def _winner_pairs_base(
    cfg: SharkConfig,
    index: SharkIndex,
    result,
    n: int,
    codes: np.ndarray,
    max_winners: int,
    packed_np: Optional[np.ndarray] = None,
    spec=None,
    spec_state: Optional[dict] = None,
):
    """(read_idx, gene_idx, emitted_group_rows, packed) for the non-group
    verdicts; group rows (PACK_GRP) are returned for the caller to expand."""
    packed_dev, winners_dev = result[0], result[1]
    packed = (packed_np if packed_np is not None else _np(packed_dev))[:n]
    winner0 = packed & ((1 << PACK_NW_SHIFT) - 1)
    n_winners = (packed >> PACK_NW_SHIFT) & ((1 << PACK_NW_BITS) - 1)
    dev_ovf = ((packed >> PACK_OVF_SHIFT) & 1).astype(bool)
    grp = ((packed >> PACK_GRP_SHIFT) & 1).astype(bool)
    emit_bit = ((packed >> PACK_EMIT_SHIFT) & 1).astype(bool)
    # group verdicts: winner0 is a GROUP id (>= 3 tied members by
    # construction), expanded by the caller; single mode can never emit
    # them (the reference drops multi-winner reads, main.cpp -s)
    grp_rows = (
        np.flatnonzero(grp & emit_bit)
        if not cfg.single
        else np.empty(0, np.int64)
    )
    emit = emit_bit & (n_winners > 0) & ~grp
    if cfg.single:
        emit &= n_winners == 1
    # device-overflowed rows have an incomplete verdict: always recompute
    rows = np.flatnonzero(emit | dev_ovf)
    if rows.size == 0:
        return rows.astype(np.int32), rows.astype(np.int32), grp_rows, packed
    nw = n_winners[rows]
    sat = (1 << PACK_NW_BITS) - 1
    overflow = (nw > max_winners) | (nw == sat) | dev_ovf[rows]
    if not np.any(overflow) and not np.any(nw > 1):
        if spec_state is not None and spec is not None:
            # the speculated stream went unused; after a few consecutive
            # wasted ones (a tie-heavy region followed by a tie-free one)
            # tell the main loop to stop paying the dispatch + d2h copy —
            # the next tie batch re-engages it via the exact path
            spec_state["idle"] = spec_state.get("idle", 0) + 1
            if spec_state["idle"] >= 4:
                spec_state["cap"] = 0
                spec_state["idle"] = 0
        return (
            rows.astype(np.int32),
            winner0[rows].astype(np.int32),
            grp_rows,
            packed,
        )
    winners = None
    if not np.any(overflow):
        B = int(packed_dev.shape[0])
        if not cfg.single and B <= 65536:
            # fetch one device-sorted (row<<16|gene) stream of ALL winner
            # pairs (4 bytes/association, already in reference emission
            # order) instead of the whole [B, W] matrix. The capacity is
            # quantized to shark_tpu's levels {2^14, 2^17, 2^19, B*W} (the
            # stream's length is part of what both packages compare); the
            # sentinel check below still guards against truncation.
            total = int(np.minimum(nw, max_winners).sum())
            BW = B * max_winners
            cap = next(
                (
                    min(lv, BW)
                    for lv in ((1 << 14), (1 << 17), (1 << 19))
                    if min(lv, BW) >= total + 2
                ),
                BW,
            )
            if total + 2 <= BW:
                if spec_state is not None:
                    spec_state["cap"] = max(spec_state.get("cap", 0), cap)
                    spec_state["idle"] = 0
                if spec is not None and spec[1] >= total + 2:
                    pairs = _np(spec[0])
                else:
                    pairs = _np(extract_pairs(packed_dev, winners_dev, cap))
                # Slice by the exactly-known pair count, NOT by filtering
                # out sentinel-valued entries: the legitimate pair
                # (row 65535, gene 65535) encodes to 0xFFFFFFFF ==
                # PAIR_SENTINEL, and sentinels sort to the tail, so
                # pairs[:total] keeps exactly the real keys (a colliding
                # key is VALUE-equal to the padding it may swap with and
                # still decodes correctly). pairs[total] being sentinel
                # confirms the capacity math matched the device; a real
                # key there means it didn't (should not happen) and we
                # fall through to the full winner fetch.
                if pairs[total] == PAIR_SENTINEL:
                    pairs = pairs[:total]
                    prow = (pairs >> 16).astype(np.int64)
                    keep = prow < n  # drop padding rows (none expected)
                    return (
                        prow[keep].astype(np.int32),
                        (pairs[keep] & 0xFFFF).astype(np.int32),
                        grp_rows,
                        packed,
                    )
        if spec_state is not None and spec is not None:
            # speculation unusable for this batch shape (stream over
            # capacity, or the sentinel check fell through): same decay
            # as the tie-free case so a permanently-unusable workload
            # stops paying the discarded dispatch + d2h
            spec_state["idle"] = spec_state.get("idle", 0) + 1
            if spec_state["idle"] >= 4:
                spec_state["cap"] = 0
                spec_state["idle"] = 0
        winners = _np(winners_dev)
        W = winners.shape[1]
        counts = np.minimum(nw, W)
        gmat = winners[rows]
        mask = np.arange(W)[None, :] < counts[:, None]
        r_idx = np.repeat(rows, counts)
        g_idx = gmat[mask]
        return r_idx.astype(np.int32), g_idx.astype(np.int32), grp_rows, packed
    winners = _np(winners_dev)
    # rare: a read tied across more genes than the device compaction width;
    # recompute those rows with the host oracle
    from shark_tpu_torch.classify.oracle import classify_read

    shim = _ShimIndex(index)
    r_list: List[int] = []
    g_list: List[int] = []
    for j, i in enumerate(rows):
        if overflow[j]:
            row = (
                _unpack_row_np(codes[0][i], codes[1][i])
                if isinstance(codes, tuple)
                else codes[i]
            )
            wins, _, _ = classify_read(shim, row, cfg.c, cfg.single)
        else:
            wins = winners[i, : nw[j]].tolist()
        r_list.extend([int(i)] * len(wins))
        g_list.extend(int(g) for g in wins)
    return (
        np.asarray(r_list, dtype=np.int32),
        np.asarray(g_list, dtype=np.int32),
        grp_rows,
        packed,
    )


def _unpack_row_np(packed_row: np.ndarray, vmask_row: np.ndarray) -> np.ndarray:
    """Host-side unpack of one planar 2-bit packed read row (oracle
    fallback); layout per shark_tpu_torch.classify.step.unpack_codes."""
    c = np.concatenate([(packed_row >> (2 * r)) & 3 for r in range(4)])
    v = np.concatenate([(vmask_row >> r) & 1 for r in range(8)]).astype(bool)
    return np.where(v, c, 4).astype(np.uint8)


_PROGRESS_KEYS = (
    "sample1_path", "sample2_path", "batch_size", "max_read_len",
    "k", "c", "min_quality", "out1_path", "out2_path", "single",
    # index identity: resuming against a different reference/index would
    # silently mix classifications from two indexes in one output
    "fasta_path", "bf_gb", "load_index",
)


def _progress_identity(cfg: SharkConfig) -> dict:
    return {key: getattr(cfg, key) for key in _PROGRESS_KEYS}


def _load_progress(path: str, cfg: SharkConfig):
    """Validate + apply a resume checkpoint: truncate outputs to the
    recorded offsets and return the checkpoint state dict.
    Returns None (fresh start) when no checkpoint exists."""
    import json
    import os

    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            st = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise ValueError(
            f"resume checkpoint {path} is unreadable ({e}); remove it to "
            "restart from scratch"
        ) from e
    if st.get("identity") != _progress_identity(cfg):
        raise ValueError(
            f"resume checkpoint {path} was written by a different "
            "invocation (inputs/outputs/parameters differ)"
        )
    for out_path, off in zip(
        (cfg.ssv_path, cfg.out1_path, cfg.out2_path), st["offsets"]
    ):
        if off < 0 or not out_path:
            continue
        if not os.path.exists(out_path) or os.path.getsize(out_path) < off:
            raise ValueError(
                f"resume checkpoint {path} expects {out_path} to hold "
                f">= {off} bytes; refusing to resume"
            )
        os.truncate(out_path, off)
    return st


def _write_progress(path: str, cfg: SharkConfig, reads_done: int, offsets, counts):
    """Atomically replace the sidecar (tmp + fsync + rename). Crash-safety
    scope: process death (OOM, preemption, device loss). True power-loss
    durability would additionally require fsyncing the output files per
    batch, which this deliberately does not do."""
    import json
    import os

    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(
            {
                "identity": _progress_identity(cfg),
                "reads_done": reads_done,
                "offsets": list(offsets),
                "n_associations": counts[0],
                "n_reads_out": counts[1],
            },
            f,
        )
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _resume_state(cfg: SharkConfig):
    """--resume bookkeeping shared by the native classify paths:
    (progress_path, reads_done0, base_associations, base_reads_out).
    Validates the checkpointable-output constraints; all zeros/empty when
    resume is off or no sidecar matches this run's identity."""
    if not cfg.resume:
        return "", 0, 0, 0
    if not cfg.ssv_path:
        raise ValueError(
            "--resume requires --ssv FILE (stdout cannot be checkpointed)"
        )
    if cfg.out1_path.endswith(".gz") or cfg.out2_path.endswith(".gz"):
        raise ValueError(
            "--resume requires uncompressed output FASTQs (gzip cannot "
            "be truncated mid-member)"
        )
    progress_path = cfg.ssv_path + ".progress"
    st0 = _load_progress(progress_path, cfg)
    if st0 is None:
        return progress_path, 0, 0, 0
    return (
        progress_path,
        int(st0["reads_done"]),
        int(st0.get("n_associations", 0)),
        int(st0.get("n_reads_out", 0)),
    )


def _skip_resumed(ns, skip_left: int) -> None:
    """Consume the already-classified read prefix at parse speed (release
    each slot unclassified — no device/classify work, no output)."""
    while skip_left > 0:
        nb = ns.next_batch()
        if nb is None or nb[-1] > skip_left:
            raise ValueError(
                "resume checkpoint claims more classified reads than "
                "the sample holds at this batch size"
            )
        ns.release(nb[-2])
        skip_left -= nb[-1]


def _run_native(cfg: SharkConfig, index: SharkIndex, classifier, timer) -> dict:
    """Fast path: parse/encode/write in the native C++ engine, device in a
    DEPTH-deep software pipeline. Requires a fixed max_read_len.

    With cfg.resume, a `<ssv>.progress` sidecar records (reads classified,
    output byte offsets) after every drained batch; an interrupted run
    restarts by truncating the outputs to the last checkpoint, skipping the
    already-classified reads at parse speed (no device work),
    and appending — byte-identical to an uninterrupted run. The reference
    has no recovery story (SURVEY §5); a crash there restarts from zero."""
    from shark_tpu_torch.io.native import NativeStream

    progress_path, reads_done0, base_assoc, base_reads_out = _resume_state(
        cfg
    )

    use_packed = cfg.max_read_len % 8 == 0
    ns = NativeStream(
        cfg.sample1_path,
        cfg.sample2_path,
        cfg.batch_size,
        cfg.max_read_len,
        cfg.min_quality,
        packed=use_packed,
        # -t N provisions extra host encode threads (the reference's
        # worker-thread flag mapped to the one host stage that scales;
        # parse itself is sequential)
        encode_threads=max(1, min(cfg.threads - 1, 8)),
    )
    ns.set_output(
        1, cfg.ssv_path, cfg.out1_path, cfg.out2_path,
        append=reads_done0 > 0,
    )
    ns.register_genes(index.gene_names)

    # The drain (fetch verdicts -> winner pairs -> native emit) runs on its
    # own thread so the device never waits for host post-processing; the
    # bounded queue caps device-side in-flight batches. Packed verdicts of
    # GROUP consecutive batches are concatenated on device and fetched in
    # ONE device->host transfer.
    import queue as queue_mod
    import threading

    GROUP = max(1, cfg.fetch_group)
    DEPTH = max(1, 8 // GROUP)  # keep ~8 batches of device-side lookahead
    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=DEPTH)
    drain_err: List[BaseException] = []

    # warm-up: builds the CUDA kernels when missing or stale, and loads them
    if use_packed:
        wp = np.zeros((cfg.batch_size, cfg.max_read_len // 4), dtype=np.uint8)
        wv = np.zeros((cfg.batch_size, cfg.max_read_len // 8), dtype=np.uint8)
        _np(classifier.call_packed(wp, wv)[0])
    else:
        warm = np.full((cfg.batch_size, cfg.max_read_len), 4, dtype=np.uint8)
        _np(classifier(warm)[0])
    timer.mark("Device warmup")
    warm_s = timer.elapsed()

    # One drain thread, as in shark_tpu.
    reads_done = [reads_done0]  # drained reads (checkpoint counter)
    # Tie-heavy speculation: once a batch has taken the winner-pair-stream
    # path, the drain records the capacity here and the MAIN loop starts
    # dispatching extract_pairs right after each classify kernel (d2h copy
    # overlaps later device work; the drain then just reads the result).
    # Written by the drain thread, read by the main thread (GIL-safe).
    # Pre-arm the speculation for indexes that carry tie groups: their
    # workloads take the winner-pair-stream path from batch 0, which
    # otherwise pays one serial extract_pairs dispatch+fetch before the
    # first batch teaches the cap. A wrong guess self-corrects: the 4-batch
    # idle backoff disarms speculation, and _winner_pairs recomputes
    # exactly whenever a batch outgrows the speculated cap.
    pre_cap = (
        (1 << 14)
        if classifier.groups is not None
        and not cfg.single
        and cfg.batch_size <= 65536  # the pair stream's own B ceiling
        else 0
    )
    spec_state = {"cap": pre_cap}
    counters = {"group_rows": 0}  # device GROUP verdicts seen (tests)

    def drainer():
        while True:
            item = q.get()
            if item is None:
                return
            if drain_err:
                continue  # keep the queue moving so q.put never deadlocks
            entries, cat = item
            try:
                packed_all = cat.numpy()
                off = 0
                for c_, s_, n_, r_, spec_ in entries:
                    ri, gi = _winner_pairs(
                        cfg,
                        index,
                        r_,
                        n_,
                        c_,
                        cfg.max_winners,
                        packed_np=packed_all[off : off + cfg.batch_size],
                        spec=spec_,
                        spec_state=spec_state,
                        groups=classifier.groups,
                        counters=counters,
                    )
                    ns.emit(s_, ri, gi)
                    off += cfg.batch_size
                    reads_done[0] += n_
                    if progress_path:
                        _write_progress(
                            progress_path, cfg, reads_done[0], ns.tell(),
                            (
                                base_assoc + int(ns.n_associations),
                                base_reads_out + int(ns.n_reads_out),
                            ),
                        )
            except BaseException as e:  # noqa: BLE001 - reraised on main
                drain_err.append(e)

    n_groups = [0]  # flushed verdict groups (observability + tests)

    def flush_group(group):
        if not group:
            return
        n_groups[0] += 1
        cat = (
            torch.cat([e[3][0] for e in group])
            if len(group) > 1
            else group[0][3][0]
        )
        q.put((list(group), _HostCopy(cat)))
        group.clear()

    th = threading.Thread(target=drainer, daemon=True)
    th.start()
    n_reads = 0
    n_batches = 0
    group: List[tuple] = []
    try:
        _skip_resumed(ns, reads_done0)

        while not drain_err:
            nb = ns.next_batch()
            if nb is None:
                break
            if use_packed:
                packed, vmask, slot, n = nb
                host_codes = (packed, vmask)
                result = classifier.call_packed(packed, vmask)
            else:
                host_codes, slot, n = nb
                result = classifier(host_codes)
            spec = None
            spec_cap = spec_state["cap"]
            if spec_cap and not cfg.single:
                spec = (
                    _HostCopy(extract_pairs(result[0], result[1], spec_cap)),
                    spec_cap,
                )
            n_reads += n
            n_batches += 1
            group.append((host_codes, slot, n, result, spec))
            if len(group) == GROUP:
                flush_group(group)
            if cfg.fail_after_batches and n_batches >= cfg.fail_after_batches:
                raise RuntimeError("injected failure (fail_after_batches)")
        flush_group(group)
        q.put(None)
        th.join()
        if drain_err:
            raise drain_err[0]
    except BaseException:
        # crash path: drain whatever is queued (each drained batch still
        # advances the checkpoint), stop the drain thread, and close
        # without masking the original error; outputs + sidecar remain
        # for --resume
        try:
            q.put(None)
            th.join()
        except Exception:
            pass
        try:
            ns.close()
        except Exception:
            pass
        raise

    timer.mark("Sample completed")
    timer.rate("throughput", n_reads, "reads")
    elapsed = timer.elapsed()
    # whole-sample totals (resumed prefix counts come from the sidecar so
    # stats match the files); classify_s covers only this invocation —
    # subtract resumed_reads for throughput math
    stats = {
        "n_reads": n_reads + reads_done0,
        "n_associations": base_assoc + int(ns.n_associations),
        "n_reads_out": base_reads_out + int(ns.n_reads_out),
        "n_genes": index.n_genes,
        "elapsed_s": elapsed,
        "warmup_s": warm_s,
        "classify_s": elapsed - warm_s,
        "native": True,
        "fetch_groups": n_groups[0],
        "group_rows": counters["group_rows"],
        "probe": classifier.probe,
    }
    if reads_done0:
        stats["resumed_reads"] = reads_done0
    ns.close()
    if progress_path:
        import os

        if os.path.exists(progress_path):
            os.remove(progress_path)
    return stats


def load_or_build_index(cfg: SharkConfig, timer: PhaseTimer) -> SharkIndex:
    if cfg.load_index:
        index = SharkIndex.load(cfg.load_index)
        timer.mark("Index loaded")
        if index.k != cfg.k or index.size_bits != cfg.bf_bits:
            print(
                "[shark-tpu-torch] warning: loaded index overrides k/bf-size flags",
                file=sys.stderr,
            )
        return index
    index = None
    if cfg.use_native:
        from shark_tpu_torch.io.native import build_index_native

        # -t sets build parallelism exactly, like the reference's phase 1
        # (main.cpp:136-140): -t 1 (the default) builds serially so the
        # host stays quiet; -t 4 engages the parallel scan/sort/fill
        index = build_index_native(
            cfg.fasta_path, cfg.k, cfg.bf_bits, threads=max(1, cfg.threads)
        )
    if index is None:
        index = build_index(read_fasta(cfg.fasta_path), cfg.k, cfg.bf_bits)
    timer.mark(f"BF created from transcripts ({index.n_genes} genes)")
    if cfg.save_index:
        _start_index_save(index, cfg.save_index)
    return index


def _start_index_save(index: SharkIndex, path: str) -> None:
    """Serialize the index on a background thread (an .npz save of the
    default 2 GiB arrays is slow; it overlaps device warmup + the classify
    stream instead of delaying them). Writes to a .partial name and
    publishes with an atomic rename so an interrupted save never leaves a
    half-written index at the requested path. _join_index_save() reraises
    any failure before the pipeline reports success."""
    import threading

    err: List[BaseException] = []

    def _bg():
        try:
            import os
            import shutil

            if path.endswith(".npz"):
                tmp = path[:-4] + ".partial.npz"
            else:
                tmp = path.rstrip("/") + ".partial"
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            elif os.path.exists(tmp):
                os.remove(tmp)
            index.save(tmp)
            if os.path.isdir(path):
                shutil.rmtree(path)
            elif os.path.exists(path):
                os.remove(path)
            os.replace(tmp, path)
        except BaseException as e:  # noqa: BLE001 - reraised on join
            err.append(e)

    # non-daemon: the interpreter joins it at exit, so even callers that
    # never reach _join_index_save get a complete (or cleanly absent) file
    th = threading.Thread(target=_bg, daemon=False)
    th.start()
    index.__dict__["_save_thread"] = (th, err)


def _join_index_save(index: SharkIndex, timer: PhaseTimer) -> None:
    pending = index.__dict__.pop("_save_thread", None)
    if pending is None:
        return
    th, err = pending
    th.join()
    if err:
        raise err[0]
    timer.mark("Index saved")


def _start_len_scan(cfg: SharkConfig, ssv_stream):
    """Start the auto-length sample scan on a background thread when the
    native path would use it; returns a join() -> max_fused callable, or
    None when auto-length does not apply (explicit --max-read-len, resume,
    Python-path runs, non-regular inputs, no native engine).

    The scan is EXACT (whole sample), so no mid-run "read longer than
    max_len" restart can ever fire — which matters because ssv may stream
    to stdout, where a restart could not truncate already-emitted
    associations. Scan failures (malformed input) return 0: the run falls
    through to the Python path, which reports the error with full record
    context."""
    if not (
        cfg.use_native
        and ssv_stream is None
        and not cfg.max_read_len
        and not cfg.resume
    ):
        return None
    from shark_tpu_torch.io import native as native_mod

    if not native_mod.available() or not _regular_files(
        cfg.sample1_path, cfg.sample2_path
    ):
        return None
    import threading

    out = {}

    def _scan():
        try:
            out["mf"] = native_mod.scan_max_fused(
                cfg.sample1_path, cfg.sample2_path
            )
        except (OSError, ValueError):
            out["mf"] = 0

    th = threading.Thread(target=_scan, daemon=True)
    th.start()

    def join() -> int:
        th.join()
        return out.get("mf", 0)

    return join


def _regular_files(*paths: str) -> bool:
    """True iff every non-empty path is a regular file (the auto-length
    pre-pass reads the sample twice, which a FIFO/stream cannot replay)."""
    import os
    import stat

    for p in paths:
        if not p:
            continue
        try:
            if not stat.S_ISREG(os.stat(p).st_mode):
                return False
        except OSError:
            return False
    return True


def _smoke_check_inputs(cfg: SharkConfig) -> None:
    """Open/close every input up front so missing files fail before any
    expensive work (the reference's pre-flight block, main.cpp:86-106)."""
    import os

    paths = [] if cfg.load_index else [cfg.fasta_path]
    if cfg.load_index:
        paths.append(cfg.load_index)
    paths.append(cfg.sample1_path)
    if cfg.sample2_path:
        paths.append(cfg.sample2_path)
    for p in paths:
        if os.path.isdir(p):  # directory-format index
            continue
        with open(p, "rb"):
            pass


def run_pipeline(
    cfg: SharkConfig, ssv_stream=None, classifier=None, device=None
) -> dict:
    """Run the full reference-equivalent pipeline. Returns run stats.
    `classifier` reuses a warm device classifier (bench repeat passes); its
    index must match the config. `device`: None = cfg.backend's choice
    (the CUDA card, or the CPU for --backend cpu); "cpu" asks for the
    plain PyTorch versions."""
    cfg.validate()
    cfg.finalize_outputs()
    _smoke_check_inputs(cfg)
    if device is None and cfg.backend == "cpu":
        device = "cpu"
    if classifier is None:
        # fail before the index build when there is no card to run on
        device = resolve_device(device)
    timer = PhaseTimer()
    return _run_pipeline_inner(cfg, ssv_stream, timer, classifier, device)


def _probe_opts(cfg: SharkConfig) -> dict:
    """Probe-table build options from the config. -t above the default
    raises the native pack/scan parallelism past its min(4, cpu) default
    (larger hosts); the unconfigured -t 1 keeps that default rather than
    forcing a single-threaded build. With a persisted index
    (--save-index/--load-index) the packed probe tables cache in a
    sibling "<index>.tables" directory (classify/table_cache.py: content-
    digest keyed, crc-verified — a stale or corrupt cache is detected and
    rebuilt)."""
    import os as _os

    default_t = min(4, _os.cpu_count() or 1)
    # -t never LOWERS the build below its min(4, cpu) default
    opts = (
        {"threads": max(cfg.threads, default_t)} if cfg.threads > 1 else {}
    )
    idx_path = cfg.load_index or cfg.save_index
    if idx_path:
        opts["cache_dir"] = idx_path.rstrip("/") + ".tables"
    return opts


def _run_pipeline_inner(
    cfg: SharkConfig, ssv_stream, timer: PhaseTimer, classifier, device
) -> dict:

    if cfg.verbose:
        print(f"Reference texts: {cfg.fasta_path}", file=sys.stderr)
        print(f"Sample 1: {cfg.sample1_path}", file=sys.stderr)
        if cfg.paired:
            print(f"Sample 2: {cfg.sample2_path}", file=sys.stderr)
        print(f"K-mer length: {cfg.k}", file=sys.stderr)
        print(f"Threshold value: {cfg.c}", file=sys.stderr)
        print(
            f"Only single associations: {'Yes' if cfg.single else 'No'}",
            file=sys.stderr,
        )
        print(f"Minimum base quality: {cfg.min_quality}", file=sys.stderr)
        print(file=sys.stderr)

    # Auto-length pre-scan (parse-only pass over the sample, exact max
    # fused length) overlapped with the index build. ctypes releases the
    # GIL for the whole native call.
    join_scan = _start_len_scan(cfg, ssv_stream)

    if classifier is not None:
        index = classifier.index
        timer.mark("Classifier reused")
    else:
        index = load_or_build_index(cfg, timer)
    index_s = timer.elapsed()

    if classifier is None:
        classifier = Classifier(
            index, max_winners=cfg.max_winners, c=cfg.c, device=device,
            probe=None if cfg.probe == "auto" else cfg.probe,
            probe_opts=_probe_opts(cfg),
        )

    if cfg.use_native and ssv_stream is None:
        from shark_tpu_torch.io import native as native_mod

        native_len = cfg.max_read_len
        if join_scan is not None:
            mf = join_scan()
            if mf > AUTO_NATIVE_MAX_LEN:
                # one long read would pad EVERY fixed-geometry batch to its
                # length; the Python path pads per batch instead. Say so:
                # the Python path is an order of magnitude slower and the
                # silent switch otherwise looks like an unexplained stall.
                print(
                    f"[shark-tpu-torch] longest fused read ({mf}) exceeds the "
                    f"native engine's auto-length ceiling "
                    f"({AUTO_NATIVE_MAX_LEN}); using the slower per-batch-"
                    "padded Python path (set --max-read-len to force the "
                    "native engine)",
                    file=sys.stderr,
                )
                mf = 0
            if mf > 0:
                native_len = _round_len(mf, cfg.k)
                if cfg.verbose:
                    print(
                        f"[shark-tpu-torch] auto max_read_len {native_len} "
                        f"(longest fused read: {mf})",
                        file=sys.stderr,
                    )
        if native_len and native_mod.available():
            ncfg = cfg
            if native_len != cfg.max_read_len:
                from dataclasses import replace

                ncfg = replace(cfg, max_read_len=native_len)
            stats = _run_native(ncfg, index, classifier, timer)
            stats["index_s"] = index_s
            stats["warmup_s"] -= index_s
            stats["classify_s"] = stats["elapsed_s"] - index_s - stats["warmup_s"]
            if native_len != cfg.max_read_len:
                stats["auto_max_read_len"] = native_len
            _join_index_save(index, timer)
            return stats

    if cfg.resume:
        raise ValueError(
            "--resume requires the native engine and a fixed --max-read-len"
        )

    own_ssv = None
    if ssv_stream is None and cfg.ssv_path:
        own_ssv = open(cfg.ssv_path, "w")
    writer = OutputWriter(
        ssv_stream or own_ssv or sys.stdout, cfg.out1_path, cfg.out2_path
    )

    warmed = False
    if cfg.max_read_len:
        # Known geometry: pay the kernels' build and load before the
        # timed stream.
        warm = np.full(
            (cfg.batch_size, cfg.max_read_len), 4, dtype=np.uint8
        )
        _np(classifier(warm)[0])
        timer.mark("Device warmup")
        warmed = True
    warm_s = timer.elapsed()

    n_reads = 0
    pending: List[Tuple[ReadBatch, tuple]] = []
    DEPTH = 3  # device/host overlap depth
    for batch in _batches(cfg):
        if not warmed:
            # Auto-length mode: charge the first compile (and session
            # spin-up) to warmup, not to the serving stream, as soon as
            # the first batch's geometry is known.
            _np(classifier(np.full_like(batch.codes, 4))[0])
            timer.mark("Device warmup")
            warm_s = timer.elapsed()
            warmed = True
        result = classifier(batch.codes)  # async dispatch
        pending.append((batch, result))
        n_reads += batch.n
        if len(pending) > DEPTH:
            b, res = pending.pop(0)
            _drain(
                cfg, index, b, res, writer, cfg.max_winners,
                groups=classifier.groups,
            )
    for b, res in pending:
        _drain(
            cfg, index, b, res, writer, cfg.max_winners,
            groups=classifier.groups,
        )
    writer.close()
    if own_ssv is not None:
        own_ssv.close()
    _join_index_save(index, timer)

    timer.mark("Sample completed")
    timer.rate("throughput", n_reads, "reads")
    elapsed = timer.elapsed()
    return {
        "n_reads": n_reads,
        "n_associations": writer.n_associations,
        "n_reads_out": writer.n_reads_out,
        "n_genes": index.n_genes,
        "elapsed_s": elapsed,
        "index_s": index_s,
        "warmup_s": warm_s - index_s,
        "classify_s": elapsed - warm_s,
        "probe": classifier.probe,
    }
