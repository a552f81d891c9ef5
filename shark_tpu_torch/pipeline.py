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
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from shark_tpu_torch import kernels
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
from shark_tpu_torch.io import native as native_mod
from shark_tpu_torch.io.encode import ReadBatch, encode_batch, fused_length
from shark_tpu_torch.io.fastx import read_fasta, read_fastq_pairs
from shark_tpu_torch.io.pystream import PyStream
from shark_tpu_torch.parallel.mesh import make_devices
from shark_tpu_torch.utils.timers import (
    PhaseTimer,
    Spans,
    all_threads_config,
    recording,
    span,
)

FastqRecord = Tuple[str, bytes, bytes]

# Rows the drain recomputed with the host oracle (a read tied across more
# genes than max_winners, or a verdict the device flagged as overflowed),
# counted since the last reset; the tests read it to know the path ran.
HOST_ROWS = kernels.LaunchCounter(("oracle",))

# The drain's counts of a pass (_winner_pairs), in Spans.counts and the
# pass's stats: GROUP verdicts and the batches that held any, (read, gene)
# pairs and the reads with several, and the batches the engine decoded
# without the numpy path.
DRAIN_COUNTS = ("group_rows", "group_batches", "assoc", "tied_reads",
                "native_decode_batches")


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


def _winner_pairs(
    cfg: SharkConfig,
    index: SharkIndex,
    result,
    n: int,
    codes: np.ndarray,
    max_winners: int,
    packed_np: Optional[np.ndarray] = None,
    reprobe=None,
    spec=None,
    spec_state: Optional[dict] = None,
    groups=None,
    counters: Optional[dict] = None,
    decoder=None,
):
    """Device result -> (read_idx, gene_idx) association arrays, read-ascending,
    genes ascending within a read (the reference's emission order,
    ReadAnalyzer.hpp:104-108 + ReadOutput.hpp:43-48). `packed_np` supplies a
    pre-fetched packed-verdict array (grouped-fetch fast path); `reprobe`
    (sharded-BF spill-and-retry) re-runs the batch with a larger routing
    cap when its result reports dropped probes; `groups` (GeneGroups)
    expands
    device GROUP verdicts (PACK_GRP: tie-heavy reads scored as one deduped
    gene set) into their member lists.

    `spec` carries a SPECULATIVE (pairs _HostCopy, cap) pre-dispatched by
    the main loop right after the classify kernels (its d2h copy overlaps
    later batches' device work instead of round-tripping from the drain
    thread); it is used when this batch's winner stream fits `cap`,
    recomputed exactly otherwise. `spec_state` ({"cap": int}) is how this
    function tells the main loop that the workload is tie-heavy and which
    capacity to speculate with (0 = don't).

    `counters` (the pass's Spans.counts) gains the batch's DRAIN_COUNTS.

    `decoder` (io/native.py VerdictDecoder) decodes the batch in the
    engine where it can (_decode_native); the arrays returned are then
    its buffers, valid until its next call."""
    got = (
        _decode_native(cfg, result, n, max_winners, packed_np, spec,
                       spec_state, decoder)
        if decoder is not None
        else None
    )
    if got is not None:
        ri, gi, n_grp, tied = got
    else:
        ri1, gi1, grp_rows, packed = _winner_pairs_base(
            cfg, index, result, n, codes, max_winners,
            packed_np=packed_np, reprobe=reprobe, spec=spec,
            spec_state=spec_state,
        )
        if grp_rows.size == 0:
            ri, gi = ri1, gi1
        else:
            with span("group_expand"):
                ri, gi = _expand_groups(groups, packed, grp_rows, ri1, gi1,
                                        n)
        n_grp, tied = grp_rows.size, None
    if counters is not None:
        for name, v in (
            ("group_rows", n_grp),
            ("group_batches", n_grp > 0),
            ("assoc", ri.size),
            ("tied_reads", _tied_reads(ri) if tied is None else tied),
            ("native_decode_batches", got is not None),
        ):
            counters[name] = counters.get(name, 0) + int(v)
    return ri, gi


def _decode_native(cfg, result, n, max_winners, packed_np, spec,
                   spec_state, decoder):
    """_winner_pairs_base and _expand_groups in the engine, with the
    interpreter lock released: (ri, gi, GROUP rows, reads with several),
    or None where the batch needs the numpy path, which is chosen from
    the batch itself: a sharded-BF result (its overflow counter and
    reprobe), a row the device flagged as overflowed or tied past
    max_winners, a tie batch whose pair stream cannot be had (-s, B past
    65536, or past B * max_winners pairs) or is not exact, a GROUP
    verdict without GeneGroups. A tie batch with no speculated stream, or
    one too short, fetches its own (extract_pairs) as the numpy path
    does, and decodes again. spec_state learns what it learns there."""
    if len(result) > 4:
        return None
    packed_dev = result[0]
    packed = packed_np if packed_np is not None else _np(packed_dev)
    B = int(packed_dev.shape[0])
    streams = not cfg.single and B <= 65536
    pairs = _np(spec[0]) if spec is not None and streams else None
    got, ri, gi = decoder.decode(packed, n, pairs, max_winners, cfg.single)
    if got == native_mod.DECODE_NEED_PAIRS and streams:
        total = int(decoder.info[3])
        BW = B * max_winners
        if total + 2 > BW:
            return None
        pairs = _np(extract_pairs(packed_dev, result[1], _pair_cap(total, BW)))
        got, ri, gi = decoder.decode(packed, n, pairs, max_winners,
                                     cfg.single)
    if got < 0:
        return None
    kind = int(decoder.info[4])
    if kind == 2:
        _spec_hit(spec_state, _pair_cap(int(decoder.info[3]),
                                        B * max_winners))
    elif kind == 1 and spec is not None:
        _spec_idle(spec_state)
    n_grp = int(decoder.info[2])
    if not n_grp:
        return ri, gi, 0, int(decoder.info[1])
    with span("group_expand"):
        got, ri, gi, tied = decoder.expand(packed, got)
    return None if got < 0 else (ri, gi, n_grp, tied)


def _pair_cap(total: int, BW: int) -> int:
    """The pair stream's length for `total` pairs: shark_tpu's levels
    {2^14, 2^17, 2^19, B*W} (the stream's length is part of what both
    packages compare), the least that holds total + 2."""
    return next(
        (
            min(lv, BW)
            for lv in ((1 << 14), (1 << 17), (1 << 19))
            if min(lv, BW) >= total + 2
        ),
        BW,
    )


def _spec_hit(spec_state: Optional[dict], cap: int) -> None:
    """A batch took the pair stream: the main loop speculates with at
    least `cap` from now on."""
    if spec_state is not None:
        spec_state["cap"] = max(spec_state.get("cap", 0), cap)
        spec_state["idle"] = 0


def _spec_idle(spec_state: Optional[dict]) -> None:
    """A speculated stream went unused; after four in a row (a tie-heavy
    region followed by a tie-free one, or a workload whose streams never
    fit) the main loop stops paying the dispatch + d2h copy — the next
    tie batch re-engages it."""
    if spec_state is not None:
        spec_state["idle"] = spec_state.get("idle", 0) + 1
        if spec_state["idle"] >= 4:
            spec_state["cap"] = 0
            spec_state["idle"] = 0


def _tied_reads(ri: np.ndarray) -> int:
    """Reads that occur two or more times in the read-ascending `ri`."""
    same = ri[1:] == ri[:-1]
    return int(same[:1].sum()) + int(np.count_nonzero(same[1:] > same[:-1]))


def _expand_groups(groups, packed, grp_rows, ri1, gi1, n: int):
    """_winner_pairs' GROUP verdicts (rows `grp_rows` of `packed`)
    expanded into their member lists and merged with the other verdicts'
    pairs (ri1, gi1), read-ascending."""
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
    reprobe=None,
    spec=None,
    spec_state: Optional[dict] = None,
):
    """(read_idx, gene_idx, emitted_group_rows, packed) for the non-group
    verdicts; group rows (PACK_GRP) are returned for the caller to expand."""
    if len(result) > 4:  # sharded-BF routing overflow counter
        ovf = int(_np(result[4]).sum())
        if ovf and reprobe is not None:
            # The one piece of device work the drain thread issues: it
            # fires only on a routing overflow, which the adaptive cap
            # keeps at zero for uniform XXH64 hashing. Replaying the batch
            # from the dispatch thread would mean re-ordering the native
            # emit for a case that does not fire in practice. reprobe
            # launches on this thread's current stream and returns with
            # its result complete (ShardedBFClassifier.reprobe).
            print(
                f"[shark-tpu-torch] routing overflow ({ovf} probes), "
                "retrying batch with a larger cap",
                file=sys.stderr,
            )
            result = reprobe(codes)
            packed_np = None  # the grouped pre-fetch is stale for this batch
            spec = None  # ... as is any speculative pair stream
            ovf = int(_np(result[4]).sum())
        if ovf:
            raise RuntimeError(
                f"sharded-BF probe bucket overflow ({ovf} probes dropped); "
                "increase the routing slack"
            )
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
        if spec is not None:
            _spec_idle(spec_state)  # the speculated stream went unused
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
            cap = _pair_cap(total, BW)
            if total + 2 <= BW:
                _spec_hit(spec_state, cap)
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
        if spec is not None:
            # speculation unusable for this batch shape (stream over
            # capacity, or the sentinel check fell through)
            _spec_idle(spec_state)
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
            HOST_ROWS.add("oracle")
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


class _Resume(NamedTuple):
    """A pass's --resume state: the sidecar ("" when resume is off), the
    reads it records as classified and its output counts."""

    path: str = ""
    reads_done: int = 0
    assoc: int = 0
    reads_out: int = 0


def _write_progress(cfg: SharkConfig, resume: _Resume, stream, reads_done):
    """After a drained batch, with --resume: atomically replace the
    sidecar (tmp + fsync + rename). Crash-safety scope: process death
    (OOM, preemption, device loss). True power-loss durability would
    additionally require fsyncing the output files per batch, which this
    deliberately does not do."""
    import json

    if not resume.path:
        return
    tmp = resume.path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(
            {
                "identity": _progress_identity(cfg),
                "reads_done": reads_done,
                "offsets": list(stream.tell()),
                "n_associations": resume.assoc + int(stream.n_associations),
                "n_reads_out": resume.reads_out + int(stream.n_reads_out),
            },
            f,
        )
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, resume.path)


def _resume_state(cfg: SharkConfig) -> _Resume:
    """--resume bookkeeping shared by the engine's loops. Validates the
    checkpointable-output constraints; all zeros/empty when resume is off
    or no sidecar matches this run's identity."""
    if not cfg.resume:
        return _Resume()
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
        return _Resume(progress_path)
    return _Resume(
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


def _open_engine(cfg: SharkConfig, index: SharkIndex, packed: bool,
                 resume: _Resume):
    """The native engine's NativeStream over the sample, writing the
    pass's outputs (appended to after a resumed prefix)."""
    from shark_tpu_torch.io.native import NativeStream

    ns = NativeStream(
        cfg.sample1_path,
        cfg.sample2_path,
        cfg.batch_size,
        cfg.max_read_len,
        cfg.min_quality,
        packed=packed,
        # -t N provisions extra host encode threads (the reference's
        # worker-thread flag mapped to the one host stage that scales;
        # parse itself is sequential)
        encode_threads=max(1, min(cfg.threads - 1, 8)),
        k=cfg.k,
    )
    ns.set_output(
        1, cfg.ssv_path, cfg.out1_path, cfg.out2_path,
        append=resume.reads_done > 0,
    )
    ns.register_genes(index.gene_names)
    return ns


def _finish(cfg: SharkConfig, index: SharkIndex, stream, timer: PhaseTimer,
            resume: _Resume, n_reads: int, warm_s: float, **extra) -> dict:
    """The end of a pass of either engine loop: its stats, the stream
    closed and the resume sidecar removed. The counts are whole-sample
    totals (a resumed prefix's come from the sidecar, so they match the
    files); classify_s covers only this invocation, so throughput math
    subtracts resumed_reads. warmup_s is the time since the run began, of
    which run_pipeline takes index_s off."""
    timer.mark("Sample completed")
    timer.rate("throughput", n_reads, "reads")
    elapsed = timer.elapsed()
    stats = {
        "n_reads": n_reads + resume.reads_done,
        "n_associations": resume.assoc + int(stream.n_associations),
        "n_reads_out": resume.reads_out + int(stream.n_reads_out),
        "n_genes": index.n_genes,
        "elapsed_s": elapsed,
        "warmup_s": warm_s,
        "classify_s": elapsed - warm_s,
        **extra,
        "engine": stream.stats(),
    }
    if resume.reads_done:
        stats["resumed_reads"] = resume.reads_done
    stream.close()
    if resume.path and os.path.exists(resume.path):
        os.remove(resume.path)
    return stats


def _run_native(
    cfg: SharkConfig, index: SharkIndex, classifier, timer, spans: Spans,
    stream, resume: _Resume,
) -> dict:
    """The one loop that serves a device run, fed by either of two streams
    of one interface: the native C++ engine's NativeStream (parse, encode
    and write in C++; planar 2-bit batches, or byte codes where a fixed
    max_read_len is not a multiple of 8) or the Python I/O path's PyStream
    (byte codes). The card runs in a DEPTH-deep software pipeline.
    cfg.max_read_len 0 is the auto geometry: each batch comes at
    _round_len(its longest fused read), the warm-up runs at the first
    batch's width, and stats["auto_max_read_len"] is the widest batch.
    `spans` is the pass's record (run_pipeline): the drain thread records
    into it too, and it keeps the drain's counts, among them
    "batch_geometries" (the distinct widths the pass ran) and
    "narrow_batches" (batches narrower than its widest).

    With cfg.resume (the engine only), a `<ssv>.progress` sidecar records
    (reads classified, output byte offsets) after every drained batch; an
    interrupted run restarts by truncating the outputs to the last
    checkpoint, skipping the already-classified reads at parse speed (no
    device work), and appending — byte-identical to an uninterrupted run.
    The reference has no recovery story (SURVEY §5); a crash there
    restarts from zero."""
    # The drain (fetch verdicts -> winner pairs -> emit) runs on its own
    # thread so the device never waits for host post-processing; the
    # bounded queue caps device-side in-flight batches. Each batch's
    # packed verdicts leave the card in one device->host copy.
    import queue as queue_mod
    import threading

    DEPTH = 8  # batches of device-side lookahead
    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=DEPTH)
    drain_err: List[BaseException] = []
    scale = 4 if stream.packed else 1  # bases a column of a batch

    # One drain thread, as in shark_tpu.
    reads_done = [resume.reads_done]  # drained reads (checkpoint counter)
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
    # the drain's decode in the engine; its buffers, made on the drain
    # thread's first batch, serve the pass
    decoder = native_mod.verdict_decoder(classifier.groups)
    for name in DRAIN_COUNTS:
        spans.counts[name] = 0

    def drainer():
        with recording(spans, "drain"):
            drain()

    def drain():
        while True:
            item = q.get()
            if item is None:
                return
            if drain_err:
                continue  # keep the queue moving so q.put never deadlocks
            codes, slot, n, result, spec, copy = item
            try:
                with span("fetch_wait"):
                    packed_np = copy.numpy()
                with span("winner_pairs"):
                    ri, gi = _winner_pairs(
                        cfg,
                        index,
                        result,
                        n,
                        codes,
                        cfg.max_winners,
                        packed_np=packed_np,
                        reprobe=getattr(classifier, "reprobe", None),
                        spec=spec,
                        spec_state=spec_state,
                        groups=classifier.groups,
                        counters=spans.counts,
                        decoder=decoder,
                    )
                with span("emit"):
                    stream.emit(slot, ri, gi)
                reads_done[0] += n
                _write_progress(cfg, resume, stream, reads_done[0])
            except BaseException as e:  # noqa: BLE001 - reraised on main
                drain_err.append(e)

    th = threading.Thread(target=drainer, daemon=True)
    th.start()
    n_reads = 0
    n_batches = 0
    widths: List[int] = []  # each batch's width, in order
    try:
        # the auto geometry knows a width once the first batch is read:
        # that batch waits here, and the dispatch loop takes it first
        taken = []
        warm_len = cfg.max_read_len
        if not warm_len:
            with span("ring_wait"):
                taken.append(stream.next_batch())
            warm_len = taken[0][0].shape[1] * scale if taken[0] else 0
        # warm-up: builds the CUDA kernels when missing or stale, and
        # loads them
        if warm_len:
            with span("warmup_batch"):
                if stream.packed:
                    wp = np.zeros((cfg.batch_size, warm_len // 4),
                                  dtype=np.uint8)
                    wv = np.zeros((cfg.batch_size, warm_len // 8),
                                  dtype=np.uint8)
                    _np(classifier.call_packed(wp, wv)[0])
                else:
                    warm = np.full((cfg.batch_size, warm_len), 4,
                                   dtype=np.uint8)
                    _np(classifier(warm)[0])
        timer.mark("Device warmup")
        warm_s = timer.elapsed()

        _skip_resumed(stream, resume.reads_done)
        while not drain_err:
            if taken:
                nb = taken.pop()
            else:
                with span("ring_wait"):
                    nb = stream.next_batch()
            if nb is None:
                break
            widths.append(nb[0].shape[1] * scale)
            if stream.packed:
                packed, vmask, slot, n = nb
                codes = (packed, vmask)
                result = classifier.call_packed(packed, vmask)
            else:
                codes, slot, n = nb
                result = classifier(codes)
            spec = None
            spec_cap = spec_state["cap"]
            if spec_cap and not cfg.single:
                with span("spec_pairs"):
                    spec = (
                        _HostCopy(
                            extract_pairs(result[0], result[1], spec_cap)
                        ),
                        spec_cap,
                    )
            with span("group_copy"):  # the batch's one verdict fetch
                copy = _HostCopy(result[0])
            with span("queue_wait"):
                q.put((codes, slot, n, result, spec, copy))
            n_reads += n
            n_batches += 1
            if cfg.fail_after_batches and n_batches >= cfg.fail_after_batches:
                raise RuntimeError("injected failure (fail_after_batches)")
        with span("drain_join"):
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
            stream.close()
        except Exception:
            pass
        raise

    widest = max(widths, default=0)
    spans.counts["batch_geometries"] = len(set(widths))
    spans.counts["narrow_batches"] = sum(w < widest for w in widths)
    stats = _finish(
        cfg, index, stream, timer, resume, n_reads, warm_s,
        native=not isinstance(stream, PyStream),
        fetch_groups=n_batches,
        **{name: spans.counts[name] for name in DRAIN_COUNTS},
        batch_geometries=spans.counts["batch_geometries"],
        narrow_batches=spans.counts["narrow_batches"],
        probe=classifier.probe,
    )
    if not cfg.max_read_len and widest:
        stats["auto_max_read_len"] = widest
    return stats


def _run_native_host(cfg: SharkConfig, index: SharkIndex, timer: PhaseTimer) -> dict:
    """--backend native: the pure-CPU serving path, with no device at all
    (no CUDA call, no kernel). Parse/encode/emit run in the native engine
    exactly as on the card's path; classification runs in
    shk_host_classify worker threads against the dense index arrays with
    oracle-exact semantics. -t maps to classify workers, the reference's
    phase-3 threading model (main.cpp:219-223), with deterministic
    input-order output regardless of thread count. Resumes like
    _run_native (a <ssv>.progress sidecar after every batch)."""
    from shark_tpu_torch.io.native import host_classify

    resume = _resume_state(cfg)
    # host classify consumes byte codes directly
    ns = _open_engine(cfg, index, False, resume)
    timer.mark("Host classify ready")
    warm_s = timer.elapsed()
    n_reads = 0
    try:
        _skip_resumed(ns, resume.reads_done)
        while True:
            with span("ring_wait"):
                nb = ns.next_batch()
            if nb is None:
                break
            codes, slot, n = nb
            ri, gi = host_classify(
                index, codes, n, cfg.c, cfg.single,
                threads=max(1, cfg.threads),
            )
            with span("emit"):
                ns.emit(slot, ri, gi)
            n_reads += n
            _write_progress(cfg, resume, ns, resume.reads_done + n_reads)
    except BaseException:
        try:
            ns.close()
        except Exception:
            pass
        raise
    return _finish(cfg, index, ns, timer, resume, n_reads, warm_s,
                   native=True, probe="host")


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
    """Start --backend native's auto-length sample scan on a background
    thread, overlapped with the index build; returns a join() -> max_fused
    callable, or None when it does not apply (another backend, explicit
    --max-read-len, resume, non-regular inputs, no native engine). The
    device path needs no scan: the engine packs each batch at its own
    width (_run_native).

    The scan is EXACT (whole sample): host classify takes one byte-code
    width for the whole sample, and a mid-run "read longer than max_len"
    restart could not truncate associations already streamed to stdout.
    Scan failures (malformed input) return 0."""
    if not (
        cfg.backend == "native"
        and cfg.use_native
        and ssv_stream is None
        and not cfg.max_read_len
        and not cfg.resume
    ):
        return None
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
    expensive work (the reference's pre-flight block, main.cpp:86-106).
    A sample that is not a regular file (a FIFO) is only checked for read
    access: opening it would take its writer's data from the one reader
    that needs it."""
    paths = [] if cfg.load_index else [cfg.fasta_path]
    if cfg.load_index:
        paths.append(cfg.load_index)
    paths.append(cfg.sample1_path)
    if cfg.sample2_path:
        paths.append(cfg.sample2_path)
    for p in paths:
        if os.path.isdir(p):  # directory-format index
            continue
        if os.path.exists(p) and not _regular_files(p):
            if not os.access(p, os.R_OK):
                raise PermissionError(f"cannot read {p}")
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
    plain PyTorch versions. --backend native touches no device.

    A device run has one loop, _run_native, and two streams that feed it:
    the native engine's, or the Python I/O path's (PyStream) for
    --no-native, an engine that does not build, or an `ssv_stream` (a
    text stream the associations are written to)."""
    cfg.validate()
    cfg.finalize_outputs()
    _smoke_check_inputs(cfg)
    if cfg.backend == "native":
        device = None
    else:
        if device is None and cfg.backend == "cpu":
            device = "cpu"
        if classifier is None:
            # fail before the index build when there is no card to run on
            device = resolve_device(device)
    timer = PhaseTimer()
    with _profiled(cfg, device, classifier):
        spans = Spans()
        with recording(spans, "dispatch"):
            stats = _run_pipeline_inner(
                cfg, ssv_stream, timer, classifier, device, spans
            )
    # the pass's spans (timers.Spans): {name: {"n", "ms"}}, and the time
    # inside each thread's outermost spans
    stats["spans"] = spans.summary()
    stats["spans_covered_ms"] = spans.covered_ms()
    return stats


def _profiled(cfg: SharkConfig, device, classifier):
    """--profile-dir: a torch.profiler profile around the run, whose Chrome
    trace (<profile_dir>/<host>_<pid>.<time>.pt.trace.json) is written when
    the run ends, also when it raises. It records the host's torch
    operators and the pass's spans on every thread (the drain's too,
    where this torch can), and the card's kernels and copies when the run
    is on the card; --backend native records the host only. Else a null
    context."""
    import contextlib

    if not cfg.profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    dev = classifier.device if classifier is not None else device
    activities = [ProfilerActivity.CPU]
    if dev is not None and torch.device(dev).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(
        activities=activities,
        on_trace_ready=tensorboard_trace_handler(cfg.profile_dir),
        experimental_config=all_threads_config(),
    )


def _probe_opts(cfg: SharkConfig) -> dict:
    """Probe-table build options from the config. -t above the default
    raises the native pack/scan parallelism past its min(4, cpu) default
    (larger hosts); the unconfigured -t 1 keeps that default rather than
    forcing a single-threaded build. With a persisted index
    (--save-index/--load-index) the packed probe tables cache in a
    sibling "<index>.tables" directory (classify/table_cache.py: content-
    digest keyed, crc-verified — a stale or corrupt cache is detected and
    rebuilt)."""
    default_t = min(4, os.cpu_count() or 1)
    # -t never LOWERS the build below its min(4, cpu) default
    opts = (
        {"threads": max(cfg.threads, default_t)} if cfg.threads > 1 else {}
    )
    idx_path = cfg.load_index or cfg.save_index
    if idx_path:
        opts["cache_dir"] = idx_path.rstrip("/") + ".tables"
    return opts


def _run_pipeline_inner(
    cfg: SharkConfig, ssv_stream, timer: PhaseTimer, classifier, device,
    spans: Spans,
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

    # --backend native's auto-length pre-scan (parse-only pass over the
    # sample, exact max fused length) overlapped with the index build.
    # ctypes releases the GIL for the whole native call.
    join_scan = _start_len_scan(cfg, ssv_stream)

    if classifier is not None:
        index = classifier.index
        timer.mark("Classifier reused")
    else:
        index = load_or_build_index(cfg, timer)
    index_s = timer.elapsed()

    if cfg.backend == "native":
        # pure-CPU serving path: classification in the native engine, no
        # device anywhere (_run_native_host)
        if not native_mod.available():
            raise RuntimeError(
                "--backend native requires the native engine (g++ on PATH)"
            )
        if ssv_stream is not None or classifier is not None:
            raise ValueError(
                "--backend native streams output through the native "
                "engine; ssv_stream / device classifiers do not apply"
            )
        # device flags would be SILENTLY skipped by this early return; a
        # user asking for them wants the device path, so say so
        if cfg.sharded_bf or cfg.devices > 1:
            raise ValueError(
                "--backend native is the single-host pure-CPU path; "
                "--sharded-bf/--devices require a device backend"
            )
        if cfg.probe != "auto":
            print(
                "[shark-tpu-torch] note: --probe selects a DEVICE table "
                "layout; --backend native classifies on the CPU and "
                "ignores it",
                file=sys.stderr,
            )
        native_len = cfg.max_read_len
        if not native_len:
            if join_scan is None and not _regular_files(
                cfg.sample1_path, cfg.sample2_path
            ):
                raise ValueError(
                    "--backend native with non-seekable input requires "
                    "--max-read-len (the auto-length pre-pass reads the "
                    "sample twice)"
                )
            with span("prescan_wait"):
                mf = join_scan() if join_scan is not None else (
                    native_mod.scan_max_fused(cfg.sample1_path,
                                              cfg.sample2_path)
                )
            # host classify iterates rows, so long reads only cost
            # memory; an empty sample still needs a valid batch geometry
            native_len = _round_len(max(mf, cfg.k), cfg.k)
        ncfg = cfg
        if native_len != cfg.max_read_len:
            from dataclasses import replace

            ncfg = replace(cfg, max_read_len=native_len)
        stats = _run_native_host(ncfg, index, timer)
        if native_len != cfg.max_read_len:
            stats["auto_max_read_len"] = native_len
    else:
        stats = _run_device(cfg, index, ssv_stream, timer, classifier,
                            device, spans)
    # both loops time warmup_s from the run's start
    stats["index_s"] = index_s
    stats["warmup_s"] -= index_s
    _join_index_save(index, timer)
    return stats


def _run_device(
    cfg: SharkConfig, index: SharkIndex, ssv_stream, timer: PhaseTimer,
    classifier, device, spans: Spans,
) -> dict:
    """A run on a device: the classifier (reused, or made for cfg's
    layout) and the stream _run_native serves it from. The stream is the
    native engine's where cfg.use_native, no ssv_stream and a built engine
    all hold, else the Python I/O path's."""
    probe = None if cfg.probe == "auto" else cfg.probe
    if classifier is not None:
        pass
    elif cfg.sharded_bf:
        from shark_tpu_torch.parallel.sharded_bf import ShardedBFClassifier

        # the sharded layout routes probes to owning shards; the
        # hashed/xl/classic selection is a replicated-index concept
        classifier = ShardedBFClassifier(
            index, max_winners=cfg.max_winners, c=cfg.c,
            devices=make_devices(cfg.devices, device),
        )
    elif cfg.devices > 1:
        from shark_tpu_torch.parallel.data_parallel import (
            DataParallelClassifier,
        )

        # the index replicated on each card, the batch split among them
        classifier = DataParallelClassifier(
            index, max_winners=cfg.max_winners, c=cfg.c,
            devices=make_devices(cfg.devices, device), probe=probe,
            probe_opts=_probe_opts(cfg),
        )
    else:
        classifier = Classifier(
            index, max_winners=cfg.max_winners, c=cfg.c, device=device,
            probe=probe, probe_opts=_probe_opts(cfg),
        )

    engine = cfg.use_native and ssv_stream is None and native_mod.available()
    # the engine takes a fixed --max-read-len or the auto geometry (each
    # batch at its own width); resume needs the fixed one
    if cfg.resume and not (engine and cfg.max_read_len):
        raise ValueError(
            "--resume requires the native engine and a fixed --max-read-len"
        )
    resume = _resume_state(cfg)
    with span("stream_open"):
        stream = (
            _open_engine(cfg, index, cfg.max_read_len % 8 == 0, resume)
            if engine
            else PyStream(_batches(cfg), ssv_stream, cfg.ssv_path,
                          cfg.out1_path, cfg.out2_path, index.gene_names)
        )
    stats = _run_native(cfg, index, classifier, timer, spans, stream, resume)
    if cfg.verbose and "auto_max_read_len" in stats:
        print(
            f"[shark-tpu-torch] auto max_read_len "
            f"{stats['auto_max_read_len']} (widest batch; "
            f"{stats['batch_geometries']} batch widths)",
            file=sys.stderr,
        )
    return stats
