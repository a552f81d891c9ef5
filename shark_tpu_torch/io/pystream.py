"""The Python I/O path's stream: reads parsed and encoded in numpy
(encode_batch) and written by OutputWriter, behind the interface of the
native engine's NativeStream, so that one dispatch loop
(pipeline._run_native) serves both. It is the only stream that writes
the ssv to an in-process text stream (run_pipeline's ssv_stream)."""

from __future__ import annotations

import itertools
import sys
from typing import Iterable, List

import numpy as np

from shark_tpu_torch.io.encode import ReadBatch
from shark_tpu_torch.io.writer import OutputWriter


class PyStream:
    """Byte-code batches of `batches` (each [B, L] at its own width),
    emitted in input order to `ssv` (a text stream; None opens
    `ssv_path`, or writes to stdout without one) and the FASTQ files
    out1/out2 ('.gz' compresses)."""

    packed = False  # byte codes, as NativeStream(packed=False) gives them

    def __init__(
        self,
        batches: Iterable[ReadBatch],
        ssv,
        ssv_path: str,
        out1: str,
        out2: str,
        gene_names: List[str],
    ):
        self._batches = iter(batches)
        self._own_ssv = (
            open(ssv_path, "w") if ssv is None and ssv_path else None
        )
        self._writer = OutputWriter(
            ssv or self._own_ssv or sys.stdout, out1, out2
        )
        self._names = gene_names
        self._held = {}  # slot -> its ReadBatch, until emitted or released
        self._slots = itertools.count()

    def next_batch(self):
        """(codes u8[B, L], slot, n), or None at the end of the sample."""
        batch = next(self._batches, None)
        if batch is None:
            return None
        slot = next(self._slots)
        self._held[slot] = batch
        return batch.codes, slot, batch.n

    def release(self, slot: int) -> None:
        del self._held[slot]

    def emit(self, slot: int, read_idx: np.ndarray, gene_idx: np.ndarray):
        """Write the batch's (read, gene) pairs, read-ascending: one ssv
        line a pair and one FASTQ record a read; the slot is freed."""
        batch = self._held.pop(slot)
        starts = np.flatnonzero(np.diff(read_idx, prepend=-1))
        ends = [*starts[1:], len(read_idx)]
        for a, b in zip(starts, ends):
            r = read_idx[a]
            self._writer.emit_read(
                [self._names[g] for g in gene_idx[a:b]],
                batch.recs1[r],
                batch.recs2[r] if batch.recs2 is not None else None,
            )

    def tell(self):
        """No offsets to truncate to: --resume needs the engine."""
        return -1, -1, -1

    @property
    def n_associations(self) -> int:
        return self._writer.n_associations

    @property
    def n_reads_out(self) -> int:
        return self._writer.n_reads_out

    def stats(self) -> dict:
        """The engine's counters: none here."""
        return {}

    def close(self) -> None:
        self._writer.close()
        if self._own_ssv is not None:
            self._own_ssv.close()
