"""Ordered output sinks: ssv associations + surviving-read FASTQ files.

Byte format matches the reference (ReadOutput.hpp:37-50): one
"read_id gene_name\\n" line per association on the ssv stream, and 4-line
FASTQ records (original seq/qual) to out1/out2, one record per emitted read
regardless of how many genes it matched. Output is in input order — the
deterministic order the reference produces at t=1.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

FastqRecord = Tuple[str, bytes, bytes]


class OutputWriter:
    def __init__(
        self,
        ssv_stream,
        out1_path: str = "",
        out2_path: str = "",
    ):
        self.ssv = ssv_stream
        self.out1 = _open_out(out1_path)
        self.out2 = _open_out(out2_path)
        self.n_associations = 0
        self.n_reads_out = 0

    def emit_read(
        self,
        gene_names: Sequence[str],
        rec1: FastqRecord,
        rec2: Optional[FastqRecord],
    ) -> None:
        rid = rec1[0]
        lines = "".join(f"{rid} {g}\n" for g in gene_names)
        self.ssv.write(lines)
        self.n_associations += len(gene_names)
        self.n_reads_out += 1
        if self.out1 is not None:
            self.out1.write(_fastq_bytes(rec1))
        if self.out2 is not None and rec2 is not None:
            self.out2.write(_fastq_bytes(rec2))

    def close(self) -> None:
        if self.out1 is not None:
            self.out1.close()
        if self.out2 is not None:
            self.out2.close()
        try:
            self.ssv.flush()
        except Exception:
            pass


def _open_out(path: str):
    """Binary sink; a '.gz' suffix enables transparent gzip compression
    (capability beyond the reference, mirrored in the native engine)."""
    if not path:
        return None
    if path.endswith(".gz"):
        import gzip

        return gzip.open(path, "wb")
    return open(path, "wb")


def _fastq_bytes(rec: FastqRecord) -> bytes:
    name, seq, qual = rec
    return b"@" + name.encode() + b"\n" + seq + b"\n+\n" + qual + b"\n"
