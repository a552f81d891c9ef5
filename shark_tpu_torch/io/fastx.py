"""Streaming FASTA/FASTQ readers (plain or gzip).

Parsing semantics follow kseq (reference: kseq.h:177-218 via main.cpp:31-32):
a record starts at a '>' (FASTA) or '@' (FASTQ) header line; names are the
header token up to the first whitespace; FASTA sequences span lines until
the next header; FASTQ records are name/seq/+/qual with multi-line seq and
qual (qual read until its length reaches the sequence length). Both the
reference input and the sample inputs accept either format, mixed per
record, exactly as kseq does — a FASTA record simply has an empty quality
string (kseq.h:204 leaves qual.l = 0).
"""

from __future__ import annotations

import gzip
import io
from typing import BinaryIO, Iterator, Optional, Tuple

FastaRecord = Tuple[str, bytes]  # (name, seq)
FastqRecord = Tuple[str, bytes, bytes]  # (name, seq, qual; qual b"" = FASTA)

_BUF = 4 << 20


def open_maybe_gzip(path: str) -> BinaryIO:
    f = open(path, "rb", buffering=_BUF)
    magic = f.peek(2)[:2]
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f), buffer_size=_BUF)  # type: ignore[arg-type]
    return f


def _name_of(header: bytes) -> str:
    return header.split(None, 1)[0].decode() if header.strip() else ""


def read_fastx(path: str) -> Iterator[FastqRecord]:
    """kseq-equivalent record iterator: FASTA and FASTQ records, possibly
    mixed in one file. FASTA records yield qual == b""."""
    with open_maybe_gzip(path) as f:
        it = iter(f)
        pushback: Optional[bytes] = None
        while True:
            if pushback is not None:
                line, pushback = pushback, None
            else:
                raw = next(it, None)
                if raw is None:
                    return
                line = raw.rstrip(b"\r\n")
            if not line:
                continue
            if line.startswith(b"@"):
                # FASTQ record: seq lines until '+', qual until len(seq)
                name = _name_of(line[1:])
                seq_chunks = []
                qual_chunks = []
                plus_seen = False
                for raw2 in it:
                    l2 = raw2.rstrip(b"\r\n")
                    if not plus_seen:
                        if l2.startswith(b"+"):
                            plus_seen = True
                        else:
                            seq_chunks.append(l2)
                    else:
                        qual_chunks.append(l2)
                        if sum(map(len, qual_chunks)) >= sum(
                            map(len, seq_chunks)
                        ):
                            break
                seq = b"".join(seq_chunks)
                qual = b"".join(qual_chunks)
                if not plus_seen or len(qual) != len(seq):
                    raise ValueError(
                        f"FASTQ seq/qual length mismatch for read {name} "
                        f"in {path}"
                    )
                yield name, seq, qual
            elif line.startswith(b">"):
                # FASTA record: seq lines until the next header or EOF
                name = _name_of(line[1:])
                seq_chunks = []
                for raw2 in it:
                    l2 = raw2.rstrip(b"\r\n")
                    if l2.startswith(b">") or l2.startswith(b"@"):
                        pushback = l2
                        break
                    seq_chunks.append(l2)
                yield name, b"".join(seq_chunks), b""
            else:
                raise ValueError(
                    f"malformed record header in {path}: {line[:80]!r}"
                )


def read_fasta(path: str) -> Iterator[FastaRecord]:
    """Reference-sequence iteration (quality, if any, is discarded — the
    reference's FastaSplitter also runs on kseq, FastaSplitter.hpp:42)."""
    for name, seq, _ in read_fastx(path):
        yield name, seq


def read_fastq(path: str) -> Iterator[FastqRecord]:
    """Sample iteration: FASTQ or FASTA records (kseq parity)."""
    return read_fastx(path)


def read_fastq_pairs(
    path1: str, path2: Optional[str]
) -> Iterator[Tuple[FastqRecord, Optional[FastqRecord]]]:
    """Paired iteration; stops when either file is exhausted (the reference
    loops while both kseq_read calls succeed, FastqSplitter.hpp:61)."""
    it1 = read_fastx(path1)
    if path2 is None:
        for rec in it1:
            yield rec, None
        return
    it2 = read_fastx(path2)
    while True:
        r1 = next(it1, None)
        if r1 is None:
            return
        r2 = next(it2, None)
        if r2 is None:
            return
        yield r1, r2
