"""FASTA/FASTQ streaming I/O with reference-compatible record semantics.

Parsing mirrors kseq (kseq.h:185-224): records start at
'>' or '@'; the name runs to the first whitespace and the remainder of
the header line is the comment; sequence lines are concatenated until
the next header or '+'; for FASTQ, quality lines are concatenated until
the quality length reaches the sequence length.  Gzip input is detected
by magic bytes ('-' or None = stdin).

Writing mirrors the ordered emission of the reference output step
(correct.c:596-611).
"""

from __future__ import annotations

import gzip
import io
import sys
from dataclasses import dataclass
from typing import Iterator, List, Optional


@dataclass
class Read:
    name: str
    comment: Optional[str]
    seq: str
    qual: Optional[str]
    # scratch used by the pipelines (mirrors bseq1_t.aux/aux2)
    aux: int = 0
    aux2: int = 0


def _open_text(fn):
    if fn is not None and not isinstance(fn, str):
        return fn  # already an open text stream / line iterable
    if fn is None or fn == "-":
        return io.TextIOWrapper(sys.stdin.buffer, encoding="ascii", newline="")
    raw = open(fn, "rb")
    magic = raw.read(2)
    raw.seek(0)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.GzipFile(fileobj=raw), encoding="ascii", newline="")
    return io.TextIOWrapper(raw, encoding="ascii", newline="")


def read_fastx(fn: Optional[str], keep_comment: bool = True) -> Iterator[Read]:
    """Stream records like kseq_read; tolerant of multi-line FASTA/FASTQ.

    Comment-less records INHERIT the previous record's comment: kseq only
    resets comment.l, leaving the buffer contents, and bseq tests the
    buffer pointer rather than the length (kseq.h:194-197 + bseq.c:66) -
    so once any record carried a comment, every later comment-less record
    in the same stream reuses the stale text.  A header with trailing
    whitespace but no text overwrites the buffer with "" instead."""
    fp = _open_text(fn)
    name = None
    comment = None
    stale_comment = None  # the kseq comment-buffer content
    seq_parts: List[str] = []
    line_iter = iter(fp)
    line = next(line_iter, None)
    while line is not None:
        line = line.rstrip("\r\n")
        if not line:
            line = next(line_iter, None)
            continue
        if line[0] in ">@":
            header = line[1:]
            # name = up to first whitespace; comment = the rest (kseq.h:195-197)
            sp = len(header)
            for j, chh in enumerate(header):
                if chh.isspace():
                    sp = j
                    break
            name = header[:sp]
            if sp < len(header):
                stale_comment = header[sp + 1 :]  # overwrites the buffer
            comment = stale_comment if keep_comment else None
            seq_parts = []
            qual_parts: List[str] = []
            in_qual = False
            seq_len = 0
            line = next(line_iter, None)
            while line is not None:
                stripped = line.rstrip("\r\n")
                if not in_qual:
                    if stripped and stripped[0] == "+":
                        in_qual = True
                    elif stripped and stripped[0] in ">@":
                        break
                    else:
                        seq_parts.append(stripped)
                        seq_len += len(stripped)
                else:
                    qual_parts.append(stripped)
                    if sum(len(q) for q in qual_parts) >= seq_len:
                        line = next(line_iter, None)
                        break
                line = next(line_iter, None)
            seq = "".join(seq_parts)
            qual = "".join(qual_parts) if in_qual else None
            yield Read(name=name, comment=comment, seq=seq, qual=qual)
            continue
        line = next(line_iter, None)
    fp.close()


def read_chunks(
    fn: Optional[str], chunk_size: int, keep_comment: bool = False
) -> Iterator[List[Read]]:
    """Group the stream into chunks of >= chunk_size bases (bseq.c:52-76)."""
    chunk: List[Read] = []
    size = 0
    for r in read_fastx(fn, keep_comment=keep_comment):
        if not keep_comment:
            r.comment = None
        chunk.append(r)
        size += len(r.seq)
        if size >= chunk_size:
            yield chunk
            chunk, size = [], 0
    if chunk:
        yield chunk


def format_corrected(
    r: Read,
    no_qual: bool,
    filter_mode: bool,
    discard: bool,
    out: List[str],
) -> None:
    """Emit one corrected/filtered record (correct.c:596-611).

    aux/aux2 carry the packed per-read stats exactly as worker_ec packs
    them (correct.c:552-553); filter mode drops reads with aux != 0.
    """
    is_fq = r.qual is not None and not no_qual
    if not filter_mode:
        if discard and (r.aux & 7):
            return
        head = ("@" if is_fq else ">") + r.name
        if r.comment is None:
            tag = "\tec:Z:%d" % (r.aux & 7)
            if (r.aux & 7) == 0:
                tag += "_%d:%d_%d_%d:%d_%d" % (
                    r.aux2 >> 10,
                    r.aux2 & 0xFF,
                    (r.aux >> 3) & 1,
                    (r.aux >> 18) & 0x3FFF,
                    (r.aux >> 4) & 0x3FFF,
                    (r.aux2 >> 8) & 3,
                )
            head += tag
        else:
            head += "\t" + r.comment
    else:
        if r.aux:
            return
        head = ("@" if is_fq else ">") + r.name
        if r.comment is not None:
            head += "\t" + r.comment
    out.append(head)
    out.append(r.seq)
    if is_fq:
        out.append("+")
        out.append(r.qual)


def pack_stats(st) -> tuple:
    """Pack an EcStat into (aux, aux2) as worker_ec does (correct.c:552-553)."""
    aux = ((st.n_ec & 0x3FFF) << 18) | ((st.n_ec_high & 0x3FFF) << 4) | ((st.brute & 1) << 3) | (st.ec_code & 7)
    aux2 = (st.n_absent << 10) | ((st.rf_code & 3) << 8) | (st.max_heap & 0xFF)
    return aux, aux2
