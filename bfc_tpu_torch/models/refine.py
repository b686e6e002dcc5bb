"""-R (refine bfc-corrected reads) on the card: the ec:Z tags of a batch,
the reads KC and KD refine, and the records written.

Counterpart of bfc_tpu/models/device_pipeline.py:_refine_batch (:196-241)
and of the reference's worker_ec under -R (correct.c:438-442,470,
538-553): a read whose tag has ec_code 0 and max_heap < 50 is skipped and
written with its comment and text; every other read is corrected from
the bases its qualities carry (Corrector.device_step's substitution) and
compared with the last parsed stats of the stream (ori_st), which are
zero stats with ec_code 0 before the first tag and stale for a record
without a tag.  A corrected read with more absent k-mers than an ori_st
of ec_code 0 is reverted: it keeps its text and takes ori_st with
rf_code 2; the others get rf_code 3 (refined) or 1 (failed).

bfc_tpu does this read by read in Python.  Here a batch is one pass of
numpy over columns: the native parser reads every tag of the batch
(native/fastxio.c:fastx_parse_tags), the carried stats are a running
maximum of row indices, and the records go out through fastx_format,
whose source 2 writes a skipped read's comment.  Tags the native parser
leaves to Python (odd numbers), batches of the tolerant parser and
reverts to stats that fastx_format cannot print take the per-read path,
which formats each record with format_corrected as bfc_tpu does.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Optional

import numpy as np

from ..io.fastq import Read, format_corrected, pack_stats
from ..native.build import get_lib
from ..opts import Opts
from . import refmodel as M
from .pipeline import parse_stats

# columns of fastx_parse_tags (native/fastxio.c)
IS_TAG, ODD, EC_CODE, N_ABSENT, MAX_HEAP, BRUTE, N_EC, N_EC_HIGH = range(8)
TAG_COLS = 8
_BIG = 1 << 62  # a parsed number's column holds it clipped to +-_BIG
_PRINTABLE = 1 << 53  # reverts fastx_format prints: 0 <= n_absent below


def _clip(v: int) -> int:
    return max(-_BIG, min(_BIG, v))


def stat_cols(st: M.EcStat) -> np.ndarray:
    """A parsed tag's columns from exact stats: ec_code and n_absent
    clipped (only == 0 and the comparison read them), max_heap clipped to
    +-2^62 plus its low byte (it is compared with 50 and printed & 0xFF),
    brute, n_ec and n_ec_high masked as pack_stats masks them."""
    row = np.zeros(TAG_COLS, np.int64)
    row[EC_CODE] = _clip(st.ec_code)
    row[N_ABSENT] = _clip(st.n_absent)
    mh = st.max_heap
    row[MAX_HEAP] = mh if -_BIG < mh < _BIG else (
        (_BIG if mh > 0 else -_BIG) + (mh & 0xFF))
    row[BRUTE] = st.brute & 1
    row[N_EC] = st.n_ec & 0x3FFF
    row[N_EC_HIGH] = st.n_ec_high & 0x3FFF
    return row


def tag_cols(comment: str) -> np.ndarray:
    """fastx_parse_tags's row of one comment, read by parse_stats."""
    if not comment.startswith("ec:Z:"):
        return np.zeros(TAG_COLS, np.int64)
    row = stat_cols(parse_stats(comment[5:]))
    row[IS_TAG] = 1
    return row


class RefineCarry:
    """What -R carries along the stream: the reader's stale comment (kseq
    resets only its length, so a record without a comment prints and
    parses the last comment seen: kseq.h:194-197, bseq.c:66) and ori_st,
    the last parsed stats.  One instance a stream; under a mesh every
    rank keeps its own and parses every row, so all agree at each row."""

    def __init__(self):
        self.comment: Optional[str] = None
        self.ori = M.EcStat(ec_code=0)


@dataclasses.dataclass
class BatchTags:
    """A batch's tags, row by row: skip; src, the row whose comment a row
    has (-1: the comment carried in); stat_row, the row whose tag gives
    the stats in force (-1: those carried in); their columns (stats);
    and what was carried in."""

    skip: np.ndarray
    src: np.ndarray
    stat_row: np.ndarray
    stats: np.ndarray
    comment_in: Optional[str]
    ori_in: M.EcStat

    def comment(self, rb, i: int) -> Optional[str]:
        s = int(self.src[i])
        return self.comment_in if s < 0 else rb.comment(s)

    def ori(self, rb, i: int) -> M.EcStat:
        """The exact stats in force at row i (ori_st)."""
        s = int(self.stat_row[i])
        if s < 0:
            return dataclasses.replace(self.ori_in)
        return parse_stats(rb.comment(s)[5:])


def _own_comments(rb) -> np.ndarray:
    if rb._strings is not None:
        return np.array([r.comment is not None for r in rb._strings], bool)
    return np.asarray(rb.comm_len[:rb.n]) >= 0


def parse_tags(rb, carry: RefineCarry) -> BatchTags:
    """Every row's tag and the carried stats in force at it; advances
    carry past the batch."""
    n = rb.n
    own = _own_comments(rb)
    cols = np.zeros((n, TAG_COLS), np.int64)
    lib = get_lib()
    if rb._strings is None and lib is not None:
        p = ctypes.POINTER
        comm_off = np.ascontiguousarray(rb.comm_off[:n], np.int64)
        comm_len = np.ascontiguousarray(rb.comm_len[:n], np.int32)
        lib.fastx_parse_tags(n, rb.buf,
                             comm_off.ctypes.data_as(p(ctypes.c_int64)),
                             comm_len.ctypes.data_as(p(ctypes.c_int32)),
                             cols.ctypes.data_as(p(ctypes.c_int64)))
        slow = np.nonzero(cols[:, ODD])[0]
    else:
        slow = np.nonzero(own)[0]
    for i in slow:
        cols[i] = tag_cols(rb.comment(int(i)))
    idx = np.arange(n)
    src = np.maximum.accumulate(np.where(own, idx, -1)) if n else idx
    tag_in = carry.comment is not None and carry.comment.startswith("ec:Z:")
    eff_tag = np.where(src >= 0, cols[np.maximum(src, 0), IS_TAG] != 0,
                       tag_in)
    last = np.maximum.accumulate(np.where(eff_tag, idx, -1)) if n else idx
    stat_row = np.where(last >= 0, src[np.maximum(last, 0)], -1)
    ext = np.vstack([stat_cols(carry.ori)[None, :], cols])
    stats = ext[stat_row + 1]
    skip = eff_tag & (stats[:, EC_CODE] == 0) & (stats[:, MAX_HEAP] < 50)
    tags = BatchTags(skip=skip, src=src, stat_row=stat_row, stats=stats,
                     comment_in=carry.comment,
                     ori_in=dataclasses.replace(carry.ori))
    if n:
        if src[-1] >= 0:
            carry.comment = rb.comment(int(src[-1]))
        if stat_row[-1] >= 0:
            carry.ori = tags.ori(rb, n - 1)
    return tags


def _ori_words(stats: np.ndarray):
    """aux, aux2 of reverted reads: ori_st with rf_code 2 (pack_stats)."""
    U = np.uint64
    aux = (((stats[:, N_EC] & 0x3FFF).astype(U) << U(18))
           | ((stats[:, N_EC_HIGH] & 0x3FFF).astype(U) << U(4))
           | ((stats[:, BRUTE] & 1).astype(U) << U(3))
           | (stats[:, EC_CODE] & 7).astype(U))
    aux2 = ((np.clip(stats[:, N_ABSENT], 0, _PRINTABLE).astype(U) << U(10))
            | U(2 << 8) | (stats[:, MAX_HEAP] & 0xFF).astype(U))
    return aux, aux2


@dataclasses.dataclass
class RefineCounts:
    """Reads skipped, refined (rf_code 3), reverted (2) and failed (1);
    host seconds of the tags, the bookkeeping around KC + KD (gathers,
    assembly, the fallback's folding, reverts) and the emit."""

    skipped: int = 0
    refined: int = 0
    reverted: int = 0
    failed: int = 0
    tags_s: float = 0.0
    book_s: float = 0.0
    emit_s: float = 0.0


def refine_rows(corr, rb, tags: BatchTags, a: int, b: int, out) -> None:
    """Refine rows [a, b) of a batch with the Corrector corr and write
    their records to out; corr.refine_counts takes the counts."""
    t0 = time.time()
    opt, counts = corr.opt, corr.refine_counts
    m = b - a
    skip = tags.skip[a:b]
    todo = np.nonzero(~skip)[0]
    rows = a + todo
    has_q = np.asarray(rb.has_qual()[a:b])
    mode = np.where(skip, 2, 0).astype(np.uint8)
    aux = np.zeros(m, np.uint64)
    aux2 = np.zeros(m, np.uint64)
    lens = np.asarray(rb.lens[a:b], np.int32)
    seq_rows = qual_rows = np.zeros((m, 1), np.uint8)
    revert = np.zeros(m, bool)
    t_dev = corr.t_device
    if len(todo):
        res = corr.correct_arrays(
            rb.bases[rows], rb.quals[rows], rb.lens[rows], has_q[todo],
            lambda j: (rb.seq(int(rows[j])), rb.qual(int(rows[j]))))
        code, r_aux, r_aux2 = res.code, res.aux, res.aux2
        seq_rows = np.zeros((m, res.seq_rows.shape[1]), np.uint8)
        qual_rows = np.zeros_like(seq_rows)
        seq_rows[todo], qual_rows[todo] = res.seq_rows, res.qual_rows
        for j, (st, s2, q2) in res.exceptional.items():
            # the scalar model's refine of a read KD overflowed on
            code[j] = st.ec_code
            r_aux[j], r_aux2[j] = pack_stats(st)
            if st.ec_code == 0:
                seq_rows[todo[j], :len(s2)] = np.frombuffer(s2.encode(),
                                                            np.uint8)
                if q2 is not None:
                    qual_rows[todo[j], :len(q2)] = np.frombuffer(
                        q2.encode(), np.uint8)
        ori = tags.stats[rows]
        rev = ((code == 0) & (ori[:, EC_CODE] == 0)
               & ((r_aux2 >> np.uint64(10)).astype(np.int64)
                  > ori[:, N_ABSENT]))
        o_aux, o_aux2 = _ori_words(ori)
        aux[todo] = np.where(rev, o_aux, r_aux)
        aux2[todo] = np.where(rev, o_aux2, r_aux2)
        mode[todo] = np.where((code == 0) & ~rev, 0, 1)
        if opt.discard:
            mode[todo] = np.where(code != 0, 3, mode[todo])
        revert[todo] = rev
        counts.refined += int(((code == 0) & ~rev).sum())
        counts.reverted += int(rev.sum())
        counts.failed += int((code != 0).sum())
    counts.skipped += int(skip.sum())
    is_fq = has_q & (not opt.no_qual)
    mode |= is_fq.astype(np.uint8) << 2
    t1 = time.time()
    counts.book_s += t1 - t0 - (corr.t_device - t_dev)
    n_abs = tags.stats[a:b, N_ABSENT][revert]
    printable = bool(((n_abs >= 0) & (n_abs < _PRINTABLE)).all())
    if not (printable and _emit_native(rb, tags, a, mode, lens, seq_rows,
                                       qual_rows, aux, aux2, out)):
        _emit_python(rb, tags, a, mode, lens, seq_rows, qual_rows, aux,
                     aux2, revert, has_q, opt, out)
    counts.emit_s += time.time() - t1


def _emit_native(rb, tags: BatchTags, a: int, mode, lens, seq_rows,
                 qual_rows, aux, aux2, out) -> bool:
    """fastx_format over the rows; False where it cannot run (the
    tolerant parser's batches, no native library, a list sink)."""
    lib = get_lib()
    if lib is None or rb._strings is not None or not hasattr(out,
                                                             "write_bytes"):
        return False
    m = len(mode)
    b = a + m
    src = tags.src[a:b]
    comment_in = (tags.comment_in or "").encode("ascii")
    c = np.ascontiguousarray
    comm_off = c(np.where(src >= 0, rb.comm_off[np.maximum(src, 0)], -1),
                 np.int64)
    comm_len = c(np.where(src >= 0, rb.comm_len[np.maximum(src, 0)],
                          len(comment_in)), np.int32)
    name_off = c(rb.name_off[a:b], np.int64)
    name_len = c(rb.name_len[a:b], np.int32)
    seq_off = c(rb.seq_off[a:b], np.int64)
    qual_off = c(rb.qual_off[a:b], np.int64)
    seq_rows, qual_rows, lens = c(seq_rows), c(qual_rows), c(lens)
    cap = int((name_len.astype(np.int64) + np.maximum(comm_len, 0)
               + 2 * lens.astype(np.int64) + 96).sum()) + 16
    buf = ctypes.create_string_buffer(cap)

    def p(arr, ct):
        return arr.ctypes.data_as(ctypes.POINTER(ct))

    ret = lib.fastx_format(
        m, rb.buf, p(name_off, ctypes.c_int64), p(name_len, ctypes.c_int32),
        p(seq_off, ctypes.c_int64), p(qual_off, ctypes.c_int64),
        p(seq_rows, ctypes.c_ubyte), p(qual_rows, ctypes.c_ubyte),
        seq_rows.shape[1], p(lens, ctypes.c_int32),
        p(aux, ctypes.c_uint64), p(aux2, ctypes.c_uint64),
        p(mode, ctypes.c_ubyte), buf, cap,
        p(comm_off, ctypes.c_int64), p(comm_len, ctypes.c_int32),
        comment_in)
    if ret < 0:
        raise RuntimeError("fastx_format: output buffer too small")
    out.write_bytes(buf.raw[:ret])
    return True


def _emit_python(rb, tags: BatchTags, a: int, mode, lens, seq_rows,
                 qual_rows, aux, aux2, revert, has_q, opt: Opts,
                 out) -> None:
    """The records one by one through format_corrected."""
    for j in range(len(mode)):
        i = a + j
        src = int(mode[j]) & 3
        r = Read(name=rb.name(i), comment=None, seq=rb.seq(i),
                 qual=rb.qual(i))
        if src == 2:
            r.comment = tags.comment(rb, i)
        elif revert[j]:
            st = tags.ori(rb, i)
            st.rf_code = 2
            r.aux, r.aux2 = pack_stats(st)
        else:
            r.aux, r.aux2 = int(aux[j]), int(aux2[j])
            if src == 0:
                ln = int(lens[j])
                r.seq = seq_rows[j, :ln].tobytes().decode("ascii")
                if has_q[j]:
                    r.qual = qual_rows[j, :ln].tobytes().decode("ascii")
        format_corrected(r, opt.no_qual, False, opt.discard, out)
