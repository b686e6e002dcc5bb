"""Scalar end-to-end pipeline over the exact model (the --scalar and -V4
route, and the oracle the device pipeline is held to).

Counterpart of bfc_tpu/models/pipeline.py, mirroring main() of the
reference CLI (bfc.c:126-150): count (or restore) -> optional dump ->
correct/trim -> ordered FASTQ out, read by read on the host with
refmodel, which also prints the -V4 search trace.  Nothing here runs on
a device.
"""

from __future__ import annotations

import struct
from typing import List, Optional

from ..io.fastq import Read, format_corrected, pack_stats, read_fastx
from ..opts import Opts
from . import refmodel as M


def count_file(fn: str, opt: Opts):
    reads = ((r.seq, r.qual) for r in read_fastx(fn, keep_comment=False))
    return M.count_reads(reads, opt)


def correct_read(opt: Opts, ch, mode: int, r: Read,
                 ori_st: M.EcStat) -> M.EcStat:
    """Correct (or, under -R, refine) one record in place and return the
    carried ec:Z stats for the next one (worker_ec, correct.c:538-553).
    Under -R a read whose tag has ec_code 0 and max_heap < 50 keeps its
    comment and text."""
    if M.verbose >= 4:
        # worker_ec's per-read banner (correct.c:541) - printed even
        # for refine-skipped reads, before any processing
        M._tr(f"* Processing read '{r.name}'...")
    if opt.refine_ec and r.comment and r.comment.startswith("ec:Z:"):
        ori_st = parse_stats(r.comment[5:])
        if ori_st.ec_code == 0 and ori_st.max_heap < 50:
            return ori_st
    r.comment = None
    st, r.seq, r.qual = M.ec1(opt, ch, mode, r.seq, r.qual, ori_st=ori_st)
    r.aux, r.aux2 = pack_stats(st)
    return ori_st


def correct_file(fn: str, opt: Opts, ch: M.CountHash, out: List[str]) -> None:
    _, _, mode = ch.hist()
    # per-stream carry-over of the last parsed ec:Z stats: the reference's
    # per-thread ori_st is calloc-zeroed (ec_code=0, all counters 0), so
    # under -t1 reads preceding the first parsed tag compare against the
    # zero stats (correct.c:640-642 calloc + 438-442 revert test)
    ori_st = M.EcStat(ec_code=0)
    for r in read_fastx(fn, keep_comment=opt.filter_mode or opt.refine_ec):
        ori_st = correct_read(opt, ch, mode, r, ori_st)
        format_corrected(r, opt.no_qual, False, opt.discard, out)


def trim_file(fn: str, opt: Opts, bf_high: M.Bloom, out: List[str]) -> None:
    for r in read_fastx(fn, keep_comment=True):
        kept, seq2, qual2 = M.trim_read(opt, bf_high, r.seq, r.qual)
        r.seq, r.qual = seq2, qual2
        r.aux = 0 if kept else 1
        format_corrected(r, opt.no_qual, True, opt.discard, out)


def parse_stats(s: str) -> M.EcStat:
    """Parse an ec:Z: tag back into stats (parse_stats, correct.c:517-531)."""
    st = M.EcStat()
    nums: List[int] = []
    cur = ""
    for ch in s:
        if ch.isdigit() or (ch == "-" and not cur):
            cur += ch
        else:
            nums.append(int(cur) if cur else 0)
            cur = ""
    if cur:
        nums.append(int(cur))
    st.ec_code = nums[0] if nums else 0
    st.rf_code = 1
    if st.ec_code == 0 and len(nums) >= 6:
        st.n_absent, st.max_heap, st.brute, st.n_ec, st.n_ec_high = nums[1:6]
    return st


# ---------------------------------------------------------------------------
# Spectrum dump/restore in the reference binary format (htab.c:129-176)
# ---------------------------------------------------------------------------

def _kh_n_buckets(size: int) -> int:
    """Bucket count khash would reach after `size` insertions.

    khash resizes to >= size/0.77 rounded up to a power of two
    (khash.h:298-305); minimum 4 once non-empty."""
    if size == 0:
        return 0
    need = int(size / 0.77 + 0.5) + 1
    n = 4
    while n < need:
        n <<= 1
    return n


def dump_table(ch: M.CountHash, fn: str) -> None:
    """Write the spectrum in bfc's -d binary format.

    Header {k, l_pre}, then per shard {n_buckets, size} + size u64 keys.
    Keys are emitted in sorted order (the reference emits khash bucket
    order; any order restores identically via kh_put - htab.c:162-171)."""
    with open(fn, "wb") as f:
        f.write(struct.pack("<II", ch.k, ch.l_pre))
        for d in ch.shards:
            f.write(struct.pack("<II", _kh_n_buckets(len(d)), len(d)))
            for ident in sorted(d):
                f.write(struct.pack("<Q", (ident << 14) | d[ident]))


def restore_table(fn: str) -> M.CountHash:
    with open(fn, "rb") as f:
        k, l_pre = struct.unpack("<II", f.read(8))
        ch = M.CountHash(k, l_pre)
        assert l_pre == ch.l_pre
        for d in ch.shards:
            _, size = struct.unpack("<II", f.read(8))
            for _ in range(size):
                (key,) = struct.unpack("<Q", f.read(8))
                d[key >> 14] = key & 0x3FFF
    return ch


def run(opt: Opts, count_fn: str, correct_fn: Optional[str] = None,
        in_hash: Optional[str] = None, out_hash: Optional[str] = None,
        no_ec: bool = False) -> str:
    """Full scalar pipeline; returns the output text (reference stdout)."""
    out: List[str] = []
    next_fn = correct_fn if correct_fn is not None else count_fn
    if opt.filter_mode:
        _, bf_high = count_file(count_fn, opt)
        trim_file(next_fn, opt, bf_high, out)
    else:
        if in_hash is not None:
            ch = restore_table(in_hash)
            opt.k = ch.k
        else:
            _, ch = count_file(count_fn, opt)
        if out_hash is not None:
            dump_table(ch, out_hash)
        if not no_ec:
            correct_file(next_fn, opt, ch, out)
    return "\n".join(out) + ("\n" if out else "")
