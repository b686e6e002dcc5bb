"""Trim mode (-1) on the card: the Bloom filter of repeated k-mers (KF,
KG) and each read's longest run of k-mers in it (KH).

Counterpart of bfc_tpu/models/trimmer.py, mirroring the reference's
second Bloom filter path (count.c:67-68,148-153) and max_streak trimming
(correct.c:478-497,554-570).  The counting pass is the main path's; its
aggregate is pulled once (KE), or with the device finalize stays on the
card.  A k-mer is kept when it occurred twice or its first occurrence
already found its Bloom bits set (the host sketch's verdict where
bfc_tpu takes it, on the card KF, or KI past 2^32 arrivals), and KG ORs
the kept k-mers' bits into the words of bf_high.  Reads then stream
through KH in batches and are trimmed to their longest streak or
dropped.
"""

from __future__ import annotations

import struct
import time
from typing import List, Optional

import numpy as np
import torch

from .. import kernels
from ..io.fastq import Read, format_corrected
from ..opts import Opts
from ..ops import kmer as kops
from ..ops import spectrum as spec
from ..ops import spectrum_dense as sdn
from ..ops.spectrum_dense import as_i32
from ..utils.log import log
from .counter import (count_batches_aggregate, device_finalize_on,
                      usable_sketch)
from .refmodel import bloom_probes


# ---------------------------------------------------------------------------
# KG: the Bloom build
# ---------------------------------------------------------------------------

def bloom_build_plain(ret, keep, bf_shift: int, n_hashes: int):
    """Plain version of KG: the kept rows' bit ids, deduplicated, added
    into the words (an add of distinct bits is an OR)."""
    bits = torch.unique(spec.bloom_probe_bits(ret[keep], bf_shift, n_hashes))
    words = torch.zeros((1 << (bf_shift - 5),), dtype=torch.int64,
                        device=ret.device)
    words.index_add_(0, bits >> 5, torch.ones_like(bits) << (bits & 31))
    return as_i32(words)


def bloom_build(ret, keep, bf_shift: int, n_hashes: int):
    """The trim Bloom filter's words (kernel KG): int32 [2^(bf_shift-5)]
    holding u32 bit patterns, bit b of the filter at word b >> 5, bit
    b & 31.  ret int64 [C]; keep bool [C]."""
    C = ret.shape[0]
    dev = ret.device
    kernels.check(ret, "ret", torch.int64, (C,), dev)
    kernels.check(keep, "keep", torch.bool, (C,), dev)
    spec.check_n_hashes(n_hashes)
    if dev.type == "cpu":
        return bloom_build_plain(ret, keep, bf_shift, n_hashes)
    words = torch.empty((1 << (bf_shift - 5),), dtype=torch.int32, device=dev)
    kernels.KG.launch("kg_launch", C, ret.data_ptr(), keep.data_ptr(),
                      bf_shift, n_hashes, words.data_ptr())
    return words


def popcount(words) -> int:
    """Set bits of int32 words (u32 bit patterns), in chunks."""
    total = 0
    for a in range(0, words.shape[0], 1 << 24):
        v = words[a:a + (1 << 24)].to(torch.int64) & 0xFFFFFFFF
        v = v - ((v >> 1) & 0x55555555)
        v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
        v = (v + (v >> 4)) & 0x0F0F0F0F
        total += int((((v * 0x01010101) & 0xFFFFFFFF) >> 24).sum())
    return total


class DeviceBloom:
    """The trim mode's Bloom filter of repeated k-mers (bf_high)."""

    def __init__(self, words, bf_shift: int, n_hashes: int):
        self.words = words  # int32 [2^(bf_shift-5)], u32 bit patterns
        self.bf_shift = bf_shift
        self.n_hashes = n_hashes

    @staticmethod
    def from_rets(rets, keep, bf_shift: int, n_hashes: int) -> "DeviceBloom":
        return DeviceBloom(bloom_build(rets, keep, bf_shift, n_hashes),
                           bf_shift, n_hashes)


class WordsProbe:
    """refmodel.Bloom-shaped view of a copy of the words on the host, for
    the scalar trim (refmodel.trim_read): get(h) counts the set probe bits
    of hash h, as bbf.c:47-63 does."""

    def __init__(self, bloom: DeviceBloom):
        self.n_shift = bloom.bf_shift
        self.n_hashes = bloom.n_hashes
        self.words = bloom.words.cpu().numpy().view(np.uint32)

    def get(self, h: int) -> int:
        block, offsets = bloom_probes(self.n_shift, self.n_hashes, h)
        base = block << 9
        return sum(int(self.words[(base | z) >> 5] >> (z & 31)) & 1
                   for z in offsets)


# ---------------------------------------------------------------------------
# KH: the longest streak of Bloom-hit k-mers
# ---------------------------------------------------------------------------

def bloom_query_plain(words, ret, bf_shift: int, n_hashes: int):
    """True where all probed bits of ret are set (bbf.c:47-63)."""
    bits = spec.bloom_probe_bits(ret, bf_shift, n_hashes)
    w = words[bits >> 5].to(torch.int64) & 0xFFFFFFFF
    return ((w >> (bits & 31)) & 1).bool().all(dim=-1)


def max_streak_plain(words, bases, lens, k: int, bf_shift: int,
                     n_hashes: int):
    """Plain version of KH: every read rolled at once, one base a step."""
    B, L = bases.shape
    dev = bases.device
    z = torch.zeros((B,), dtype=torch.int64, device=dev)
    x = (z, z, z, z)
    run = t = best = z
    lens64 = lens.to(torch.int64)
    for i in range(L):
        inb = lens64 > i
        c = bases[:, i].to(torch.int64)
        ok = inb & (c < 4)
        nx = kops.append_base(x, c.clamp(max=3), k)
        x = tuple(torch.where(ok, a, torch.where(inb, 0, b))
                  for a, b in zip(nx, x))
        run = torch.where(ok, run + 1, torch.where(inb, 0, run))
        ret, _, _ = kops.canonical_hash(*x, k)
        hit = ok & (run >= k) & bloom_query_plain(words, ret, bf_shift,
                                                  n_hashes)
        t = torch.where(hit, t + (1 << 32), torch.where(inb, i + 1, t))
        best = torch.maximum(best, t)
    return best


def max_streak_batch(words, bases, lens, k: int, bf_shift: int,
                     n_hashes: int):
    """Each read's longest run of k-mers found in the Bloom filter (kernel
    KH): int64 [B] of len << 32 | end, where end is one past the run's
    last base and equal lengths resolve to the later run.  bases u8
    [B, L] (codes 0..4), lens i32 [B]; no limit on L."""
    B, L = bases.shape
    dev = bases.device
    kernels.check(words, "words", torch.int32, (1 << (bf_shift - 5),), dev)
    kernels.check(bases, "bases", torch.uint8, (B, L), dev)
    kernels.check(lens, "lens", torch.int32, (B,), dev)
    spec.check_n_hashes(n_hashes)
    if dev.type == "cpu":
        return max_streak_plain(words, bases, lens, k, bf_shift, n_hashes)
    out = torch.empty((B,), dtype=torch.int64, device=dev)
    kernels.KH.launch("kh_launch", bases.data_ptr(), lens.data_ptr(), B, L,
                      k, words.data_ptr(), bf_shift, n_hashes, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# Filter-mode counting
# ---------------------------------------------------------------------------

def count_file_filter_device(fn: str, opt: Opts, device,
                             batch_reads: int = 16384,
                             info: Optional[dict] = None,
                             device_finalize: Optional[bool] = None
                             ) -> DeviceBloom:
    """Count fn and build bf_high from the k-mers that enter it.

    With the host finalize (the default; device_finalize_on) the
    aggregate is pulled, and the verdict comes from the host Bloom sketch
    where bfc_tpu takes it (bf_shift <= 31, trimmer.py:109-120).  Else,
    and always with the device finalize, spec.adjudicate gives it on the
    card: KF, or KI once arrivals reach 2^32 - 1 (trimmer.py:121-130),
    over the run as it stays on the card (KJ fills in ret where it is not
    carried) or over a spilled tree's aggregate taken there.  `info`
    receives the read and k-mer counts, which verdict ran, the aggregate
    (a HostAgg, or the device Run) and the keep flags."""
    dev = torch.device(device)
    agg, n_reads = count_batches_aggregate(fn, opt, dev, batch_reads,
                                           device_finalize)
    t0 = time.time()
    # runs hold no padding rows: every aggregate row is a k-mer
    sketch = usable_sketch(agg, opt)
    if isinstance(agg, sdn.Run):
        run = sdn.run_to_aggregate(agg, opt.k, opt.effective_l_pre())
        ret = run.ret
        _, keep, verdict = spec.adjudicate(ret, run.arr, run.n, opt.bf_shift,
                                           opt.n_hashes)
    elif sketch is not None:
        ret = torch.from_numpy(agg.ret.view(np.int64)).to(dev)
        fp = sketch.verdict(agg.ret, agg.first_arr,
                            np.ones(len(agg.ret), bool)).astype(np.int64)
        keep = torch.from_numpy(agg.n.astype(np.int64) - 1 + fp >= 1).to(dev)
        verdict = "host sketch"
    else:
        ret = torch.from_numpy(agg.ret.view(np.int64)).to(dev)
        arr = torch.from_numpy(agg.first_arr.view(np.int64)).to(dev)
        n = torch.from_numpy(agg.n.astype(np.int64)).to(dev)
        _, keep, verdict = spec.adjudicate(ret, arr, n, opt.bf_shift,
                                           opt.n_hashes)
    bloom = DeviceBloom.from_rets(ret, keep, opt.bf_shift, opt.n_hashes)
    n_kept = int(keep.sum())
    log(f"processed {n_reads} sequences (filter mode); {n_kept} of "
        f"{len(ret)} k-mers kept ({verdict} verdict); verdict and Bloom "
        f"build {time.time() - t0:.1f}s")
    if info is not None:
        info.update(n_reads=n_reads, n_aggregated=len(ret), n_kept=n_kept,
                    verdict=verdict, aggregate=agg, keep=keep,
                    finalize="device" if device_finalize_on(device_finalize)
                    else "host")
    return bloom


# ---------------------------------------------------------------------------
# The trim pass
# ---------------------------------------------------------------------------

class Trimmer:
    """Trims each read to its longest Bloom-hit streak, or drops it."""

    def __init__(self, opt: Opts, bloom: DeviceBloom):
        self.opt = opt
        self.bloom = bloom
        # min_frac is a C float in the reference (bfc.h:21)
        self.min_frac32 = struct.unpack("f", struct.pack("f", opt.min_frac))[0]
        self.n_reads = 0
        self.n_kept = 0

    def trim_file(self, fn: str, out, batch_reads: int = 8192) -> None:
        from ..io import fast_reader as FR

        dev = self.bloom.words.device
        pad_L = 0
        comments = FR.CommentCarry()
        for rb in FR.iter_batches_prefetch(fn, batch_reads,
                                           max_bases=self.opt.chunk_size):
            n = rb.n
            if n == 0:
                continue
            # one padded shape for the stream, as bfc_tpu batches it
            pad_L = max(pad_L, (int(rb.lens.max()) + 31) // 32 * 32)
            Lc = min(pad_L, rb.bases.shape[1])
            bases = np.full((batch_reads, pad_L), 4, np.uint8)
            bases[:n, :Lc] = rb.bases[:, :Lc]
            lens = np.zeros((batch_reads,), np.int32)
            lens[:n] = rb.lens
            m = max_streak_batch(
                self.bloom.words, torch.from_numpy(bases).to(dev),
                torch.from_numpy(lens).to(dev), self.opt.k,
                self.bloom.bf_shift, self.bloom.n_hashes).cpu().numpy()[:n]
            self.n_reads += n
            if self._emit_native(rb, m, comments, out):
                continue
            reads = [Read(name=rb.name(i), comment=comments.get(rb, i),
                          seq=rb.seq(i), qual=rb.qual(i)) for i in range(n)]
            self._apply_m(reads, m)
            for r in reads:
                self.n_kept += r.aux == 0
                format_corrected(r, self.opt.no_qual, True, self.opt.discard,
                                 out)

    def _emit_native(self, rb, m, comments, out) -> bool:
        """Batch emit through the native trim formatter
        (native/fastxio.c:fastx_format_trim; correct.c:596-611 in filter
        mode).  Returns False for the per-read Python path: slow-parser
        batches, a comment in flight (kseq's stale-comment semantics need
        Python state), or a slice Python would clamp."""
        import ctypes

        from ..native.build import get_lib

        opt = self.opt
        n = rb.n
        lib = get_lib()
        if (lib is None or rb._strings is not None
                or not hasattr(out, "write_bytes")
                or comments.stale is not None
                or int(rb.comm_len[:n].max(initial=-1)) >= 0):
            return False
        streak = (m >> 32).astype(np.int64)
        seqlen = rb.lens[:n].astype(np.float64)
        keep = (streak > 0) & (
            (streak + opt.k) / np.maximum(seqlen, 1) > self.min_frac32)
        start = (m & 0xFFFFFFFF).astype(np.int64) - (opt.k - 1)
        tlen = streak + opt.k - 1
        if (keep & ((start < 0) | (start + tlen > rb.lens[:n]))).any():
            return False
        is_fq = (rb.qual_off[:n] >= 0) & (not opt.no_qual)
        mode = keep.astype(np.uint8) | (is_fq.astype(np.uint8) << 2)
        name_off = np.ascontiguousarray(rb.name_off[:n], dtype=np.int64)
        name_len = np.ascontiguousarray(rb.name_len[:n], dtype=np.int32)
        seq_off = np.ascontiguousarray(rb.seq_off[:n], dtype=np.int64)
        qual_off = np.ascontiguousarray(rb.qual_off[:n], dtype=np.int64)
        start32 = np.ascontiguousarray(np.where(keep, start, 0), dtype=np.int32)
        tlen32 = np.ascontiguousarray(np.where(keep, tlen, 0), dtype=np.int32)
        cap = int((name_len.astype(np.int64) + 2 * tlen32 + 8).sum()) + 16
        buf = ctypes.create_string_buffer(cap)

        def p(arr, ct):
            return arr.ctypes.data_as(ctypes.POINTER(ct))

        ret = lib.fastx_format_trim(
            n, rb.buf,
            p(name_off, ctypes.c_int64), p(name_len, ctypes.c_int32),
            p(seq_off, ctypes.c_int64), p(qual_off, ctypes.c_int64),
            p(start32, ctypes.c_int32), p(tlen32, ctypes.c_int32),
            p(mode, ctypes.c_ubyte),
            buf, cap,
        )
        if ret < 0:
            return False
        out.write_bytes(buf.raw[:ret])
        self.n_kept += int(keep.sum())
        return True

    def _apply_m(self, reads: List[Read], m: np.ndarray) -> None:
        """Trim each read to its streak (aux 0) or mark it dropped (aux 1)
        (correct.c:554-570)."""
        k = self.opt.k
        for i, r in enumerate(reads):
            streak = int(m[i]) >> 32
            if streak and (streak + k) / len(r.seq) > self.min_frac32:
                start = (int(m[i]) & 0xFFFFFFFF) - (k - 1)
                end = start + streak + k - 1
                r.seq = r.seq[start:end]
                if r.qual is not None:
                    r.qual = r.qual[start:end]
                r.aux = 0
            else:
                r.aux = 1
