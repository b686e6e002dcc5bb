"""The benchmark's reference for whole files: bfc's counting pass, and
the trim decision of every read, in plain PyTorch.

It follows the scalar specification (reference/scalar.py: count_reads,
max_streak, trim_read), which reproduces bfc -t1's sequential order
(count.c:54-89, correct.c:478-497): every canonical k-mer occurrence is
rolled into a blocked Bloom filter in stream order, and enters the count
table (or, under -1, the second Bloom filter) only where all its probed
bits were already set.  The sequential rule is worked out at once: an
occurrence hits where an earlier occurrence of the same key exists, and
the first occurrence of a key hits where every probed bit was set
before it, i.e. where each of its bits' earliest setter arrived
earlier.  It runs on whatever device the tensors are on, in blocks of
reads, and imports nothing of the program.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np
import torch

from . import scalar as S

class Reads(NamedTuple):
    """Reads as flat arrays: codes u8 (A C G T = 0..3, else 4), quals u8
    (ASCII), lens i64 [n], offs i64 [n]."""

    codes: np.ndarray
    quals: np.ndarray
    lens: np.ndarray
    offs: np.ndarray


class Spectrum(NamedTuple):
    """The kept count table, sorted by (shard, ident): shard u32, ident
    u64, payload u32 (count | high << 8), as numpy; hist [256] and the
    mode that correction reads."""

    shard: np.ndarray
    ident: np.ndarray
    payload: np.ndarray
    hist: np.ndarray
    mode: int


def _wang(key: torch.Tensor, mask: int) -> torch.Tensor:
    """hash64 (kmer.h:30-40) on int64 bit patterns of at most 63 bits."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def padded_block(reads: Reads, a: int, b: int, device) -> tuple:
    """Reads [a, b) as (codes i64 [m, L], quals u8 [m, L]) on device,
    codes padded with 4 (no base) past each read's end."""
    lens = reads.lens[a:b]
    L = int(lens.max()) if b > a else 0
    m = b - a
    start = int(reads.offs[a]) if m else 0
    if m and (lens == L).all():   # one length: the flat arrays as rows
        codes = reads.codes[start:start + m * L].reshape(m, L)
        quals = reads.quals[start:start + m * L].reshape(m, L)
        return (torch.from_numpy(codes).to(device).to(torch.int64),
                torch.from_numpy(quals).to(device))
    codes = np.full((m, L), 4, np.uint8)
    quals = np.zeros((m, L), np.uint8)
    rows = np.repeat(np.arange(m), lens)
    cols = np.arange(int(lens.sum())) - np.repeat(reads.offs[a:b] - start, lens)
    end = start + int(lens.sum())
    codes[rows, cols] = reads.codes[start:end]
    quals[rows, cols] = reads.quals[start:end]
    return (torch.from_numpy(codes).to(device).to(torch.int64),
            torch.from_numpy(quals).to(device))


class KmerBlock(NamedTuple):
    """The valid k-mers of a block of reads, in stream order: h0 and h1
    of the canonical hash (kmer_hash's second and third results), ret's
    low 63 bits, is_high, the read row and the end position."""

    h0: torch.Tensor
    h1: torch.Tensor
    ret: torch.Tensor
    high: torch.Tensor
    row: torch.Tensor
    pos: torch.Tensor


def kmers(codes: torch.Tensor, qok: torch.Tensor, k: int) -> KmerBlock:
    """Every k-mer that ends at a position whose last k bases are A, C, G
    or T, with kmer_hash's planes (kmer_append: plane 0/1 the low/high
    bit of each base, newest at bit 0; planes 2/3 the complement's,
    newest at bit k - 1)."""
    m, L = codes.shape
    dev = codes.device
    n = L - k + 1
    if n <= 0:
        z = torch.zeros((0,), dtype=torch.int64, device=dev)
        return KmerBlock(z, z, z, z.bool(), z, z)
    mask = (1 << k) - 1
    ok = codes < 4
    c = codes.clamp(max=3)
    lo, hi = c & 1, c >> 1
    x = [torch.zeros((m, n), dtype=torch.int64, device=dev) for _ in range(4)]
    valid = torch.ones((m, n), dtype=torch.bool, device=dev)
    high = torch.ones_like(valid)
    for j in range(k):
        # the base j positions before the window's end
        sl = slice(k - 1 - j, L - j)
        x[0] |= lo[:, sl] << j
        x[1] |= hi[:, sl] << j
        x[2] |= (lo[:, sl] ^ 1) << (k - 1 - j)
        x[3] |= (hi[:, sl] ^ 1) << (k - 1 - j)
        valid &= ok[:, sl]
        high &= qok[:, sl]
    t = k >> 1
    u = ((x[1] >> t) & 1) > ((x[3] >> t) & 1)
    a0 = torch.where(u, x[2], x[0])
    a1 = torch.where(u, x[3], x[1])
    w0 = _wang((a0 + a1) & mask, mask)
    h1 = _wang(w0 ^ a1, mask)
    h0 = (w0 + h1) & mask
    ret = ((((w0 ^ h1) << k) | h0) & ((1 << 63) - 1)) if k < 63 else h0
    row, pos = torch.nonzero(valid, as_tuple=True)
    return KmerBlock(h0[valid], h1[valid], ret[valid], high[valid], row,
                     pos + (k - 1))


def table_key(h0: torch.Tensor, h1: torch.Tensor, k: int, l_pre: int):
    """(shard, ident) of get_subhash (htab.c:45-58; scalar.ch_shard_key)."""
    if k <= 32:
        t = 2 * k - l_pre
        z = (h0 << k) | h1
        shard = (z >> t) & ((1 << (64 - t)) - 1)
        return shard, z & ((1 << t) - 1)
    t = k - l_pre
    shift = k if t + k < S.BFC_CH_KEYBITS else S.BFC_CH_KEYBITS - t
    return h0 >> t, ((h0 & ((1 << t) - 1)) << shift) ^ h1


def probe_bits(ret: torch.Tensor, n_shift: int, n_hashes: int) -> torch.Tensor:
    """The bit ids (block << 9 | offset) that a hash probes: int64
    [n, n_hashes], as scalar.bloom_probes picks them."""
    x = n_shift - S.BFC_BLK_SHIFT
    block = ret & ((1 << x) - 1)
    z = (ret >> x) & S.BFC_BLK_MASK
    h2 = (ret >> n_shift) & S.BFC_BLK_MASK
    h2 = torch.where((h2 & 31) == 0, (h2 + 1) & S.BFC_BLK_MASK, h2)
    # the stride has order >= 32 in Z_512 and at most 8 candidates fall
    # in the reserved first byte, so n_hashes + 8 candidates always hold
    # n_hashes kept offsets
    steps = torch.arange(n_hashes + 8, device=ret.device)
    cand = (z[:, None] + steps[None, :] * h2[:, None]) & S.BFC_BLK_MASK
    keep = (cand >> 3) != 0
    rank = torch.cumsum(keep.to(torch.int64), dim=1)
    take = keep & (rank <= n_hashes)
    offs = cand[take].view(-1, n_hashes)
    return (block[:, None] << S.BFC_BLK_SHIFT) | offs


def first_is_hit(bits: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """For distinct keys with probe bits [G, h] and first arrivals [G]:
    whether every probed bit was set by another key that arrived
    earlier."""
    if bits.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=bits.device)
    flat = bits.reshape(-1)
    uniq, inv = torch.unique(flat, return_inverse=True)
    earliest = torch.full(uniq.shape, torch.iinfo(torch.int64).max,
                          dtype=torch.int64, device=bits.device)
    arr = first[:, None].expand_as(bits).reshape(-1)
    earliest.scatter_reduce_(0, inv, arr, "amin")
    return (earliest[inv].view(bits.shape) < first[:, None]).all(dim=1)


class Grouped(NamedTuple):
    """Occurrences grouped by key, sorted by (hi, lo): each group's n,
    n_high, first arrival, first_high and ret."""

    hi: torch.Tensor
    lo: torch.Tensor
    n: torch.Tensor
    n_high: torch.Tensor
    first: torch.Tensor
    first_high: torch.Tensor
    ret: torch.Tensor


def group(hi, lo, high, ret) -> Grouped:
    """Group occurrences given in arrival order by the key (hi, lo): two
    stable sorts keep each key's occurrences in arrival order."""
    arr = torch.arange(hi.shape[0], dtype=torch.int64, device=hi.device)
    o1 = torch.sort(lo, stable=True).indices
    o2 = torch.sort(hi[o1], stable=True).indices
    order = o1[o2]
    hi, lo, high, ret, arr = hi[order], lo[order], high[order], ret[order], arr[order]
    if hi.shape[0] == 0:
        z = hi[:0]
        return Grouped(z, z, z, z, z, high[:0], z)
    change = torch.ones_like(hi, dtype=torch.bool)
    change[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    starts = torch.nonzero(change).flatten()
    ends = torch.cat([starts[1:], starts.new_tensor([hi.shape[0]])])
    csum = torch.cat([high.new_zeros(1, dtype=torch.int64),
                      torch.cumsum(high.to(torch.int64), 0)])
    return Grouped(hi[starts], lo[starts], ends - starts,
                   csum[ends] - csum[starts], arr[starts], high[starts],
                   ret[starts])


def _occurrences(reads: Reads, opt: S.Opts, device, block_slots: int):
    """All valid k-mer occurrences of the reads in stream order, as
    (h0, h1, ret, high) on device."""
    parts = []
    for a, b in read_blocks(reads, block_slots):
        codes, quals = padded_block(reads, a, b, device)
        qok = (quals.to(torch.int64) - 33) >= opt.q
        kb = kmers(codes, qok, opt.k)
        parts.append((kb.h0, kb.h1, kb.ret, kb.high))
        del codes, quals, qok, kb
    return [torch.cat(c) for c in zip(*parts)]


def read_blocks(reads: Reads, block_slots: int):
    """[a, b) ranges of reads whose padded block holds about block_slots
    slots."""
    n = len(reads.lens)
    L = int(reads.lens.max()) if n else 1
    step = max(1, block_slots // max(L, 1))
    for a in range(0, n, step):
        yield a, min(n, a + step)


def count_spectrum(reads: Reads, opt: S.Opts, device,
                   block_slots: int = 1 << 25,
                   drop_bloom: bool = False) -> Spectrum:
    """The kept count table of count_reads (normal mode).  drop_bloom
    makes every key's first occurrence a miss, as a counter with no
    Bloom false positives would: the benchmark's control."""
    l_pre = S.ch_clamped_l_pre(opt.k, opt.l_pre)
    h0, h1, ret, high = _occurrences(reads, opt, device, block_slots)
    shard, ident = table_key(h0, h1, opt.k, l_pre)
    del h0, h1
    g = group(shard, ident, high, ret)
    del shard, ident, high, ret
    if drop_bloom:
        fp = torch.zeros_like(g.n, dtype=torch.bool)
    else:
        fp = first_is_hit(probe_bits(g.ret, opt.bf_shift, opt.n_hashes),
                          g.first)
    fp = fp.to(torch.int64)
    m = g.n - 1 + fp
    hcount = g.n_high - (1 - fp) * g.first_high.to(torch.int64)
    keep = m >= 1
    payload = m.clamp(max=255) | (hcount.clamp(max=63) << 8)
    counts = m[keep].clamp(max=255)
    hist = torch.bincount(counts, minlength=256)[:256].cpu().numpy()
    hist[0] = 0
    best, mode = 0, -1
    for i in range(3, 256):
        if hist[i] > best:
            best, mode = int(hist[i]), i
    return Spectrum(g.hi[keep].cpu().numpy().astype(np.uint32),
                    g.lo[keep].cpu().numpy().view(np.uint64),
                    payload[keep].cpu().numpy().astype(np.uint32), hist, mode)


def bloom_high(reads: Reads, opt: S.Opts, device,
               block_slots: int = 1 << 25,
               drop_bloom: bool = False) -> torch.Tensor:
    """The -1 mode's second Bloom filter (count_reads' bf_high) as int32
    words [2^(bf_shift - 5)], bit z of word w being bit 32 w + z of the
    filter.  Occurrences group by their Bloom address (the bits of ret
    that pick the block and offsets): keys with one address probe the
    same bits, so the sequential rule is the same for them."""
    _, _, ret, high = _occurrences(reads, opt, device, block_slots)
    addr = ret & ((1 << (opt.bf_shift + S.BFC_BLK_SHIFT)) - 1)
    del ret
    g = group(torch.zeros_like(addr), addr, high, addr)
    del addr, high
    bits = probe_bits(g.lo, opt.bf_shift, opt.n_hashes)
    if drop_bloom:
        fp = torch.zeros_like(g.n, dtype=torch.bool)
    else:
        fp = first_is_hit(bits, g.first)
    hit = (g.n - 1 + fp.to(torch.int64)) >= 1
    on = torch.unique(bits[hit].reshape(-1))
    words = torch.zeros((1 << (opt.bf_shift - 6),), dtype=torch.int64,
                        device=device)
    # distinct bits of one word never carry, so their sum is their union
    words.index_add_(0, on >> 6, torch.ones_like(on) << (on & 63))
    return words.view(torch.int32)


def bloom_get(words: torch.Tensor, ret: torch.Tensor, n_shift: int,
              n_hashes: int) -> torch.Tensor:
    """True where every probed bit of ret is set in words (bbf.c:47-63)."""
    bits = probe_bits(ret, n_shift, n_hashes)
    w = words[bits >> 5].to(torch.int64) & 0xFFFFFFFF
    return ((w >> (bits & 31)) & 1).bool().all(dim=1)


def trim_all(reads: Reads, opt: S.Opts, words: torch.Tensor, device,
             block_slots: int = 1 << 25):
    """max_streak and trim_read's keep decision for every read, over the
    filter's words: (kept bool [n], start i64 [n], end i64 [n]) as numpy,
    start and end the kept slice of a kept read."""
    min_frac32 = struct.unpack("f", struct.pack("f", opt.min_frac))[0]
    kept, starts, ends = [], [], []
    for a, b in read_blocks(reads, block_slots):
        codes, _ = padded_block(reads, a, b, device)
        m, L = codes.shape
        qok = torch.ones_like(codes, dtype=torch.bool)
        kb = kmers(codes, qok, opt.k)
        good = torch.zeros((m, L), dtype=torch.bool, device=device)
        if kb.row.numel():
            good[kb.row, kb.pos] = bloom_get(words, kb.ret, opt.bf_shift,
                                             opt.n_hashes)
        # t_i = streak << 32 | (last position <= i that breaks it) + 1
        idx = torch.arange(L, dtype=torch.int64, device=device)[None, :]
        brk = torch.where(good, -1, idx.expand(m, L))
        last = torch.cummax(brk, dim=1).values
        t = ((idx - last) << 32) | (last + 1)
        lens = torch.from_numpy(reads.lens[a:b]).to(device)
        t = torch.where(idx < lens[:, None], t, 0)
        mx = t.max(dim=1).values if L else torch.zeros((m,), dtype=torch.int64,
                                                       device=device)
        streak = mx >> 32
        end_pos = mx & 0xFFFFFFFF
        keep = (streak > 0) & (((streak + opt.k).to(torch.float64)
                                / lens.to(torch.float64)) > min_frac32)
        kept.append(keep.cpu().numpy())
        starts.append((end_pos - (opt.k - 1)).cpu().numpy())
        ends.append((end_pos + streak).cpu().numpy())
        del codes, qok, kb, good, brk, last, t
    if not kept:
        z = np.zeros((0,), np.int64)
        return z.astype(bool), z, z
    return np.concatenate(kept), np.concatenate(starts), np.concatenate(ends)


class TableProbe:
    """scalar.CountHash's lookups (kmer_occ) over a Spectrum: the payload
    of a k-mer, or -1 where it is not kept."""

    def __init__(self, spec: Spectrum, k: int, l_pre: int):
        self.k = k
        self.l_pre = S.ch_clamped_l_pre(k, l_pre)
        self.shard_at = np.searchsorted(
            spec.shard, np.arange((1 << self.l_pre) + 1, dtype=np.uint64))
        self.ident = spec.ident
        self.payload = spec.payload

    def get(self, h0: int, h1: int) -> int:
        shard, ident = S.ch_shard_key(self.k, self.l_pre, h0, h1)
        a, b = int(self.shard_at[shard]), int(self.shard_at[shard + 1])
        j = a + int(np.searchsorted(self.ident[a:b], np.uint64(ident)))
        if j < b and int(self.ident[j]) == ident:
            return int(self.payload[j])
        return -1

    def kmer_occ(self, x) -> int:
        _, h0, h1 = S.kmer_hash(self.k, x)
        return self.get(h0, h1)


class WordsBloom:
    """scalar.Bloom's get over a host copy of int32 filter words."""

    def __init__(self, words: torch.Tensor, n_shift: int, n_hashes: int):
        self.n_shift = n_shift
        self.n_hashes = n_hashes
        self.words = words.cpu().numpy().view(np.uint32)

    def get(self, h: int) -> int:
        block, offsets = S.bloom_probes(self.n_shift, self.n_hashes, h)
        base = block << S.BFC_BLK_SHIFT
        return sum(int(self.words[(base | z) >> 5] >> (z & 31)) & 1
                   for z in offsets)


def words_digest(words: torch.Tensor, chunk: int = 1 << 24) -> str:
    """A digest of int32 filter words computed where they lie: the sum,
    mod 2^64, of each word's u32 value times an odd multiplier drawn from
    its index, and the number of set bits; equal words give equal
    digests on any device."""
    w = words.reshape(-1)
    total = torch.zeros((), dtype=torch.int64, device=w.device)
    ones = torch.zeros((), dtype=torch.int64, device=w.device)
    for a in range(0, w.shape[0], chunk):
        v = w[a:a + chunk].to(torch.int64) & 0xFFFFFFFF
        i = torch.arange(a, a + v.shape[0], dtype=torch.int64, device=w.device)
        mult = ((i * -7046029254386353131) ^ (i >> 7)) | 1
        total += (v * mult).sum()
        x = v
        for s, mk in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F)):
            x = (x & mk) + ((x >> s) & mk)
        ones += ((x * 0x01010101) >> 24 & 0xFF).sum()
    t = int(total) & ((1 << 64) - 1)
    return f"{t:016x}/{int(ones)}"
