"""The spectrum lookup table, the Bloom probe addressing and the
first-occurrence Bloom verdict (kernel KF).

Counterpart of the CuckooTable layout of bfc_tpu/ops/spectrum.py (:286)
and its probes cuckoo_lookup (:687) and cuckoo_lookup32 (:721).  The
table is ONE int64 tensor of 1 << c_bits entries holding the u64 bit
pattern qlow << 15 | nest << 14 | payload(14); payload 0 is an empty slot.
On the card the probe is the __device__ function cuckoo_probe of
csrc/cuckoo.cuh, inlined into kernels KC and KD; this module holds its
plain versions (vectorized, and per k-mer in Python integers for the
plain search) and the helpers the host table build shares.

bloom_probe_bits is the plain twin of csrc/bloom.cuh (spectrum.py:184),
and adjudicate_sketch is kernel KF (spectrum.py:adjudicate_sketch, :843,
with the keep rule of trimmer.py:filter_keep_rets, :81).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from .kmer import canonical_hash, shard_and_keybody, srl

_CUCKOO_GOLD = 0x9E3779B97F4A7C15
_ALT_C1 = 0x9E3779B9
_ALT_C2 = 0x85EBCA6B
_U64 = (1 << 64) - 1
BLK_SHIFT = 9
MAX_HASHES = 16  # csrc/bloom.cuh:BFC_MAX_HASHES


class SpecTable(NamedTuple):
    """A cuckoo table and the identity layout that addresses it."""

    table: torch.Tensor  # int64 [1 << c_bits], u64 entry bits
    k: int
    l_pre: int
    kb_bits: int
    c_bits: int


def cuckoo_alt_np(qlow, c_bits: int):
    """Alternate-slot offset from u64 qlow (numpy; the host build)."""
    import numpy as np

    if c_bits > 32:
        return (qlow * np.uint64(_CUCKOO_GOLD)) >> np.uint64(64 - c_bits)
    h = (
        ((qlow & np.uint64(0xFFFFFFFF)) * np.uint64(_ALT_C1))
        ^ ((qlow >> np.uint64(32)) * np.uint64(_ALT_C2))
    ) & np.uint64(0xFFFFFFFF)
    return h >> np.uint64(32 - c_bits)


def _posk64(shard, keybody, l_pre: int, kb_bits: int):
    rem = 64 - l_pre - kb_bits
    lo = keybody << rem if rem >= 0 else keybody >> -rem
    return (shard << (64 - l_pre)) | lo


def _id_low(shard, keybody, l_pre: int, kb_bits: int, c_bits: int):
    nbits = l_pre + kb_bits - c_bits
    if nbits <= 0:
        return torch.zeros_like(keybody)
    if nbits <= kb_bits:
        return keybody & ((1 << nbits) - 1)
    extra = nbits - kb_bits
    return ((shard & ((1 << extra) - 1)) << kb_bits) | keybody


def cuckoo_alt(qlow, c_bits: int):
    """Alternate-slot offset of int64 qlow (spectrum.py:cuckoo_alt_u64)."""
    if c_bits > 32:
        return srl(qlow * _to_i64(_CUCKOO_GOLD), 64 - c_bits)
    h = (((qlow & 0xFFFFFFFF) * _ALT_C1) ^ ((qlow >> 32) * _ALT_C2)) \
        & 0xFFFFFFFF
    return h >> (32 - c_bits)


def cuckoo_lookup_plain(t: SpecTable, shard, keybody):
    """Payload (int64, -1 absent) of each (shard, keybody) int64 query."""
    c_bits = t.c_bits
    s1 = srl(_posk64(shard, keybody, t.l_pre, t.kb_bits), 64 - c_bits)
    qlow = _id_low(shard, keybody, t.l_pre, t.kb_bits, c_bits)
    s2 = s1 ^ cuckoo_alt(qlow, c_bits)
    e1 = t.table[s1]
    e2 = t.table[s2]

    def match(e, nest):
        return ((e & 0x3FFF) != 0) & (((e >> 14) & 1) == nest) \
            & (srl(e, 15) == qlow)

    return torch.where(match(e1, 0), e1 & 0x3FFF,
                       torch.where(match(e2, 1), e2 & 0x3FFF, -1))


def kmer_occ_plain(t: SpecTable, x0, x1, x2, x3):
    """Payload of each 4-plane k-mer (vectorized CountHash.kmer_occ)."""
    _, h0, h1 = canonical_hash(x0, x1, x2, x3, t.k)
    shard, keybody = shard_and_keybody(h0, h1, t.k, t.l_pre)
    return cuckoo_lookup_plain(t, shard, keybody)


def _to_i64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


class IntProbe:
    """CountHash-shaped view of a cuckoo table for the per-read plain
    search: kmer_occ(x) on Python-integer planes, probing a host copy of
    the table with the same arithmetic as cuckoo_probe.  n_probes counts
    the kmer_occ calls."""

    def __init__(self, t: SpecTable):
        self.n_probes = 0
        self.k = t.k
        self.l_pre = t.l_pre
        self.kb_bits = t.kb_bits
        self.c_bits = t.c_bits
        self.entries = t.table.cpu().numpy().view("uint64")

    def get(self, h0: int, h1: int) -> int:
        k, l_pre = self.k, self.l_pre
        if k <= 32:
            t = 2 * k - l_pre
            z = (h0 << k) | h1
            shard, keybody = z >> t, z & ((1 << t) - 1)
        else:
            t = k - l_pre
            shift = k if t + k < 50 else 50 - t
            shard = h0 >> t
            keybody = ((h0 & ((1 << t) - 1)) << shift) ^ h1
        return self.get_identity(shard, keybody)

    def get_identity(self, shard: int, keybody: int) -> int:
        """Payload of (shard, keybody), or -1 (csrc/cuckoo.cuh)."""
        l_pre, kb_bits, c_bits = self.l_pre, self.kb_bits, self.c_bits
        rem = 64 - l_pre - kb_bits
        lo = (keybody << rem) & _U64 if rem >= 0 else keybody >> -rem
        pk = ((shard << (64 - l_pre)) | lo) & _U64
        s1 = pk >> (64 - c_bits)
        nbits = l_pre + kb_bits - c_bits
        if nbits <= 0:
            qlow = 0
        elif nbits <= kb_bits:
            qlow = keybody & ((1 << nbits) - 1)
        else:
            qlow = ((shard & ((1 << (nbits - kb_bits)) - 1)) << kb_bits) | keybody
        if c_bits > 32:
            alt = ((qlow * _CUCKOO_GOLD) & _U64) >> (64 - c_bits)
        else:
            alt = ((((qlow & 0xFFFFFFFF) * _ALT_C1) ^ ((qlow >> 32) * _ALT_C2))
                   & 0xFFFFFFFF) >> (32 - c_bits)
        for slot, nest in ((s1, 0), (s1 ^ alt, 1)):
            e = int(self.entries[slot])
            if e & 0x3FFF and (e >> 14) & 1 == nest and e >> 15 == qlow:
                return e & 0x3FFF
        return -1

    def kmer_occ(self, x) -> int:
        from ..models.refmodel import kmer_hash

        self.n_probes += 1
        _, h0, h1 = kmer_hash(self.k, x)
        return self.get(h0, h1)


# ---------------------------------------------------------------------------
# Bloom probe addressing and the first-occurrence verdict (KF)
# ---------------------------------------------------------------------------

def bloom_probe_bits(ret, bf_shift: int, n_hashes: int):
    """Global bit ids (int64 [..., n_hashes]) probed for each ret (int64
    u64 bit patterns; bbf.c:27-37): block << 9 | offset, with the stride
    bumped when h2 & 31 == 0 and offsets in byte 0 of the block skipped.
    n_hashes + 8 steps always hold n_hashes valid offsets (at most 8 of
    fewer than 32 distinct offsets lie below 8)."""
    x = bf_shift - BLK_SHIFT
    block = ret & ((1 << x) - 1)
    z = srl(ret, x) & 511
    h2 = srl(ret, bf_shift) & 511
    h2 = torch.where((h2 & 31) == 0, (h2 + 1) & 511, h2)
    zs = []
    for _ in range(n_hashes + 8):
        zs.append(z)
        z = (z + h2) & 511
    zs = torch.stack(zs, dim=-1)
    ok = zs >= 8
    rank = torch.where(ok, torch.cumsum(ok.to(torch.int64), dim=-1) - 1, -1)
    out = torch.stack([torch.where(rank == j, zs, 0).sum(dim=-1)
                       for j in range(n_hashes)], dim=-1)
    return (block << BLK_SHIFT).unsqueeze(-1) | out


def adjudicate_sketch_plain(ret, arr, n, bf_shift: int, n_hashes: int):
    """Plain version of KF, as a sort (spectrum.py:
    adjudicate_first_occurrence, :217): the probes sorted by (bit,
    arrival), each compared with its bit group's first arrival.  It needs
    no 2^bf_shift array.  ret int64 [C]; arr int32 [C], the low 32 bits of
    the first arrivals; n int32 [C] occurrences (saturated).  Returns
    (fp, keep), bool [C]."""
    C = ret.shape[0]
    H = n_hashes
    bits = bloom_probe_bits(ret, bf_shift, n_hashes).reshape(-1)
    a = (arr.to(torch.int64) & 0xFFFFFFFF).repeat_interleave(H)
    order = torch.sort(a, stable=True).indices
    order = order[torch.sort(bits[order], stable=True).indices]
    sb, sa = bits[order], a[order]
    first = torch.ones_like(sb, dtype=torch.bool)
    first[1:] = sb[1:] != sb[:-1]
    idx = torch.arange(sb.shape[0], device=sb.device)
    start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    hit = torch.empty_like(first)
    hit[order] = sa[start] < sa
    fp = hit.view(C, H).all(dim=1)
    keep = n.to(torch.int64) - 1 + fp.to(torch.int64) >= 1
    return fp, keep


def check_n_hashes(n_hashes: int) -> None:
    if not 1 <= n_hashes <= MAX_HASHES:
        raise ValueError(f"n_hashes {n_hashes} outside 1..{MAX_HASHES}")


def adjudicate_sketch(ret, arr, n, bf_shift: int, n_hashes: int):
    """Which distinct k-mers enter the trim mode's bf_high (kernel KF).

    fp: the first occurrence found all its Bloom bits set by an earlier
    arrival; keep: n - 1 + fp >= 1.  Inputs as adjudicate_sketch_plain;
    arrivals must be below 2^32 - 1 (the caller checks).  On the card a
    u32 scratch of 2^bf_shift entries (4 * 2^bf_shift bytes) holds the
    inverted earliest arrival of every bit; a card without that much free
    memory raises."""
    C = ret.shape[0]
    dev = ret.device
    kernels.check(ret, "ret", torch.int64, (C,), dev)
    kernels.check(arr, "arr", torch.int32, (C,), dev)
    kernels.check(n, "n", torch.int32, (C,), dev)
    check_n_hashes(n_hashes)
    if dev.type == "cpu":
        return adjudicate_sketch_plain(ret, arr, n, bf_shift, n_hashes)
    need = 4 << bf_shift
    free = kernels.device_free_bytes(dev)
    if need > free:
        raise RuntimeError(
            f"the Bloom adjudicate at -b{bf_shift} needs {need} bytes of "
            f"device scratch, {free} free: the sort adjudicate on the card "
            "is ROADMAP Queue 2 (K12b)")
    dense = torch.empty((1 << bf_shift,), dtype=torch.int32, device=dev)
    fp = torch.empty((C,), dtype=torch.bool, device=dev)
    keep = torch.empty((C,), dtype=torch.bool, device=dev)
    kernels.KF.launch("kf_launch", C, ret.data_ptr(), arr.data_ptr(),
                      n.data_ptr(), bf_shift, n_hashes, dense.data_ptr(),
                      fp.data_ptr(), keep.data_ptr())
    return fp, keep
