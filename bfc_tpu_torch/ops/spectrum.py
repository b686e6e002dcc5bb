"""The spectrum lookup table: a two-slot cuckoo table of u64 entries.

Counterpart of the CuckooTable layout of bfc_tpu/ops/spectrum.py (:286)
and its probes cuckoo_lookup (:687) and cuckoo_lookup32 (:721).  The
table is ONE int64 tensor of 1 << c_bits entries holding the u64 bit
pattern qlow << 15 | nest << 14 | payload(14); payload 0 is an empty slot.
On the card the probe is the __device__ function cuckoo_probe of
csrc/cuckoo.cuh, inlined into kernels KC and KD; this module holds its
plain versions (vectorized, and per k-mer in Python integers for the
plain search) and the helpers the host table build shares.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .kmer import canonical_hash, shard_and_keybody, srl

_CUCKOO_GOLD = 0x9E3779B97F4A7C15
_ALT_C1 = 0x9E3779B9
_ALT_C2 = 0x85EBCA6B
_U64 = (1 << 64) - 1


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
