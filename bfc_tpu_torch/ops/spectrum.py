"""The spectrum lookup table, the Bloom probe addressing, the
first-occurrence Bloom verdicts (kernels KF and KI) and the device
finalize (kernels KK and KL).

Counterpart of the CuckooTable layout of bfc_tpu/ops/spectrum.py (:286)
and its probes cuckoo_lookup (:687) and cuckoo_lookup32 (:721).  The
table is ONE int64 tensor of 1 << c_bits entries holding the u64 bit
pattern qlow << 15 | nest << 14 | payload(14); payload 0 is an empty slot.
On the card the probe is the __device__ function cuckoo_probe of
csrc/cuckoo.cuh, inlined into kernels KC and KD; this module holds its
plain versions (vectorized, and per k-mer in Python integers for the
plain search) and the helpers the host table build shares.

bloom_probe_bits is the plain twin of csrc/bloom.cuh (spectrum.py:184).
adjudicate_sketch is kernel KF (spectrum.py:adjudicate_sketch, :843, with
the keep rule of trimmer.py:filter_keep_rets, :81) and
adjudicate_first_occurrence kernel KI (:217); adjudicate chooses between
them as bfc_tpu does.  finalize_counts is kernel KK (:868) and
cuckoo_build kernel KL (cuckoo_build_device, :543).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from .kmer import canonical_hash, shard_and_keybody, srl
from .spectrum_dense import as_i32

_CUCKOO_GOLD = 0x9E3779B97F4A7C15
_ALT_C1 = 0x9E3779B9
_ALT_C2 = 0x85EBCA6B
_U64 = (1 << 64) - 1
BLK_SHIFT = 9
MAX_HASHES = 16  # csrc/bloom.cuh:BFC_MAX_HASHES
ARRIVAL_LIMIT = 0xFFFFFFFF  # KF keeps ~arrival in u32; 0 marks "unset"


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


def adjudicate_first_occurrence_plain(ret, arr, bf_shift: int,
                                      n_hashes: int):
    """Plain version of KI, the sort formulation of spectrum.py:
    adjudicate_first_occurrence (:217): the C * n_hashes probes sorted by
    (bit, arrival), each compared with its bit group's first arrival.  It
    needs no 2^bf_shift array.  ret, arr int64 [C] (arrivals below 2^63);
    returns fp, bool [C]."""
    C = ret.shape[0]
    H = n_hashes
    bits = bloom_probe_bits(ret, bf_shift, n_hashes).reshape(-1)
    a = arr.repeat_interleave(H)
    order = torch.sort(a, stable=True).indices
    order = order[torch.sort(bits[order], stable=True).indices]
    sb, sa = bits[order], a[order]
    first = torch.ones_like(sb, dtype=torch.bool)
    first[1:] = sb[1:] != sb[:-1]
    idx = torch.arange(sb.shape[0], device=sb.device)
    start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    hit = torch.empty_like(first)
    hit[order] = sa[start] < sa
    return hit.view(C, H).all(dim=1)


def adjudicate_sketch_plain(ret, arr, n, bf_shift: int, n_hashes: int):
    """Plain version of KF: KI's plain version on the low 32 bits of the
    arrivals.  ret int64 [C]; arr int32 [C], the low 32 bits of the first
    arrivals; n int32 [C] occurrences (saturated).  Returns (fp, keep),
    bool [C]."""
    fp = adjudicate_first_occurrence_plain(
        ret, arr.to(torch.int64) & 0xFFFFFFFF, bf_shift, n_hashes)
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
            f"device scratch, {free} free; adjudicate_first_occurrence (KI) "
            "gives the same verdicts without it")
    dense = torch.empty((1 << bf_shift,), dtype=torch.int32, device=dev)
    fp = torch.empty((C,), dtype=torch.bool, device=dev)
    keep = torch.empty((C,), dtype=torch.bool, device=dev)
    kernels.KF.launch("kf_launch", C, ret.data_ptr(), arr.data_ptr(),
                      n.data_ptr(), bf_shift, n_hashes, dense.data_ptr(),
                      fp.data_ptr(), keep.data_ptr())
    return fp, keep


def block_order(ret, arr, bf_shift: int):
    """KI's input order: perm sorts the rows by (Bloom block, arrival),
    stable; block j of the sorted rows is perm[starts[j]:starts[j + 1]]
    (starts int64, its last entry the row count)."""
    C = ret.shape[0]
    block = ret & ((1 << (bf_shift - BLK_SHIFT)) - 1)
    perm = torch.sort(arr, stable=True).indices
    perm = perm[torch.sort(block[perm], stable=True).indices]
    sb = block[perm]
    del block
    head = torch.ones((C,), dtype=torch.bool, device=ret.device)
    head[1:] = sb[1:] != sb[:-1]
    del sb
    starts = torch.cat([torch.nonzero(head).flatten(),
                        torch.full((1,), C, dtype=torch.int64,
                                   device=ret.device)])
    return perm, starts


def adjudicate_first_occurrence(ret, arr, bf_shift: int, n_hashes: int):
    """Exact first-occurrence verdicts at any arrival width (kernel KI):
    fp[i], the first occurrence of row i found all its Bloom bits set by
    an earlier first arrival.  ret, arr int64 [C], arrivals below 2^63.

    The rows are sorted by (Bloom block, arrival) with two stable
    torch.sort passes, the block boundaries found with torch.nonzero, and
    KI replays each block in arrival order over its 512 bits.  On the card
    the sorts hold ~64 bytes a row; a card without them free raises."""
    C = ret.shape[0]
    dev = ret.device
    kernels.check(ret, "ret", torch.int64, (C,), dev)
    kernels.check(arr, "arr", torch.int64, (C,), dev)
    check_n_hashes(n_hashes)
    if dev.type == "cpu":
        return adjudicate_first_occurrence_plain(ret, arr, bf_shift, n_hashes)
    need = 64 * C
    free = kernels.device_free_bytes(dev)
    if need > free:
        raise RuntimeError(
            f"the first-occurrence verdict of {C} rows needs {need} device "
            f"bytes, {free} free")
    perm, starts = block_order(ret, arr, bf_shift)
    fp = torch.empty((C,), dtype=torch.bool, device=dev)
    kernels.KI.launch("ki_launch", starts.shape[0] - 1, starts.data_ptr(),
                      perm.data_ptr(), ret.data_ptr(), arr.data_ptr(),
                      bf_shift, n_hashes, fp.data_ptr())
    return fp


class Verdict(NamedTuple):
    fp: torch.Tensor    # bool [C]
    keep: torch.Tensor  # bool [C], n - 1 + fp >= 1
    by: str             # the kernel that gave fp: "KF" or "KI"


def adjudicate(ret, arr, n, bf_shift: int, n_hashes: int) -> Verdict:
    """First-occurrence verdicts and the keep set n - 1 + fp >= 1, as both
    of bfc_tpu's device verdicts choose (counter.py:756-765, trimmer.py:
    126-130): KF while every first arrival is below 2^32 - 1, KI above.
    ret, arr, n int64 [C]."""
    C = ret.shape[0]
    kernels.check(n, "n", torch.int64, (C,), ret.device)
    arr_max = int(arr.max()) if C else 0
    if arr_max < ARRIVAL_LIMIT:
        fp, keep = adjudicate_sketch(
            ret, as_i32(arr), n.clamp(max=0x7FFFFFFF).to(torch.int32),
            bf_shift, n_hashes)
        return Verdict(fp, keep, "KF")
    fp = adjudicate_first_occurrence(ret, arr, bf_shift, n_hashes)
    return Verdict(fp, n - 1 + fp.to(torch.int64) >= 1, "KI")


# ---------------------------------------------------------------------------
# The device finalize: payloads and histograms (KK), the cuckoo build (KL)
# ---------------------------------------------------------------------------

def finalize_counts_plain(n, n_high, first_high, fp):
    """Plain version of KK."""
    f = fp.to(torch.int64)
    m = n - 1 + f
    high = (n_high - (1 - f) * first_high.to(torch.int64)).clamp(max=63)
    keep = m >= 1
    payload = torch.where(keep, m.clamp(max=255) | (high << 8), 0)
    hist = torch.bincount(payload[keep] & 255, minlength=256)
    hist_high = torch.bincount(payload[keep] >> 8, minlength=64)
    return payload.to(torch.int32), keep, hist, hist_high


def finalize_counts(n, n_high, first_high, fp):
    """Table payloads of a folded run (kernel KK; spectrum.py:
    finalize_counts_fp, :868): (payload int32 [C], keep bool [C], hist
    int64 [256], hist_high int64 [64]).  m = n - 1 + fp, high = n_high -
    (1 - fp) * first_high; a row is kept when m >= 1, with payload
    min(m, 255) | min(high, 63) << 8 (0 when dropped).  hist counts the
    kept rows by count (bin 0 stays 0), hist_high by high.  n, n_high
    int64 [C]; first_high uint8 [C]; fp bool [C]."""
    C = n.shape[0]
    dev = n.device
    kernels.check(n, "n", torch.int64, (C,), dev)
    kernels.check(n_high, "n_high", torch.int64, (C,), dev)
    kernels.check(first_high, "first_high", torch.uint8, (C,), dev)
    kernels.check(fp, "fp", torch.bool, (C,), dev)
    if dev.type == "cpu":
        return finalize_counts_plain(n, n_high, first_high, fp)
    payload = torch.empty((C,), dtype=torch.int32, device=dev)
    keep = torch.empty((C,), dtype=torch.bool, device=dev)
    hist = torch.zeros((256,), dtype=torch.int64, device=dev)
    hist_high = torch.zeros((64,), dtype=torch.int64, device=dev)
    kernels.KK.launch("kk_launch", C, n.data_ptr(), n_high.data_ptr(),
                      first_high.data_ptr(), fp.data_ptr(),
                      payload.data_ptr(), keep.data_ptr(), hist.data_ptr(),
                      hist_high.data_ptr())
    return payload, keep, hist, hist_high


_I64_MIN = -(1 << 63)


def cuckoo_build_plain(shard, keybody, payload, k: int, l_pre: int,
                       kb_bits: int, c_bits: int, max_rounds: int = 256):
    """Plain version of KL: cuckoo_build_device's synchronous rounds
    (spectrum.py:543-605).  Every unplaced key claims its current slot; a
    scatter-max of a per-round priority picks each slot's winner; losers
    and evicted keys turn to their other slot.  u64 priorities ride in
    int64 with the sign bit flipped, so the signed amax orders them as
    unsigned.  Rows with payload 0 are skipped."""
    S = 1 << c_bits
    n = shard.shape[0]
    dev = shard.device
    s1 = srl(_posk64(shard, keybody, l_pre, kb_bits), 64 - c_bits)
    qlow = _id_low(shard, keybody, l_pre, kb_bits, c_bits)
    s2 = s1 ^ cuckoo_alt(qlow, c_bits)
    payload = payload.to(torch.int64)
    valid = payload != 0
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    idb = max(n.bit_length(), 1)
    occupant = torch.full((S,), -1, dtype=torch.int64, device=dev)
    cur = s1.clone()
    pref = torch.zeros((n,), dtype=torch.int64, device=dev)
    for rnd in range(max_rounds):
        pend = valid & (occupant[cur] != ids)
        if not bool(pend.any()):
            break
        prio = (ids + _to_i64(_CUCKOO_GOLD)) * _to_i64(
            (rnd * 2 + 0xBF58476D1CE4E5B9) & _U64)
        wval = (srl(prio, idb + 1) << (idb + 1)) | (ids + 1)
        claim = torch.full((S,), _I64_MIN, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, cur[pend], (wval ^ _I64_MIN)[pend], "amax")
        won = ((claim ^ _I64_MIN) & ((1 << (idb + 1)) - 1)) - 1
        occupant = torch.where(claim != _I64_MIN, won, occupant)
        pend2 = valid & (occupant[cur] != ids)
        pref = pref ^ pend2.to(torch.int64)
        cur = torch.where(pend2, torch.where(pref == 0, s1, s2), cur)
    placed = valid & (occupant[cur] == ids)
    ok = not bool((valid & ~placed).any())
    table = torch.zeros((S,), dtype=torch.int64, device=dev)
    table[cur[placed]] = ((qlow << 15) | (pref << 14) | payload)[placed]
    return table, ok


def cuckoo_build(shard, keybody, payload, k: int, l_pre: int, kb_bits: int,
                 c_bits: int):
    """The cuckoo table of the kept entries (kernel KL): (int64
    [1 << c_bits] of u64 entries, as cuckoo_probe reads them; ok).  ok is
    False when a key could not be placed; build again one bit larger.
    shard, keybody int64 [n]; payload int32 [n], non-zero.  The layout
    is not deterministic on the card; lookups are."""
    n = shard.shape[0]
    dev = shard.device
    kernels.check(shard, "shard", torch.int64, (n,), dev)
    kernels.check(keybody, "keybody", torch.int64, (n,), dev)
    kernels.check(payload, "payload", torch.int32, (n,), dev)
    if l_pre + kb_bits - c_bits > 49:
        raise ValueError(f"c_bits {c_bits}: qlow does not fit the entry")
    if dev.type == "cpu":
        return cuckoo_build_plain(shard, keybody, payload, k, l_pre, kb_bits,
                                  c_bits)
    need = 8 << c_bits
    free = kernels.device_free_bytes(dev)
    if need > free:
        raise RuntimeError(f"a cuckoo table of 2^{c_bits} entries needs "
                           f"{need} device bytes, {free} free")
    table = torch.zeros((1 << c_bits,), dtype=torch.int64, device=dev)
    fail = torch.zeros((1,), dtype=torch.int32, device=dev)
    kernels.KL.launch("kl_launch", n, shard.data_ptr(), keybody.data_ptr(),
                      payload.data_ptr(), l_pre, kb_bits, c_bits,
                      table.data_ptr(), fail.data_ptr())
    return table, int(fail) == 0
