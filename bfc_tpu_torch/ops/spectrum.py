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

ShardedTable is the prefix-sharded layout (ShardedCuckoo, :316): one
sub-table a rank, built by kernel KN (cuckoo_build_local, :467) and read
by cuckoo_addr (its sharded branch) inside KC and KD, which replaces
sharded_cuckoo_lookup (:368).

bloom_probe_bits is the plain twin of csrc/bloom.cuh (spectrum.py:184).
adjudicate_sketch is kernel KF (spectrum.py:adjudicate_sketch, :843, with
the keep rule of trimmer.py:filter_keep_rets, :81) and
adjudicate_first_occurrence kernel KI (:217); adjudicate chooses between
them as bfc_tpu does.  finalize_counts is kernel KK (:868),
cuckoo_build kernel KL (cuckoo_build_device, :543) and cuckoo_build_local
kernel KN (:467).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import kernels
from ..utils.log import log
from .kmer import canonical_hash, shard_and_keybody, srl
from .spectrum_dense import as_i32

_CUCKOO_GOLD = 0x9E3779B97F4A7C15
_ALT_C1 = 0x9E3779B9
_ALT_C2 = 0x85EBCA6B
_U64 = (1 << 64) - 1
BLK_SHIFT = 9
MAX_HASHES = 16  # csrc/bloom.cuh:BFC_MAX_HASHES
ARRIVAL_LIMIT = 0xFFFFFFFF  # KF keeps arrivals in u32; all-ones marks "unset"
RECORD_BYTES = {"KF": 8, "KI": 16}  # a row's record (csrc/verdict.cuh)
SCAN_TILE = 2048           # histogram words a scan tile (VD_SCAN_TILE)
SB_MAX = 8                 # at most 2^8 blocks a superblock (VD_MAX_SB)
SB_ROWS = 1024             # a superblock's rows, at most, on average
WIN_BITS = 12              # KL's and KN's window of slots (CK_WIN_BITS)
CK_HDR = 3                 # their counters' header words (CK_HDR)


class SpecTable(NamedTuple):
    """A cuckoo table and the identity layout that addresses it."""

    table: torch.Tensor  # int64 [1 << c_bits], u64 entry bits
    k: int
    l_pre: int
    kb_bits: int
    c_bits: int

    @property
    def device(self) -> torch.device:
        return self.table.device


class ShardedTable(NamedTuple):
    """The prefix-sharded spectrum (bfc_tpu's ShardedCuckoo, spectrum.py:
    316-343): R = 2^db independent cuckoo sub-tables of 2^cb_local
    entries, one a rank.  Sub-table r holds the keys whose 64-bit
    position key pk has r in its top db bits; c_bits = db + cb_local is
    the global width that s1 and qlow come from: s1 is the cb_local bits
    of pk below the owner's, qlow the identity bits below the top c_bits,
    and s2 = s1 ^ subtable_alt(qlow, cb_local).  Entries are SpecTable's.

    subtables holds R int64 tensors [1 << cb_local]: on the CPU the
    ranks' sub-tables all-gathered; on the card views of each rank's own
    allocation, the peers' mapped through CUDA IPC (parallel/peer.py).
    ptrs is the int64 [R] device array of their addresses that KC and KD
    read (None on the CPU); buffers holds the allocations behind the
    views, which peer.release closes and frees."""

    subtables: Tuple[torch.Tensor, ...]
    ptrs: Optional[torch.Tensor]
    k: int
    l_pre: int
    kb_bits: int
    c_bits: int
    db: int
    buffers: tuple = ()

    @property
    def cb_local(self) -> int:
        return self.c_bits - self.db

    @property
    def device(self) -> torch.device:
        return self.subtables[0].device if self.ptrs is None \
            else self.ptrs.device


def sharded_table(subtables, k: int, l_pre: int, kb_bits: int, db: int,
                  buffers: tuple = (), device=None) -> ShardedTable:
    """A ShardedTable over R = 2^db sub-tables of one size.  On the card
    (device, else the first sub-table's) the address array is built from
    the sub-tables; a peer's view may lie on the peer's card, and
    buffers, where given, hold the addresses mapped in this process."""
    subtables = tuple(subtables)
    if len(subtables) != 1 << db:
        raise ValueError(f"{len(subtables)} sub-tables for db {db}")
    cb_local = subtables[0].shape[0].bit_length() - 1
    dev = subtables[0].device if device is None else torch.device(device)
    for t in subtables:
        kernels.check(t, "sub-table", torch.int64, (1 << cb_local,),
                      dev if dev.type == "cpu" else t.device)
    ptrs = None
    if dev.type == "cuda":
        ptrs = torch.tensor([t.data_ptr() for t in subtables],
                            dtype=torch.int64, device=dev)
    return ShardedTable(subtables, ptrs, k, l_pre, kb_bits, db + cb_local,
                        db, buffers)


def check_table(t, dev) -> None:
    """Raise unless the table t serves probes on dev: a SpecTable on dev,
    a ShardedTable with its address array on dev (its peers' sub-tables
    may lie on their cards) or, on the CPU, its sub-tables there."""
    if isinstance(t, ShardedTable):
        if dev.type == "cpu":
            for sub in t.subtables:
                kernels.check(sub, "sub-table", torch.int64,
                              (1 << t.cb_local,), dev)
        else:
            kernels.check(t.ptrs, "ptrs", torch.int64, (1 << t.db,), dev)
        return
    kernels.check(t.table, "table", torch.int64, (1 << t.c_bits,), dev)


def probe_args(t):
    """(table, subtables, db) as KC's and KD's launchers take them: the
    replicated table's address, or the sharded table's address array."""
    if isinstance(t, ShardedTable):
        return None, t.ptrs.data_ptr(), t.db
    return t.table.data_ptr(), None, 0


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


def subtable_alt(qlow, cb_local: int):
    """Alternate-slot offset in a sub-table: the 64-bit multiplicative
    hash at every cb_local (spectrum.py:440), unlike cuckoo_alt."""
    return srl(qlow * _to_i64(_CUCKOO_GOLD), 64 - cb_local)


def subtable_owner(shard, keybody, l_pre: int, kb_bits: int, db: int):
    """The sub-table, of 2^db, that holds each int64 (shard, keybody)
    key: the top db bits of its position key."""
    pk = _posk64(shard, keybody, l_pre, kb_bits)
    return srl(pk, 64 - db) if db else torch.zeros_like(pk)


def subtable_slots(shard, keybody, l_pre: int, kb_bits: int, c_bits: int,
                   db: int):
    """(owner, s1, s2, qlow) of int64 (shard, keybody) keys in a table of
    2^db sub-tables of 2^(c_bits - db) entries (csrc/cuckoo.cuh)."""
    pk = _posk64(shard, keybody, l_pre, kb_bits)
    cb_local = c_bits - db
    owner = subtable_owner(shard, keybody, l_pre, kb_bits, db)
    s1 = srl(pk, 64 - c_bits) & ((1 << cb_local) - 1)
    qlow = _id_low(shard, keybody, l_pre, kb_bits, c_bits)
    return owner, s1, s1 ^ subtable_alt(qlow, cb_local), qlow


def _pick(e1, e2, qlow):
    def match(e, nest):
        return ((e & 0x3FFF) != 0) & (((e >> 14) & 1) == nest) \
            & (srl(e, 15) == qlow)

    return torch.where(match(e1, 0), e1 & 0x3FFF,
                       torch.where(match(e2, 1), e2 & 0x3FFF, -1))


def cuckoo_lookup_plain(t, shard, keybody):
    """Payload (int64, -1 absent) of each (shard, keybody) int64 query, in
    a SpecTable or, from its owner's sub-table, a ShardedTable."""
    if isinstance(t, ShardedTable):
        owner, s1, s2, qlow = subtable_slots(shard, keybody, t.l_pre,
                                             t.kb_bits, t.c_bits, t.db)
        e1 = torch.empty_like(s1)
        e2 = torch.empty_like(s2)
        for r, sub in enumerate(t.subtables):
            sel = owner == r
            e1[sel] = sub[s1[sel]]
            e2[sel] = sub[s2[sel]]
        return _pick(e1, e2, qlow)
    c_bits = t.c_bits
    s1 = srl(_posk64(shard, keybody, t.l_pre, t.kb_bits), 64 - c_bits)
    qlow = _id_low(shard, keybody, t.l_pre, t.kb_bits, c_bits)
    s2 = s1 ^ cuckoo_alt(qlow, c_bits)
    return _pick(t.table[s1], t.table[s2], qlow)


def kmer_occ_plain(t, x0, x1, x2, x3):
    """Payload of each 4-plane k-mer (vectorized CountHash.kmer_occ)."""
    _, h0, h1 = canonical_hash(x0, x1, x2, x3, t.k)
    shard, keybody = shard_and_keybody(h0, h1, t.k, t.l_pre)
    return cuckoo_lookup_plain(t, shard, keybody)


def _to_i64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


class IntProbe:
    """CountHash-shaped view of a cuckoo table for the per-read plain
    search: kmer_occ(x) on Python-integer planes, probing a host copy of
    the table with the same arithmetic as cuckoo_probe (a ShardedTable:
    of every sub-table, as cuckoo_addr).  n_probes counts the
    kmer_occ calls."""

    def __init__(self, t):
        self.n_probes = 0
        self.k = t.k
        self.l_pre = t.l_pre
        self.kb_bits = t.kb_bits
        self.c_bits = t.c_bits
        self.db = t.db if isinstance(t, ShardedTable) else None
        subs = t.subtables if self.db is not None else (t.table,)
        self.entries = [s.cpu().numpy().view("uint64") for s in subs]

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
        entries = self.entries[0]
        if self.db is not None:
            cb_local = c_bits - self.db
            if self.db:
                entries = self.entries[pk >> (64 - self.db)]
            s1 &= (1 << cb_local) - 1
            alt = ((qlow * _CUCKOO_GOLD) & _U64) >> (64 - cb_local)
        elif c_bits > 32:
            alt = ((qlow * _CUCKOO_GOLD) & _U64) >> (64 - c_bits)
        else:
            alt = ((((qlow & 0xFFFFFFFF) * _ALT_C1) ^ ((qlow >> 32) * _ALT_C2))
                   & 0xFFFFFFFF) >> (32 - c_bits)
        for slot, nest in ((s1, 0), (s1 ^ alt, 1)):
            e = int(entries[slot])
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


def verdict_shift(rows: int, bf_shift: int) -> int:
    """S: KF and KI group the rows by superblocks of 2^S Bloom blocks,
    the most blocks (up to 2^SB_MAX) that keep a superblock at SB_ROWS
    rows or fewer on average (csrc/verdict.cuh)."""
    x = max(bf_shift - BLK_SHIFT, 0)
    s = 0
    while s < min(SB_MAX, x) and rows << (s + 1) <= SB_ROWS << x:
        s += 1
    return s


def _verdict_layout(rows: int, bf_shift: int, kernel: str):
    """Byte offsets in the verdict's scratch of its records, slots,
    superblock histogram, scan tile sums and verdict bytes, and its
    size."""
    n_super = 1 << (max(bf_shift - BLK_SHIFT, 0) - verdict_shift(rows,
                                                                 bf_shift))
    slot = RECORD_BYTES[kernel] * rows
    cnt = slot + 4 * rows
    sums = cnt + 4 * n_super
    flags = sums + 4 * -(-n_super // SCAN_TILE)
    return slot, cnt, sums, flags, flags + rows


def verdict_bytes(rows: int, bf_shift: int, kernel: str) -> int:
    """Device scratch of KF's or KI's verdict: a record (8 or 16 bytes), a
    slot (4) and a verdict byte a row, the superblock histogram (4 bytes
    a superblock) and one word a scan tile of it."""
    return _verdict_layout(rows, bf_shift, kernel)[-1]


# what the verdict's raise suggests: correction's spectrum can be judged
# on the host, which needs no device scratch
HOST_FINALIZE = ("the host finalize (BFC_TPU_DEVICE_FINALIZE unset) judges "
                 "a correction spectrum on the host")


def verdict_scratch(rows: int, bf_shift: int, dev, kernel: str):
    """The verdict's scratch on dev: (the tensor, which must outlive the
    launch, S, and the addresses of its records, slots, verdict bytes,
    histogram and tile sums).  Raises where the card lacks the bytes or
    the rows pass the 31-bit slots of the histogram."""
    if rows >= 1 << 31:
        raise ValueError(f"the verdict takes fewer than 2^31 rows, not {rows}")
    slot, cnt, sums, flags, need = _verdict_layout(rows, bf_shift, kernel)
    free = kernels.device_free_bytes(dev)
    if need > free:
        raise RuntimeError(
            f"the {kernel} verdict of {rows} rows at -b{bf_shift} needs "
            f"{need} bytes of device scratch "
            f"({RECORD_BYTES[kernel] + 5} a row, 4 a superblock of Bloom "
            f"blocks), {free} free; {HOST_FINALIZE}")
    buf = torch.empty((need,), dtype=torch.uint8, device=dev)
    base = buf.data_ptr()
    return (buf, verdict_shift(rows, bf_shift), base, base + slot,
            base + flags, base + cnt, base + sums)


def adjudicate_sketch(ret, arr, n, bf_shift: int, n_hashes: int):
    """Which distinct k-mers enter the trim mode's bf_high (kernel KF).

    fp: the first occurrence found all its Bloom bits set by an earlier
    arrival; keep: n - 1 + fp >= 1.  Inputs as adjudicate_sketch_plain;
    arrivals must be below 2^32 - 1 (the caller checks).  On the card the
    rows are grouped by superblock of Bloom blocks, then by block in
    shared memory, and judged there (csrc/verdict.cuh, u32 arrivals), in
    verdict_bytes of scratch; a card without them free raises."""
    C = ret.shape[0]
    dev = ret.device
    kernels.check(ret, "ret", torch.int64, (C,), dev)
    kernels.check(arr, "arr", torch.int32, (C,), dev)
    kernels.check(n, "n", torch.int32, (C,), dev)
    check_n_hashes(n_hashes)
    if dev.type == "cpu":
        return adjudicate_sketch_plain(ret, arr, n, bf_shift, n_hashes)
    _scratch, sb, *addrs = verdict_scratch(C, bf_shift, dev, "KF")
    fp = torch.empty((C,), dtype=torch.bool, device=dev)
    keep = torch.empty((C,), dtype=torch.bool, device=dev)
    kernels.KF.launch("kf_launch", C, ret.data_ptr(), arr.data_ptr(),
                      n.data_ptr(), bf_shift, sb, n_hashes, *addrs,
                      fp.data_ptr(), keep.data_ptr())
    return fp, keep


def adjudicate_first_occurrence(ret, arr, bf_shift: int, n_hashes: int):
    """Exact first-occurrence verdicts at any arrival width (kernel KI):
    fp[i], the first occurrence of row i found all its Bloom bits set by
    an earlier first arrival.  ret, arr int64 [C], arrivals below 2^63.

    On the card KF's design on u64 arrivals: the rows grouped by Bloom
    block (superblocks, then blocks in shared memory), no sort, each
    block judged in shared memory, in verdict_bytes of scratch; a card
    without them free raises."""
    C = ret.shape[0]
    dev = ret.device
    kernels.check(ret, "ret", torch.int64, (C,), dev)
    kernels.check(arr, "arr", torch.int64, (C,), dev)
    check_n_hashes(n_hashes)
    if dev.type == "cpu":
        return adjudicate_first_occurrence_plain(ret, arr, bf_shift, n_hashes)
    _scratch, sb, *addrs = verdict_scratch(C, bf_shift, dev, "KI")
    fp = torch.empty((C,), dtype=torch.bool, device=dev)
    kernels.KI.launch("ki_launch", C, ret.data_ptr(), arr.data_ptr(),
                      bf_shift, sb, n_hashes, *addrs, fp.data_ptr())
    return fp


class Verdict(NamedTuple):
    fp: torch.Tensor    # bool [C]
    keep: torch.Tensor  # bool [C], n - 1 + fp >= 1
    by: str             # the kernel that gave fp: "KF" or "KI"


def verdict_route(arr_max: int, rows: int, bf_shift: int,
                  free_bytes: Optional[int]) -> str:
    """The kernel that gives the verdicts, chosen before any launch: KF
    while every first arrival is below 2^32 - 1, else KI.  Each needs
    verdict_bytes(rows, bf_shift, kernel); where free_bytes (None: no
    limit, as for the plain versions on the CPU) falls short, this
    raises."""
    by = "KF" if arr_max < ARRIVAL_LIMIT else "KI"
    need = verdict_bytes(rows, bf_shift, by)
    if free_bytes is not None and need > free_bytes:
        raise RuntimeError(
            f"the {by} verdict of {rows} rows at -b{bf_shift} needs {need} "
            f"bytes of device scratch, {free_bytes} free; {HOST_FINALIZE}")
    return by


def adjudicate(ret, arr, n, bf_shift: int, n_hashes: int) -> Verdict:
    """First-occurrence verdicts and the keep set n - 1 + fp >= 1, as both
    of bfc_tpu's device verdicts choose (counter.py:756-765, trimmer.py:
    126-130): KF while every first arrival is below 2^32 - 1, KI above
    (verdict_route).  ret, arr, n int64 [C]."""
    C = ret.shape[0]
    dev = ret.device
    kernels.check(n, "n", torch.int64, (C,), dev)
    arr_max = int(arr.max()) if C else 0
    free = None if dev.type == "cpu" else kernels.device_free_bytes(dev)
    by = verdict_route(arr_max, C, bf_shift, free)
    if free is not None:
        log(f"verdict {by}: first arrivals up to {arr_max}; scratch "
            f"{verdict_bytes(C, bf_shift, by)} bytes, {free} free")
    if by == "KF":
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


def _place_plain(s1, s2, qlow, payload, S: int, max_rounds: int):
    """The synchronous placement rounds of cuckoo_build_device (spectrum.
    py:543-605) and cuckoo_build_local (:467-538) over a table of S slots.
    Every unplaced key claims its current slot; a scatter-max of a
    per-round priority picks each slot's winner; losers and evicted keys
    turn to their other slot.  u64 priorities ride in int64 with the sign
    bit flipped, so the signed amax orders them as unsigned.  Rows with
    payload 0 are skipped.  Returns (table, ok)."""
    n = s1.shape[0]
    dev = s1.device
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


def cuckoo_build_plain(shard, keybody, payload, k: int, l_pre: int,
                       kb_bits: int, c_bits: int, max_rounds: int = 256):
    """Plain version of KL: cuckoo_build_device's synchronous rounds
    (spectrum.py:543-605)."""
    s1 = srl(_posk64(shard, keybody, l_pre, kb_bits), 64 - c_bits)
    qlow = _id_low(shard, keybody, l_pre, kb_bits, c_bits)
    return _place_plain(s1, s1 ^ cuckoo_alt(qlow, c_bits), qlow, payload,
                        1 << c_bits, max_rounds)


def cuckoo_build_local_plain(shard, keybody, payload, l_pre: int,
                             kb_bits: int, c_bits: int, db: int,
                             max_rounds: int = 256):
    """Plain version of KN: cuckoo_build_local's rounds (spectrum.py:
    467-538) over one sub-table of 2^(c_bits - db) slots."""
    _, s1, s2, qlow = subtable_slots(shard, keybody, l_pre, kb_bits, c_bits,
                                     db)
    return _place_plain(s1, s2, qlow, payload, 1 << (c_bits - db),
                        max_rounds)


def cuckoo_scratch(n: int, table_bits: int, dev):
    """The scratch of one KL or KN build of n keys into 2^table_bits
    slots (csrc/cuckoo.cuh): the records, int64 [n, 2] (a row index
    while the keys are grouped by window, then an overflow entry and its
    second slot), and the counters, int64 (the failure count, the
    out-of-order and gap flags, then each window's first row, cursor and
    overflow count)."""
    return (torch.empty((n, 2), dtype=torch.int64, device=dev),
            torch.empty((_meta_words(table_bits),), dtype=torch.int64,
                        device=dev))


def _meta_words(table_bits: int) -> int:
    nw = 1 << (table_bits - min(WIN_BITS, table_bits))
    return CK_HDR + 3 * nw + 1


def cuckoo_enqueue(kern, geom, shard, keybody, payload, table, rec, meta):
    """Enqueue one window build (KL, or KN with geom's cb_local) of the
    keys into table on the current stream, with no wait: the counters
    cleared, then five kernels: the count of keys a window, which also
    gives each window's first row where the rows are in window order;
    the scan and the scatter, which then return at once; the window
    build, which writes every slot of the table; and the overflow
    inserts (no keys: the build alone).  geom: (l_pre, kb_bits, c_bits)
    for KL, (l_pre, kb_bits, c_bits, cb_local) for KN.  Returns the
    failure count, a view of meta."""
    n = shard.shape[0]
    kern.launch("kn_launch" if kern is kernels.KN else "kl_launch", n,
                shard.data_ptr(), keybody.data_ptr(), payload.data_ptr(),
                *geom, meta.data_ptr(), rec.data_ptr(), table.data_ptr(),
                kernels=5 if n else 1)
    return meta[:1]


def _window_build(kern, geom, shard, keybody, payload, table_bits: int,
                  out=None, what: str = "a cuckoo table"):
    """A card build into out, else a new table of 2^table_bits slots
    (every slot written): (table, ok), with one wait, on the failure
    count.  A card without room for the table and scratch raises."""
    n, dev = shard.shape[0], shard.device
    try:
        table = out if out is not None else torch.empty(
            (1 << table_bits,), dtype=torch.int64, device=dev)
        rec, meta = cuckoo_scratch(n, table_bits, dev)
    except torch.cuda.OutOfMemoryError as e:
        need = 16 * n + 8 * _meta_words(table_bits) + (
            0 if out is not None else 8 << table_bits)
        raise RuntimeError(f"{what} of 2^{table_bits} entries needs {need} "
                           f"device bytes, {kernels.device_free_bytes(dev)} "
                           "free") from e
    fail = cuckoo_enqueue(kern, geom, shard, keybody, payload, table, rec,
                          meta)
    return table, int(fail) == 0


def cuckoo_build_local(shard, keybody, payload, l_pre: int, kb_bits: int,
                       c_bits: int, db: int, out=None):
    """One rank's sub-table of a ShardedTable (kernel KN): (int64
    [1 << (c_bits - db)] of u64 entries, ok).  The keys must be the
    rank's own (their owner under the sub-table rule); ok is False when a
    key could not be placed, and every rank then builds again one bit
    larger.  out, where given, is the int64 tensor of that size to build
    into (the exportable allocation of parallel/peer.py); the build
    writes every slot.  shard, keybody int64 [n]; payload int32 [n],
    non-zero.  The layout is not deterministic on the card; lookups
    are."""
    n = shard.shape[0]
    dev = shard.device
    cb_local = c_bits - db
    kernels.check(shard, "shard", torch.int64, (n,), dev)
    kernels.check(keybody, "keybody", torch.int64, (n,), dev)
    kernels.check(payload, "payload", torch.int32, (n,), dev)
    if out is not None:
        kernels.check(out, "out", torch.int64, (1 << cb_local,), dev)
    if l_pre + kb_bits - c_bits > 49:
        raise ValueError(f"c_bits {c_bits}: qlow does not fit the entry")
    if dev.type == "cpu":
        table, ok = cuckoo_build_local_plain(shard, keybody, payload, l_pre,
                                             kb_bits, c_bits, db)
        if out is not None:
            table = out.copy_(table)
        return table, ok
    return _window_build(kernels.KN, (l_pre, kb_bits, c_bits, cb_local),
                         shard, keybody, payload, cb_local, out,
                         "a sub-table")


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
    return _window_build(kernels.KL, (l_pre, kb_bits, c_bits), shard,
                         keybody, payload, c_bits)
