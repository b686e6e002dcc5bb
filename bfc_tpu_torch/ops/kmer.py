"""The counting pass's k-mer stream (kernel KA) and the int64 hash helpers.

Counterpart of bfc_tpu/ops/kmer.py.  Hashes, planes and identities are
u64 values; torch on the CPU has no unsigned 64-bit arithmetic, so the
plain versions carry their bit patterns in int64 tensors: additions and
left shifts wrap exactly as in u64, masks keep values below 2^63 where
they can, and `srl` emulates the logical right shift wherever bit 63 can
be set (z at k = 32, the cuckoo position key, table entries).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

INVALID_SHARD = 0xFFFFFFFF


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 bit patterns held in int64."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def wang_hash(key: torch.Tensor, mask: int) -> torch.Tensor:
    """Thomas Wang's mix under mask (kmer.h:30-40); key < 2^63."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def canonical_hash(x0, x1, x2, x3, k: int):
    """(ret, h0, h1) of the 4-plane k-mers (kmer.h:79-88); ret is the low
    64 bits of the Bloom-addressing hash."""
    mask = (1 << k) - 1
    t = k >> 1
    u = ((x1 >> t) & 1) > ((x3 >> t) & 1)
    a0 = torch.where(u, x2, x0)
    a1 = torch.where(u, x3, x1)
    w0 = wang_hash((a0 + a1) & mask, mask)
    h1 = wang_hash(w0 ^ a1, mask)
    h0 = (w0 + h1) & mask
    return ((w0 ^ h1) << k) | h0, h0, h1


def shard_and_keybody(h0, h1, k: int, l_pre: int):
    """Split the hash pair into (shard, in-shard identity) - htab.c:45-58."""
    if k <= 32:
        t = 2 * k - l_pre
        z = (h0 << k) | h1
        return srl(z, t), z & ((1 << t) - 1)
    t = k - l_pre
    shift = k if t + k < 50 else 50 - t
    return h0 >> t, ((h0 & ((1 << t) - 1)) << shift) ^ h1


def keybody_bits(k: int, l_pre: int) -> int:
    """Bit-width of the in-shard identity."""
    if k <= 32:
        return 2 * k - l_pre
    t = k - l_pre
    shift = k if t + k < 50 else 50 - t
    return t + shift


def append_base(x, c, k: int):
    """Roll base codes c (0..3, int64) into the planes (kmer.h:10-17)."""
    mask = (1 << k) - 1
    lo = c & 1
    hi = c >> 1
    return (((x[0] << 1) | lo) & mask, ((x[1] << 1) | hi) & mask,
            (x[2] >> 1) | ((lo ^ 1) << (k - 1)),
            (x[3] >> 1) | ((hi ^ 1) << (k - 1)))


def kmer_stream_plain(bases, qual_ok, lens, k: int, l_pre: int,
                      arrival_base: int = 0, with_ret: bool = False):
    """Plain version of KA: every read rolled at once, one slot a step."""
    B, L = bases.shape
    dev = bases.device
    z = torch.zeros((B,), dtype=torch.int64, device=dev)
    x = (z, z, z, z)
    run = z
    qrun = z
    lens64 = lens.to(torch.int64)
    shard = torch.empty((B, L), dtype=torch.int64, device=dev)
    keybody = torch.empty_like(shard)
    arrp = torch.empty_like(shard)
    ret = torch.empty_like(shard) if with_ret else None
    row0 = arrival_base + torch.arange(B, dtype=torch.int64, device=dev) * L
    for i in range(L):
        c = torch.where(lens64 > i, bases[:, i].to(torch.int64), 4)
        ok = c < 4
        nx = append_base(x, c.clamp(max=3), k)
        x = tuple(torch.where(ok, a, 0) for a in nx)
        run = torch.where(ok, run + 1, 0)
        qrun = torch.where(ok & qual_ok[:, i], qrun + 1, 0)
        valid = run >= k
        high = valid & (qrun >= k)
        r, h0, h1 = canonical_hash(*x, k)
        s, kb = shard_and_keybody(h0, h1, k, l_pre)
        shard[:, i] = torch.where(valid, s, INVALID_SHARD)
        keybody[:, i] = torch.where(valid, kb, 0)
        arrp[:, i] = ((row0 + i) << 1) | high.to(torch.int64)
        if with_ret:
            ret[:, i] = torch.where(valid, r, 0)
    return shard, keybody, arrp, ret


def kmer_stream(bases, qual_ok, lens, k: int, l_pre: int,
                arrival_base: int = 0, with_ret: bool = False):
    """Per-slot sort keys of a padded read batch (kernel KA).

    bases u8 [B, L] (codes 0..4), qual_ok bool [B, L], lens i32 [B].
    Returns int64 [B, L] tensors (shard, keybody, arrp, ret): shard is
    INVALID_SHARD where no full ACGT k-mer ends, arrp = arrival << 1 |
    is_high with arrival = arrival_base + flat slot index, and ret (the
    Bloom-addressing hash) is None unless with_ret."""
    B, L = bases.shape
    dev = bases.device
    kernels.check(bases, "bases", torch.uint8, (B, L), dev)
    kernels.check(qual_ok, "qual_ok", torch.bool, (B, L), dev)
    kernels.check(lens, "lens", torch.int32, (B,), dev)
    if dev.type == "cpu":
        return kmer_stream_plain(bases, qual_ok, lens, k, l_pre,
                                 arrival_base, with_ret)
    shard = torch.empty((B, L), dtype=torch.int64, device=dev)
    keybody = torch.empty_like(shard)
    arrp = torch.empty_like(shard)
    ret = torch.empty_like(shard) if with_ret else None
    kernels.KA.launch(
        "ka_launch", bases.data_ptr(), qual_ok.data_ptr(), lens.data_ptr(),
        B, L, k, l_pre, arrival_base, shard.data_ptr(), keybody.data_ptr(),
        arrp.data_ptr(), ret.data_ptr() if with_ret else None,
    )
    return shard, keybody, arrp, ret


# ---------------------------------------------------------------------------
# Host-side encoding
# ---------------------------------------------------------------------------

_BASE_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _BASE_LUT[_c] = _i
for _i, _c in enumerate(b"acgt"):
    _BASE_LUT[_c] = _i


def encode_batch(seqs, quals, q_thres: int, pad_to=None):
    """Encode python reads into padded (bases, qual_ok, lengths) arrays."""
    B = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), np.int32, count=B) if B else np.zeros(0, np.int32)
    L = int(lens.max()) if B else 0
    if pad_to is not None:
        L = max(L, pad_to)
    bases = np.full((B, L), 4, dtype=np.uint8)
    qok = np.zeros((B, L), dtype=bool)
    if B == 0:
        return bases, qok, lens
    total = int(lens.sum())
    rows = np.repeat(np.arange(B), lens)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    cols = np.arange(total) - np.repeat(offs, lens)
    flat_seq = np.frombuffer("".join(seqs).encode("ascii"), np.uint8)
    bases[rows, cols] = _BASE_LUT[flat_seq]
    if quals is None:
        qok[rows, cols] = True
    else:
        # per-read None entries are allowed (FASTA records): treat as all-OK
        flat_q = np.frombuffer(
            "".join(q if q is not None else "\x7f" * l
                    for q, l in zip(quals, lens)).encode("ascii"),
            np.uint8,
        )
        qok[rows, cols] = flat_q.astype(np.int32) - 33 >= q_thres
    return bases, qok, lens
