"""Counting runs on the card: sort a batch's k-mers, combine, merge (KB).

Counterpart of bfc_tpu/ops/spectrum_dense.py.  A run is the per-distinct-
k-mer aggregate of a contiguous stream span, sorted by (shard, keybody)
with one row per k-mer: n occurrences, n_high high-quality occurrences,
and the arrival and is_high of its first occurrence (plus the Bloom hash
`ret` where the identity cannot give it back).  Arrivals are flat stream
slot indices: batch b's slot (r, i) is arrival_base + r * L + i, with
every batch padded to B reads and the sticky L, exactly as bfc_tpu's
count_batches_aggregate numbers them.

The sort is torch.sort, as the JAX package left its sort to XLA's
lax.sort: two stable passes on int64, by keybody and then by shard
(identities reach 74 bits for k > 32, too wide for one key).  Stability
keeps stream order inside a key group, within a batch and for an
[older run, newer run] concatenation, so each group's first row is its
first occurrence - the precondition of the combine.  Kernel KB marks the
group heads, folds each group into its head and compacts the heads, in
one pass.

Kernel KE packs a run for its pull to the host (spectrum_dense.py:
pack_pull, :233): arrival, counts and first_high fold into two 32-bit
planes, and packed_run_to_host_agg (:258) unpacks them into a HostAgg.
With the device finalize the run never crosses: kernel KJ fills in ret
where the run does not carry it (run_to_aggregate, :312).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels
from . import kmer as kops
from .kmer import INVALID_SHARD


class Run(NamedTuple):
    shard: torch.Tensor     # int64 [C]
    keybody: torch.Tensor   # int64 [C]
    arr: torch.Tensor       # int64 [C] arrival of the first occurrence
    n: torch.Tensor         # int64 [C] occurrences
    n_high: torch.Tensor    # int64 [C] high-quality occurrences
    first_high: torch.Tensor  # uint8 [C] is_high of the first occurrence
    ret: Optional[torch.Tensor]  # int64 [C] Bloom hash, when carried

    def __len__(self) -> int:
        return self.shard.shape[0]


def ret_derivable(k: int, l_pre: int) -> bool:
    """Can ret be recomputed from (shard, keybody)?  (kmer.h:79-88)"""
    return k <= 32 or (k - l_pre) + k < 50


def stable_order(shard, keybody):
    """Permutation sorting rows by (shard, keybody), stable."""
    p = torch.sort(keybody, stable=True).indices
    return p[torch.sort(shard[p], stable=True).indices]


def run_combine_plain(srt: Run) -> Run:
    """Plain version of KB on a sorted run."""
    shard, keybody = srt.shard, srt.keybody
    valid = shard != INVALID_SHARD
    head = valid.clone()
    head[1:] &= (shard[1:] != shard[:-1]) | (keybody[1:] != keybody[:-1])
    hidx = torch.nonzero(head).flatten()
    gid = torch.cumsum(head.to(torch.int64), 0) - 1
    C = hidx.shape[0]

    def seg_sum(v):
        out = torch.zeros((C,), dtype=torch.int64, device=v.device)
        return out.index_add_(0, gid[valid], v[valid])

    return Run(shard[hidx], keybody[hidx], srt.arr[hidx], seg_sum(srt.n),
               seg_sum(srt.n_high), srt.first_high[hidx],
               None if srt.ret is None else srt.ret[hidx])


_kb = {}  # KB's rows a tile, and the pinned int64 of its group count


def run_combine(srt: Run) -> Run:
    """Combine equal keys of a sorted run into their head rows and compact
    (kernel KB: one launch; the outputs are allocated for every row and
    narrowed to the groups, whose count is the call's one host sync)."""
    N = len(srt)
    dev = srt.shard.device
    for name in ("shard", "keybody", "arr", "n", "n_high"):
        kernels.check(getattr(srt, name), name, torch.int64, (N,), dev)
    kernels.check(srt.first_high, "first_high", torch.uint8, (N,), dev)
    if srt.ret is not None:
        kernels.check(srt.ret, "ret", torch.int64, (N,), dev)
    if dev.type == "cpu":
        return run_combine_plain(srt)
    if not _kb:
        import ctypes

        tile = ctypes.c_longlong()
        kernels.KB.call("kb_tile_rows", ctypes.byref(tile))
        _kb["tile"] = tile.value
        _kb["count"] = torch.empty((1,), dtype=torch.int64, pin_memory=True)
    # one int64 allocation: the output columns, then the tile status words
    n_cols = 5 if srt.ret is None else 6
    buf = torch.empty((n_cols * N + -(-N // _kb["tile"]) + 2,),
                      dtype=torch.int64, device=dev)
    cols = [buf[i * N:(i + 1) * N] for i in range(n_cols)]
    out = Run(*cols[:5], torch.empty((N,), dtype=torch.uint8, device=dev),
              cols[5] if srt.ret is not None else None)
    if N == 0:
        return out

    def p(t):
        return None if t is None else t.data_ptr()

    kernels.KB.launch("kb_launch", N, *(p(f) for f in srt),
                      *(p(f) for f in out), buf[n_cols * N:].data_ptr(),
                      _kb["count"].data_ptr())
    torch.cuda.current_stream(dev).synchronize()
    C = int(_kb["count"][0])
    return Run(*(None if f is None else f[:C] for f in out))


def _gather(r: Run, perm) -> Run:
    return Run(*(None if f is None else f[perm] for f in r))


class Rows(NamedTuple):
    """One k-mer slot a row, in arrival order (KA's output, flattened)."""

    shard: torch.Tensor    # int64 [N], INVALID_SHARD where no k-mer ends
    keybody: torch.Tensor  # int64 [N]
    arrp: torch.Tensor     # int64 [N] arrival << 1 | is_high
    ret: Optional[torch.Tensor]  # int64 [N], when carried


def chunk_rows(bases, qual_ok, lens, arrival_base: int, k: int, l_pre: int,
               carry_ret: bool) -> Rows:
    """One padded read batch -> its k-mer rows (kernel KA)."""
    shard, keybody, arrp, ret = kops.kmer_stream(
        bases, qual_ok, lens, k, l_pre, arrival_base, with_ret=carry_ret)
    return Rows(shard.view(-1), keybody.view(-1), arrp.view(-1),
                None if ret is None else ret.view(-1))


def rows_run(rows: Rows) -> Run:
    """Rows in arrival order -> a sorted, combined, compacted run (the
    stable sort and KB).  Rows with INVALID_SHARD sort last and drop."""
    perm = stable_order(rows.shard, rows.keybody)
    arrp = rows.arrp[perm]
    high = arrp & 1
    srt = Run(rows.shard[perm], rows.keybody[perm], arrp >> 1,
              torch.ones_like(high), high, high.to(torch.uint8),
              None if rows.ret is None else rows.ret[perm])
    return run_combine(srt)


def chunk_run(bases, qual_ok, lens, arrival_base: int, k: int, l_pre: int,
              carry_ret: bool) -> Run:
    """One padded read batch -> a sorted, combined, compacted run."""
    return rows_run(chunk_rows(bases, qual_ok, lens, arrival_base, k, l_pre,
                               carry_ret))


def merge_bytes(a: Run, b: Run) -> int:
    """Device bytes a merge holds at its peak: the concatenation, its sort
    permutations and gathered copy, and the combined output, which KB
    allocates for every row before it narrows it to the groups (its tile
    status words, 8 bytes a 2,048 rows, are not counted)."""
    rows = len(a) + len(b)
    per_row = 8 * (6 if a.ret is None else 7)
    return rows * (3 * per_row + 4 * 8)


def concat_sorted(a: Run, b: Run) -> Run:
    """[a, b] sorted by key, stable: the input of a merge's combine."""
    cat = Run(*(None if fa is None else torch.cat([fa, fb])
                for fa, fb in zip(a, b)))
    return _gather(cat, stable_order(cat.shard, cat.keybody))


def merge_runs(a: Run, b: Run) -> Run:
    """Merge two runs; a must cover the earlier stream span."""
    return run_combine(concat_sorted(a, b))


class Packed(NamedTuple):
    """A run as it crosses to the host (KE): identity and ret pass through,
    the payload folds into two 32-bit planes (u32 bit patterns in int32)."""

    shard: torch.Tensor     # int64 [C]
    keybody: torch.Tensor   # int64 [C]
    a_lo: torch.Tensor      # int32 [C] low 32 bits of the arrival
    nfh: torch.Tensor       # int32 [C] see pack_pull
    ret: Optional[torch.Tensor]  # int64 [C], when carried


PACK_ARRIVAL_LIMIT = 1 << 47  # arr_hi rides in the top 15 bits of nfh


def as_i32(x):
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def pack_pull_plain(run: Run) -> Packed:
    """Plain version of KE."""
    nfh = (run.n.clamp(max=511) | (run.n_high.clamp(max=127) << 9)
           | (run.first_high.to(torch.int64) << 16) | ((run.arr >> 32) << 17))
    return Packed(run.shard, run.keybody, as_i32(run.arr & 0xFFFFFFFF),
                  as_i32(nfh), run.ret)


def pack_pull(run: Run) -> Packed:
    """Pack a run for the pull to the host (kernel KE): a_lo is the low 32
    bits of the first arrival, nfh = min(n, 511) | min(n_high, 127) << 9 |
    first_high << 16 | arrival >> 32 << 17.  Arrivals must be below 2^47
    (the caller checks).  The saturation points lie above every payload
    cap, so the finalized spectrum does not change."""
    C = len(run)
    dev = run.shard.device
    for name in ("arr", "n", "n_high"):
        kernels.check(getattr(run, name), name, torch.int64, (C,), dev)
    kernels.check(run.first_high, "first_high", torch.uint8, (C,), dev)
    if dev.type == "cpu":
        return pack_pull_plain(run)
    a_lo = torch.empty((C,), dtype=torch.int32, device=dev)
    nfh = torch.empty((C,), dtype=torch.int32, device=dev)
    kernels.KE.launch("ke_launch", C, run.arr.data_ptr(), run.n.data_ptr(),
                      run.n_high.data_ptr(), run.first_high.data_ptr(),
                      a_lo.data_ptr(), nfh.data_ptr())
    return Packed(run.shard, run.keybody, a_lo, nfh, run.ret)


def _host_ret(shard, keybody, ret, k: int, l_pre: int, derive: bool):
    if ret is None:
        return derive_ret_np(shard, keybody, k, l_pre) if derive else None
    return ret.view(np.uint64)


def packed_run_to_host_agg(shard: np.ndarray, keybody: np.ndarray,
                           a_lo: np.ndarray, nfh: np.ndarray, ret, k: int,
                           l_pre: int, with_ret: bool = True):
    """Host twin of KE: pulled Packed columns -> HostAgg, with n and n_high
    saturated at 511 and 127 (spectrum_dense.py:packed_run_to_host_agg,
    :258); ret is derived from the identity where it was not carried,
    unless with_ret is False (a spilled span: ret stays None)."""
    from .spectrum_host import HostAgg

    shard = shard.astype(np.uint32)
    keybody = keybody.view(np.uint64)
    nfh = nfh.view(np.uint32)
    arr_hi = (nfh >> np.uint32(17)).astype(np.uint64) << np.uint64(32)
    return HostAgg(
        shard=shard, keybody=keybody,
        ret=_host_ret(shard, keybody, ret, k, l_pre, with_ret),
        n=nfh & np.uint32(511),
        n_high=(nfh >> np.uint32(9)) & np.uint32(127),
        first_arr=arr_hi | a_lo.view(np.uint32),
        first_high=(nfh >> np.uint32(16)) & np.uint32(1),
    )


def run_to_host_agg(shard, keybody, arr, n, n_high, first_high, ret, k: int,
                    l_pre: int, with_ret: bool = True):
    """Pulled unpacked Run columns -> HostAgg (counts clamped to u32; ret
    as packed_run_to_host_agg gives it)."""
    from .spectrum_host import HostAgg

    shard = shard.astype(np.uint32)
    keybody = keybody.view(np.uint64)
    return HostAgg(
        shard=shard, keybody=keybody,
        ret=_host_ret(shard, keybody, ret, k, l_pre, with_ret),
        n=np.minimum(n, 0xFFFFFFFF).astype(np.uint32),
        n_high=np.minimum(n_high, 0xFFFFFFFF).astype(np.uint32),
        first_arr=arr.view(np.uint64),
        first_high=first_high.astype(np.uint32),
    )


def derive_ret_plain(shard, keybody, k: int, l_pre: int):
    """Plain version of KJ (derive_ret_np on int64 bit patterns)."""
    mask = (1 << k) - 1
    if k <= 32:
        z = (shard << (2 * k - l_pre)) | keybody
        h0 = kops.srl(z, k)
        h1 = z & mask
    else:
        h0 = (shard << (k - l_pre)) | (keybody >> k)
        h1 = keybody & mask
    w0 = (h0 - h1) & mask
    return ((w0 ^ h1) << k) | h0


def derive_ret(shard, keybody, k: int, l_pre: int):
    """The Bloom-addressing hash of rows whose run does not carry it (kernel
    KJ; spectrum_dense.py:derive_ret_device, :293): int64 [C] from the
    int64 identity columns.  Only where ret_derivable(k, l_pre)."""
    C = shard.shape[0]
    dev = shard.device
    kernels.check(shard, "shard", torch.int64, (C,), dev)
    kernels.check(keybody, "keybody", torch.int64, (C,), dev)
    if not ret_derivable(k, l_pre):
        raise ValueError(f"ret is not derivable at k {k}, l_pre {l_pre}")
    if dev.type == "cpu":
        return derive_ret_plain(shard, keybody, k, l_pre)
    ret = torch.empty((C,), dtype=torch.int64, device=dev)
    kernels.KJ.launch("kj_launch", C, shard.data_ptr(), keybody.data_ptr(),
                      k, l_pre, ret.data_ptr())
    return ret


def run_to_aggregate(run: Run, k: int, l_pre: int) -> Run:
    """The folded run as the device finalize takes it, with ret filled in
    (KJ) where the run does not carry it (spectrum_dense.py:
    run_to_aggregate, :312).  The run stays on its device."""
    if run.ret is not None:
        return run
    # Run's own __len__ (rows) stops NamedTuple._replace from working
    return Run(run.shard, run.keybody, run.arr, run.n, run.n_high,
               run.first_high, derive_ret(run.shard, run.keybody, k, l_pre))


def empty_run(device) -> Run:
    z = torch.zeros((0,), dtype=torch.int64, device=device)
    return Run(z, z, z, z, z, torch.zeros((0,), dtype=torch.uint8,
                                          device=device), z)


def derive_ret_np(shard: np.ndarray, keybody: np.ndarray, k: int,
                  l_pre: int) -> np.ndarray:
    """Recompute the Bloom-addressing hash from the table identity.

    Inverts shard_and_keybody back to (h0, h1), then re-applies the ret
    formula of canonical_hash (kmer.h:79-88)."""
    mask = np.uint64((1 << k) - 1)
    shard = shard.astype(np.uint64)
    if k <= 32:
        t = 2 * k - l_pre
        z = (shard << np.uint64(t)) | keybody
        h0 = z >> np.uint64(k)
        h1 = z & mask
    else:
        t = k - l_pre
        shift = k  # derivable only when t + k < 50, where shift == k
        assert ret_derivable(k, l_pre)
        h0_low = keybody >> np.uint64(shift)
        h0 = (shard << np.uint64(t)) | h0_low
        h1 = keybody & np.uint64((1 << shift) - 1)
    w0 = (h0 - h1) & mask
    return ((w0 ^ h1) << np.uint64(k)) | h0
