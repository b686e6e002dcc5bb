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
group heads, folds each group into its head and compacts the heads.
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


def run_combine(srt: Run) -> Run:
    """Combine equal keys of a sorted run into their head rows and compact
    (kernel KB: a head pass and a combine pass around torch.cumsum)."""
    N = len(srt)
    dev = srt.shard.device
    for name in ("shard", "keybody", "arr", "n", "n_high"):
        kernels.check(getattr(srt, name), name, torch.int64, (N,), dev)
    kernels.check(srt.first_high, "first_high", torch.uint8, (N,), dev)
    if srt.ret is not None:
        kernels.check(srt.ret, "ret", torch.int64, (N,), dev)
    if dev.type == "cpu":
        return run_combine_plain(srt)
    def p(t):
        return None if t is None else t.data_ptr()

    head = torch.empty((N,), dtype=torch.int32, device=dev)
    kernels.KB.launch("kb_head_launch", p(srt.shard), p(srt.keybody), N,
                      p(head))
    cum = torch.cumsum(head, 0, dtype=torch.int64)
    C = int(cum[-1]) if N else 0
    out = Run(*(torch.empty((C,), dtype=torch.int64, device=dev)
                for _ in range(5)),
              torch.empty((C,), dtype=torch.uint8, device=dev),
              None if srt.ret is None
              else torch.empty((C,), dtype=torch.int64, device=dev))
    kernels.KB.launch("kb_combine_launch", N, p(head), p(cum),
                      *(p(f) for f in srt), *(p(f) for f in out))
    return out


def _gather(r: Run, perm) -> Run:
    return Run(*(None if f is None else f[perm] for f in r))


def chunk_run(bases, qual_ok, lens, arrival_base: int, k: int, l_pre: int,
              carry_ret: bool) -> Run:
    """One padded read batch -> a sorted, combined, compacted run."""
    shard, keybody, arrp, ret = kops.kmer_stream(
        bases, qual_ok, lens, k, l_pre, arrival_base, with_ret=carry_ret)
    shard, keybody, arrp = shard.view(-1), keybody.view(-1), arrp.view(-1)
    perm = stable_order(shard, keybody)
    arrp = arrp[perm]
    high = arrp & 1
    srt = Run(shard[perm], keybody[perm], arrp >> 1, torch.ones_like(high),
              high, high.to(torch.uint8),
              None if ret is None else ret.view(-1)[perm])
    return run_combine(srt)


def merge_bytes(a: Run, b: Run) -> int:
    """Device bytes a merge holds at its peak: the concatenation, its sort
    permutations and gathered copy, and the combined output."""
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
