"""Rows to ranks for the mesh exchanges (kernel KM).

route_rows partitions rows by destination rank, stably, straight into the
send buffers of an all_to_all: destination d's rows are the slice
[sum(counts[:d]), sum(counts[:d + 1])) of every output column, in input
order.  It replaces bfc_tpu's bucketize into fixed [n_dev, cap] buffers
(parallel/mesh.py:120-144 and :214-237, ops/spectrum.py:396-417); with
uneven splits no row can overflow a bucket.

Two destination rules, each the plain twin of a function of
csrc/route_rows.cuh: PREFIX, the owner of a table shard
(mesh.py:_dev_of_shard, :87-90), and BLOOM, the owner of a Bloom block.
Rows whose shard is INVALID_SHARD are dropped under either rule.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from .. import kernels
from .kmer import INVALID_SHARD
from .spectrum import BLK_SHIFT

PREFIX, BLOOM = 0, 1    # csrc/route_rows.cuh:KM_RULE_*
MAX_RANKS = 256         # KM_MAX_RANKS
MAX_COLS = 4            # KM_COLS
TILE = 4096             # KM_TILE


class Routed(NamedTuple):
    cols: List[Optional[torch.Tensor]]  # int64 [sum(counts)] send buffers
    counts: List[int]                   # rows for each destination rank
    perm: torch.Tensor                  # int64: the source row of each slot


def log2_floor(R: int) -> int:
    """int(np.log2(R)) for R >= 1."""
    return R.bit_length() - 1


def dev_of_shard(shard, l_pre: int, R: int):
    """Owning rank of each valid int64 shard: the top log2(R) bits of the
    l_pre-bit prefix, as int32, floor-mod R (mesh.py:_dev_of_shard)."""
    shift = max(l_pre - log2_floor(R), 0)
    v = (shard >> shift) & 0xFFFFFFFF if shift < 32 else torch.zeros_like(shard)
    v = torch.where(v >= 1 << 31, v - (1 << 32), v)
    return torch.remainder(v, R)


def dev_of_block(ret, bf_shift: int, R: int):
    """Owning rank of each row's Bloom block: block % R."""
    return (ret & ((1 << (bf_shift - BLK_SHIFT)) - 1)) % R


def destinations(rule: int, param: int, R: int, shard=None, ret=None):
    """Destination rank of every row (R where the row is dropped)."""
    if rule == PREFIX:
        dest = dev_of_shard(shard, param, R)
    else:
        dest = dev_of_block(ret, param, R)
    if shard is not None:
        dest = torch.where(shard == INVALID_SHARD, R, dest)
    return dest


def route_rows_plain(cols: Sequence, R: int, rule: int, param: int,
                     shard=None, ret=None) -> Routed:
    """Plain version of KM: a stable sort by destination, bincount and
    index_select."""
    dest = destinations(rule, param, R, shard, ret)
    order = torch.sort(dest, stable=True).indices
    counts = torch.bincount(dest, minlength=R + 1)[:R].tolist()
    perm = order[:sum(counts)]
    return Routed([None if c is None else c.index_select(0, perm)
                   for c in cols], counts, perm)


_km = {}  # a card's KM state: pinned counts and an event


def _state(dev):
    """(pinned counts, event) of dev, made at its first call: the counts
    MAX_RANKS int64 of pinned host memory that the count pass copies its
    totals to, the event recorded behind it."""
    st = _km.get(dev)
    if st is None:
        st = _km[dev] = (
            torch.empty((MAX_RANKS,), dtype=torch.int64, pin_memory=True),
            torch.cuda.Event())
    return st


def buffer(N: int, R: int, n_cols: int, dev) -> torch.Tensor:
    """One call's int64 device memory: n_cols output columns and perm of N
    rows each, then the R x tiles counts (then first slots) and R
    totals."""
    n_tiles = (N + TILE - 1) // TILE
    return torch.empty(((n_cols + 1) * N + R * n_tiles + R,),
                       dtype=torch.int64, device=dev)


def enqueue(cols: Sequence, R: int, rule: int, param: int, shard, ret, buf,
            event=None):
    """Enqueue KM on the current stream, with no wait: the count pass, the
    scan pass (and the copy of the R totals to the pinned counts of
    _state), then `event` where given, then the scatter into buf (from
    buffer(), N >= 1 rows): its present columns, then perm, N rows each,
    of which the leading sum(counts) are written."""
    key = shard if rule == PREFIX else ret
    N = key.shape[0]
    n_tiles = (N + TILE - 1) // TILE
    pinned, _ = _state(key.device)

    def p(t):
        return None if t is None else t.data_ptr()

    # buf's parts by address: the outputs, perm, off, totals
    at = buf.data_ptr()
    outs = []
    for c in cols:
        outs.append(None if c is None else at)
        at += 0 if c is None else 8 * N
    perm, off = at, at + 8 * N
    totals = off + 8 * R * n_tiles
    kernels.KM.launch("km_count_launch", N, rule, p(shard), p(ret), param, R,
                      n_tiles, off, totals)
    kernels.KM.launch("km_scan_launch", R, n_tiles, off, totals, p(pinned))
    if event is not None:
        event.record()
    pad = [None] * (MAX_COLS - len(cols))
    kernels.KM.launch("km_scatter_launch", N, rule, p(shard), p(ret), param,
                      R, n_tiles, off, *(p(c) for c in cols), *pad, *outs,
                      *pad, perm)


def route_rows(cols: Sequence, R: int, rule: int, param: int, shard=None,
               ret=None) -> Routed:
    """Stable partition of rows by destination rank (kernel KM).

    cols: up to four int64 [N] columns to route (None passes through).
    rule PREFIX takes shard (int64 [N]) and param l_pre; rule BLOOM takes
    ret (int64 [N], u64 bit patterns) and param bf_shift, and shard where
    invalid rows must be dropped.  R ranks, 1..256.  Returns the send
    buffers, the per-destination counts (a host list) and perm, the source
    row of each sent row.  On the card the call waits once, on an event
    behind the count and scan passes, with the scatter already enqueued;
    the buffers are the leading rows of outputs allocated for all N rows."""
    key = shard if rule == PREFIX else ret
    if key is None:
        raise ValueError("the PREFIX rule needs shard, the BLOOM rule ret")
    N = key.shape[0]
    dev = key.device
    if not 1 <= R <= MAX_RANKS:
        raise ValueError(f"{R} ranks: KM routes to 1..{MAX_RANKS}")
    if len(cols) > MAX_COLS:
        raise ValueError(f"{len(cols)} columns: KM routes at most {MAX_COLS}")
    for name, t in [("shard", shard), ("ret", ret)] + [
            (f"cols[{j}]", c) for j, c in enumerate(cols)]:
        if t is not None:
            kernels.check(t, name, torch.int64, (N,), dev)
    if dev.type == "cpu":
        return route_rows_plain(cols, R, rule, param, shard, ret)
    return _route(cols, R, rule, param, shard, ret)


def _route(cols, R: int, rule: int, param: int, shard, ret) -> Routed:
    """route_rows on checked card tensors: KM enqueued, one wait."""
    key = shard if rule == PREFIX else ret
    N, dev = key.shape[0], key.device
    if N == 0:
        empty = torch.empty((0,), dtype=torch.int64, device=dev)
        return Routed([None if c is None else empty for c in cols], [0] * R,
                      empty)
    pinned, event = _state(dev)
    n_cols = sum(c is not None for c in cols)
    buf = buffer(N, R, n_cols, dev)
    enqueue(cols, R, rule, param, shard, ret, buf, event)
    event.synchronize()
    counts = pinned[:R].tolist()
    n = sum(counts)
    outs, a = [], 0
    for c in cols:
        outs.append(None if c is None else buf[a:a + n])
        a += 0 if c is None else N
    return Routed(outs, counts, buf[a:a + n])
