"""The collectives of the mesh path, over torch.distributed.

Device columns go through the default group: with NCCL they stay on the
card; with gloo (the CPU, or ranks sharing cards) they are staged through
host memory, since gloo has no CUDA all_to_all.  Host bytes and small
control tensors (split sizes, histograms, lengths) go through a gloo side
group.  The backend is the caller's choice, made once at
init_process_group; nothing here changes it.

Every function that moves data is a collective: each rank calls it, in
the same order, and from its main thread (the counting tree's workers,
ops/lsm.py, call none of them).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_side = (None, None)  # (the default group it was made for, the side group)


def active() -> bool:
    """Whether this process is a rank of an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def size() -> int:
    return dist.get_world_size() if active() else 1


def backend() -> str:
    return str(dist.get_backend())


def ranks_sharing(dev: torch.device) -> int:
    """The ranks of this host that run on the card dev, this one included
    (1 outside a process group or off the cards).  The launcher and
    torchrun put local rank r on cuda:(r % device_count)
    (multihost.device_for), so card d holds local ranks d, d + n, ...
    of LOCAL_WORLD_SIZE.  Not a collective."""
    if not active() or dev.type != "cuda":
        return 1
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(size())))
    n = torch.cuda.device_count()
    d = torch.cuda.current_device() if dev.index is None else dev.index
    return max(1, len(range(d, local_world, n)))


def side_group():
    """The gloo group for host tensors: the default group when it is gloo,
    else one made at the first use under this default group (a
    collective, as every call here is)."""
    global _side
    if backend() == "gloo":
        return None
    if _side[0] is not dist.group.WORLD:
        _side = (dist.group.WORLD, dist.new_group(backend="gloo"))
    return _side[1]


def _staged(t: torch.Tensor) -> bool:
    return t.is_cuda and backend() == "gloo"


def all_to_all_rows(cols: Sequence[Optional[torch.Tensor]],
                    counts: Sequence[int],
                    recv_counts: Optional[Sequence[int]] = None):
    """Send rows [sum(counts[:d]), sum(counts[:d + 1])) of every column to
    rank d; returns (received columns, received counts).  A rank's
    received rows are the senders' slices in rank order.  recv_counts,
    where the caller knows them (the way back of an exchange), saves the
    exchange of the counts."""
    if recv_counts is None:
        send = torch.tensor(list(counts), dtype=torch.int64)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=side_group())
        recv_counts = recv.tolist()
    out = []
    for c in cols:
        if c is None:
            out.append(None)
            continue
        src = c.cpu() if _staged(c) else c
        dst = torch.empty((sum(recv_counts),) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.all_to_all_single(dst, src, list(recv_counts), list(counts))
        out.append(dst.to(c.device) if _staged(c) else dst)
    return out, list(recv_counts)


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A small tensor reduced over the ranks by op (the sum unless told
    otherwise, e.g. dist.ReduceOp.MIN), on the host."""
    h = t.detach().cpu().clone()
    dist.all_reduce(h, op=op, group=side_group())
    return h


def barrier() -> None:
    """Wait until every rank has come here (over the side group)."""
    dist.barrier(group=side_group())


def lengths(n: int) -> List[int]:
    """Every rank's n, in rank order."""
    t = torch.tensor([n], dtype=torch.int64)
    out = [torch.empty_like(t) for _ in range(size())]
    dist.all_gather(out, t, group=side_group())
    return [int(x) for x in out]


def _gather_padded(t: torch.Tensor, lens: List[int], group):
    """Every rank's 1-D t (lens[r] rows on rank r), padded to the longest
    for all_gather and trimmed again, in rank order."""
    pad = torch.zeros((max(max(lens), 1),), dtype=t.dtype, device=t.device)
    pad[:t.shape[0]] = t
    parts = [torch.empty_like(pad) for _ in range(size())]
    dist.all_gather(parts, pad, group=group)
    return [p[:ln] for p, ln in zip(parts, lens)]


def all_gather_bytes(b: np.ndarray) -> List[np.ndarray]:
    """Every rank's uint8 array, in rank order, on every rank."""
    t = torch.from_numpy(np.array(b, np.uint8))
    return [p.numpy() for p in _gather_padded(t, lengths(len(b)),
                                              side_group())]


def all_gather_rows(cols: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every rank's rows of each 1-D column, concatenated in rank order,
    on every rank."""
    lens = lengths(cols[0].shape[0])
    out = []
    for c in cols:
        src = c.cpu() if _staged(c) else c
        cat = torch.cat(_gather_padded(src, lens, None))
        out.append(cat.to(c.device) if _staged(c) else cat)
    return out


def gather_rows(cols: Sequence[torch.Tensor]) -> Optional[List[torch.Tensor]]:
    """Every rank's rows of each 1-D column, concatenated in rank order,
    on the host of rank 0 alone (None on the other ranks)."""
    lens = lengths(cols[0].shape[0])
    out = []
    for c in cols:
        h = c.detach().cpu()
        pad = torch.zeros((max(max(lens), 1),), dtype=h.dtype)
        pad[:h.shape[0]] = h
        parts = ([torch.empty_like(pad) for _ in range(size())]
                 if rank() == 0 else None)
        dist.gather(pad, parts, dst=0, group=side_group())
        if rank() == 0:
            out.append(torch.cat([p[:n] for p, n in zip(parts, lens)]))
    return out if rank() == 0 else None


def broadcast_rows(cols: Optional[Sequence[torch.Tensor]],
                   dtypes: Sequence[torch.dtype]) -> List[torch.Tensor]:
    """Rank 0's 1-D host columns of equal length (cols, read on rank 0
    alone; the others pass None) on every rank, one column at a time,
    with the given dtypes."""
    n = torch.tensor([cols[0].shape[0] if rank() == 0 else 0])
    dist.broadcast(n, src=0, group=side_group())
    out = []
    for i, dt in enumerate(dtypes):
        t = (cols[i].detach().cpu().contiguous() if rank() == 0
             else torch.empty((int(n),), dtype=dt))
        if int(n):
            dist.broadcast(t, src=0, group=side_group())
        out.append(t)
    return out


def gather_segments(seg: bytes) -> List[bytes]:
    """All-to-rank-0 exchange of per-rank formatted byte segments
    (bfc_tpu/parallel/multihost.py:gather_segments, :167-191).  Returns the
    segments in rank order on rank 0 and [] elsewhere."""
    if size() == 1:
        return [seg]
    parts = all_gather_bytes(np.frombuffer(seg, np.uint8))
    if rank() != 0:
        return []
    return [p.tobytes() for p in parts]
