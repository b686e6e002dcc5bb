"""One address space of R sub-tables: each rank's own, its peers' mapped.

The prefix-sharded table (ops/spectrum.py:ShardedTable) gives each rank
the cuckoo sub-table of its hash-prefix range.  bfc_tpu looked keys up
with a request/response all_to_all inside lockstep search rounds
(spectrum.py:sharded_cuckoo_lookup, :368).  KD runs one read a thread,
which cannot join a collective in the middle of its search, so here
every rank maps every sub-table and KC and KD read a key's owner's
sub-table directly: over NVLink between cards, from the same HBM where
ranks share one.

On the card each rank's sub-table has an allocation of its own
(kn_alloc, a cudaMalloc in KN's library: an IPC handle names the base of
an allocation, which a tensor of PyTorch's caching allocator need not
be).  share() exports its handle, all-gathers the 64-byte handles over
the gloo side group and opens the peers' with
cudaIpcMemLazyEnablePeerAccess.  A failed open raises.  release() is
the matching collective: a barrier, so no peer is still probing, the
mappings closed, a second barrier, and each rank frees its own.

On the CPU (gloo has no IPC) share() all-gathers the sub-tables instead:
the same function over the same R sub-tables.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import kernels
from ..ops import spectrum as spec
from . import comm


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


class DeviceBuffer:
    """n int64 entries of device memory: this rank's own (kn_alloc) or a
    peer's mapped into this process (kn_open).  tensor() views it."""

    def __init__(self, ptr: int, n: int, device: torch.device, opened: bool):
        self.ptr = ptr
        self.n = n
        self.device = device
        self.opened = opened

    @property
    def __cuda_array_interface__(self):
        return {"shape": (self.n,), "typestr": "<i8",
                "data": (self.ptr, False), "version": 3}

    def tensor(self) -> torch.Tensor:
        """A view, on the card the memory lies on; never a copy."""
        t = torch.as_tensor(self)
        if t.data_ptr() != self.ptr:
            raise RuntimeError("torch.as_tensor copied a device buffer")
        return t

    def release(self) -> None:
        """Unmap a peer's buffer, or free this rank's own."""
        if self.ptr:
            fn = "kn_close" if self.opened else "kn_free"
            _check(kernels.KN.call(fn, self.device.index, self.ptr), fn)
            self.ptr = 0


def _index(dev: torch.device) -> int:
    return torch.cuda.current_device() if dev.index is None else dev.index


def alloc(n: int, dev) -> DeviceBuffer:
    """An exportable, uninitialised buffer of n int64 entries on dev."""
    dev = torch.device("cuda", _index(torch.device(dev)))
    p = ctypes.c_void_p()
    _check(kernels.KN.call("kn_alloc", dev.index, 8 * n, ctypes.byref(p)),
           f"cudaMalloc of {8 * n} bytes")
    return DeviceBuffer(p.value, n, dev, opened=False)


def _export(buf: DeviceBuffer) -> bytes:
    size = ctypes.c_int()
    kernels.KN.call("kn_handle_bytes", ctypes.byref(size))
    h = ctypes.create_string_buffer(size.value)
    _check(kernels.KN.call("kn_export", buf.device.index, buf.ptr, h),
           "cudaIpcGetMemHandle")
    return h.raw


def _open(handle: bytes, n: int, dev: torch.device, owner: int
          ) -> DeviceBuffer:
    p = ctypes.c_void_p()
    h = ctypes.create_string_buffer(handle, len(handle))
    _check(kernels.KN.call("kn_open", dev.index, h, ctypes.byref(p)),
           f"cudaIpcOpenMemHandle of rank {owner}'s sub-table")
    return DeviceBuffer(p.value, n, dev, opened=True)


def share(own: torch.Tensor, k: int, l_pre: int, kb_bits: int,
          buf: Optional[DeviceBuffer] = None) -> spec.ShardedTable:
    """The ShardedTable of every rank's sub-table, a collective.  own is
    this rank's sub-table: on the card the view of buf, its exportable
    allocation."""
    R, r = comm.size(), comm.rank()
    db = R.bit_length() - 1
    if R != 1 << db:
        raise ValueError(f"a sharded table over {R} ranks: R must be a "
                         "power of two")
    n = own.shape[0]
    if own.device.type == "cpu":
        subs = comm.all_gather_rows([own])[0].split(n)
        return spec.sharded_table(subs, k, l_pre, kb_bits, db)
    if buf is None or buf.ptr != own.data_ptr():
        raise ValueError("a sub-table on the card must lie in its own "
                         "allocation (peer.alloc) to be shared")
    torch.cuda.synchronize(buf.device)  # built before any peer reads it
    handles = comm.all_gather_bytes(np.frombuffer(_export(buf), np.uint8))
    subs, bufs = [], [buf]
    try:
        for q, h in enumerate(handles):
            if q == r:
                subs.append(own)
                continue
            b = _open(h.tobytes(), n, buf.device, q)
            bufs.append(b)
            subs.append(b.tensor())
    except BaseException:
        for b in bufs[1:]:
            b.release()
        raise
    return spec.sharded_table(subs, k, l_pre, kb_bits, db,
                              buffers=tuple(bufs), device=buf.device)


def release(t: spec.ShardedTable) -> None:
    """Close the peers' mappings and free this rank's sub-table once no
    rank probes any more, a collective.  A table on the CPU, or held in
    one process without mappings, has nothing to release."""
    if not t.buffers:
        return
    torch.cuda.synchronize(t.buffers[0].device)
    comm.barrier()
    for b in t.buffers:
        if b.opened:
            b.release()
    comm.barrier()
    for b in t.buffers:
        b.release()
