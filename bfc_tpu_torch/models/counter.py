"""The counting pass on the card and the finalized spectrum.

Counterpart of bfc_tpu/models/counter.py: read batches stream through
kernel KA, the sort and kernel KB into sorted runs; runs fold into a
binary-counter merge tree that stays on the card; finish pulls the aggregate to the
host once, where the Bloom first-occurrence adjudication and the cuckoo
table build run (spectrum_host, numpy and C), and the table goes back to
the card as one int64 tensor.  Reproduces the reference counting pass
(count.c:127-157) under sequential stream order (bfc -t1).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..opts import Opts
from ..ops import kmer as kops
from ..ops import spectrum as spec
from ..ops import spectrum_dense as sdn
from ..ops import spectrum_host as sph
from ..utils.log import log


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _mode_from_hist(hist: np.ndarray) -> int:
    best, mode = 0, -1
    for i in range(3, 256):
        if hist[i] > best:
            best, mode = int(hist[i]), i
    return mode


class DeviceSpectrum:
    """Finalized spectrum: the cuckoo table on the device plus metadata."""

    def __init__(self, table: spec.SpecTable, n_entries: int,
                 hist: np.ndarray, hist_high: np.ndarray,
                 compact: Tuple[np.ndarray, np.ndarray, np.ndarray]):
        self.table = table
        self.k = table.k
        self.l_pre = table.l_pre
        self.kb_bits = table.kb_bits
        self.c_bits = table.c_bits
        self.n_entries = n_entries
        self.hist = hist
        self.hist_high = hist_high
        self.mode = _mode_from_hist(hist)
        self._compact = compact  # host (shard, keybody, payload), sorted
        # the counting pass that built it (count_file_device), else 0
        self.n_reads = 0
        self.n_aggregated = 0

    def compact_entries(self):
        return self._compact


def spectrum_from_compact(shard: np.ndarray, keybody: np.ndarray,
                          payload: np.ndarray, k: int, l_pre: int,
                          device, c_bits_hint: int = 0) -> DeviceSpectrum:
    """Cuckoo table from compact (shard, keybody, payload) entries.

    c_bits follows bfc_tpu's _spectrum_from_sorted (load <= 0.4, the
    genome-size hint), raised so that qlow, the l_pre + kb_bits identity
    bits the slot does not give, fits the entry's 49 bits for every k up
    to 63; a failed placement retries one bit larger.  A bigger table
    never changes a lookup."""
    shard = np.asarray(shard, np.uint32)
    keybody = np.asarray(keybody, np.uint64)
    payload = np.asarray(payload, np.uint32)
    n = len(shard)
    kb_bits = kops.keybody_bits(k, l_pre)
    c_bits = max(8, int(np.ceil(np.log2(max(n, 1) * 2.5 + 1))), c_bits_hint,
                 l_pre + kb_bits - 49)
    while True:
        entries, ok = sph.build_cuckoo_table_host(
            shard, keybody, payload, c_bits, l_pre, kb_bits)
        if ok:
            break
        log(f"cuckoo placement failed at c_bits {c_bits}; retrying larger")
        c_bits += 1
    table = torch.from_numpy(entries.view(np.int64)).to(device)
    hist = np.bincount(np.minimum(payload & 0xFF, 255), minlength=256)[:256]
    hist[0] = 0
    hist_high = np.bincount((payload >> 8) & 0x3F, minlength=64)[:64]
    return DeviceSpectrum(spec.SpecTable(table, k, l_pre, kb_bits, c_bits),
                          n, hist, hist_high, (shard, keybody, payload))


class AggBuilder:
    """Incremental per-distinct-k-mer aggregation over padded batches.

    Binary-counter merge tree on the device: level i holds the run of
    2^i batches, so the total merge work is O(distinct * log batches).
    The aggregate crosses to the host once, in finish().  Arrival order
    across add() calls must be the stream order."""

    def __init__(self, opt: Opts, device):
        self.opt = opt
        self.device = torch.device(device)
        self.k = opt.k
        self.l_pre = opt.effective_l_pre()
        self.carry = not sdn.ret_derivable(self.k, self.l_pre)
        self.arrival_base = 0
        self.n_batches = 0
        self.tree: List[Tuple[int, sdn.Run]] = []  # (level, run), oldest first

    def add(self, bases: np.ndarray, qok: np.ndarray, lens: np.ndarray) -> None:
        B, L = bases.shape
        dev = self.device
        run = sdn.chunk_run(
            torch.from_numpy(bases).to(dev), torch.from_numpy(qok).to(dev),
            torch.from_numpy(lens).to(dev), self.arrival_base, self.k,
            self.l_pre, self.carry)
        self.arrival_base += B * L
        self.n_batches += 1
        level = 0
        while self.tree and self.tree[-1][0] == level:
            _, older = self.tree.pop()
            run = self._merge(older, run)
            level += 1
        self.tree.append((level, run))

    def _merge(self, a: sdn.Run, b: sdn.Run) -> sdn.Run:
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            free += (torch.cuda.memory_reserved(self.device)
                     - torch.cuda.memory_allocated(self.device))
            need = sdn.merge_bytes(a, b)
            if need > free:
                raise RuntimeError(
                    f"counting merge of {len(a)} + {len(b)} rows needs "
                    f"{need} device bytes, {free} free: the host spill path "
                    "is ROADMAP Queue 1 item 9")
        return sdn.merge_runs(a, b)

    def fold(self) -> Optional[sdn.Run]:
        """Merge the tree, newest first, into one run on the card."""
        acc: Optional[sdn.Run] = None
        while self.tree:
            _, older = self.tree.pop()
            acc = older if acc is None else self._merge(older, acc)
        return acc

    def finish(self) -> sph.HostAgg:
        """Fold the tree, pull the aggregate and attach the Bloom sketch."""
        acc = self.fold()
        if acc is None:
            return sph.empty_host_agg()
        log(f"{len(acc)} distinct k-mers aggregated", func="AggBuilder")
        t0 = time.time()
        host = [None if f is None else f.cpu().numpy() for f in acc]
        t1 = time.time()
        shard, keybody, arr, n, n_high, first_high, ret = host
        shard = shard.astype(np.uint32)
        keybody = keybody.view(np.uint64)
        if ret is None:
            ret = sdn.derive_ret_np(shard, keybody, self.k, self.l_pre)
        else:
            ret = ret.view(np.uint64)
        ha = sph.HostAgg(
            shard=shard, keybody=keybody, ret=ret,
            n=np.minimum(n, 0xFFFFFFFF).astype(np.uint32),
            n_high=np.minimum(n_high, 0xFFFFFFFF).astype(np.uint32),
            first_arr=arr.view(np.uint64),
            first_high=first_high.astype(np.uint32),
        )
        sketch = sph.BloomMinSketch.create(self.opt.bf_shift, self.opt.n_hashes)
        if sketch is not None:
            sketch.scatter(ha.ret, ha.first_arr)
            if sketch.valid:
                ha = ha._replace(bloom_min=sketch)
        log(f"pull {t1 - t0:.1f}s, host aggregate + Bloom sketch "
            f"{time.time() - t1:.1f}s", func="AggBuilder")
        return ha


def padded_batches(fn: str, opt: Opts, batch_reads: int):
    """The native reader's batches as AggBuilder.add takes them: (bases,
    qual_ok, lens, n), padded to batch_reads reads and the sticky L."""
    from ..io import fast_reader as FR

    pad_L = 0
    for rb in FR.iter_batches_prefetch(fn, batch_reads, max_bases=opt.chunk_size):
        n = rb.n
        lens0 = rb.lens
        pad_L = max(pad_L, _round_up(int(lens0.max()) if n else 1, 32))
        L = pad_L
        B = batch_reads
        Lc = min(L, rb.bases.shape[1])
        bases = np.full((B, L), 4, np.uint8)
        bases[:n, :Lc] = rb.bases[:, :Lc]
        lens = np.zeros((B,), np.int32)
        lens[:n] = lens0
        qok = np.zeros((B, L), bool)
        has_q = rb.has_qual()
        inb = np.arange(Lc)[None, :] < lens0[:, None]
        qok[:n, :Lc] = np.where(
            has_q[:, None],
            rb.quals[:, :Lc].astype(np.int32) - 33 >= opt.q,
            inb,
        )
        yield bases, qok, lens, n


def count_batches_aggregate(fn: str, opt: Opts, device,
                            batch_reads: int = 8192):
    """Aggregate a FASTQ file via the native batched reader (hot path)."""
    agg_tree = AggBuilder(opt, device)
    n_reads = 0
    for bases, qok, lens, n in padded_batches(fn, opt, batch_reads):
        agg_tree.add(bases, qok, lens)
        n_reads += n
    return agg_tree.finish(), n_reads


def finalize_spectrum(agg: sph.HostAgg, opt: Opts, device) -> DeviceSpectrum:
    """Adjudicate + payloads (host), then the cuckoo table (to the card)."""
    t0 = time.time()
    k = opt.k
    l_pre = opt.effective_l_pre()
    shard_c, keybody_c, payload_c, _, _ = sph.finalize_host(
        agg, opt.bf_shift, opt.n_hashes, k=k, l_pre=l_pre)
    t1 = time.time()
    ds = spectrum_from_compact(shard_c, keybody_c, payload_c, k, l_pre,
                               device, c_bits_hint=opt.predicted_c_bits())
    log(f"# distinct k-mers in table: {len(shard_c)} "
        f"(adjudicate {t1 - t0:.1f}s, table {time.time() - t1:.1f}s, "
        f"c_bits {ds.c_bits})")
    return ds


def count_file_device(fn: str, opt: Opts, device,
                      batch_reads: int = 8192) -> DeviceSpectrum:
    """Counting pass over a FASTQ file (native batched reader)."""
    agg, n_reads = count_batches_aggregate(fn, opt, device, batch_reads)
    log(f"processed {n_reads} sequences")
    ds = finalize_spectrum(agg, opt, device)
    ds.n_reads, ds.n_aggregated = n_reads, len(agg.shard)
    return ds

