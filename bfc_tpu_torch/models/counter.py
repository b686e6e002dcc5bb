"""The counting pass on the card and the finalized spectrum.

Counterpart of bfc_tpu/models/counter.py: read batches stream through
kernel KA, the sort and kernel KB into sorted runs; runs fold into a
binary-counter merge tree that stays on the card.  By default finish
pulls the aggregate to the host once (KE), where the Bloom
first-occurrence adjudication and the cuckoo table build run
(spectrum_host, numpy and C), and the table goes back to the card as one
int64 tensor.  With the device finalize (BFC_TPU_DEVICE_FINALIZE=1, or
device_finalize=True) the folded run stays on the card and KJ, KF or KI,
KK and KL finalize it there.  Reproduces the reference counting pass
(count.c:127-157) under sequential stream order (bfc -t1).
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import kernels
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
    """Finalized spectrum: the cuckoo table on the device plus metadata.

    compact is the host copy of the kept (shard, keybody, payload) entries,
    sorted, or a function that pulls it from the card at first use."""

    def __init__(self, table: spec.SpecTable, n_entries: int,
                 hist: np.ndarray, hist_high: np.ndarray, compact,
                 verdict: str = "host"):
        self.table = table
        self.k = table.k
        self.l_pre = table.l_pre
        self.kb_bits = table.kb_bits
        self.c_bits = table.c_bits
        self.n_entries = n_entries
        self.hist = hist
        self.hist_high = hist_high
        self.mode = _mode_from_hist(hist)
        self._compact = compact
        self.verdict = verdict  # which first-occurrence verdict ran
        # the counting pass that built it (count_file_device), else 0
        self.n_reads = 0
        self.n_aggregated = 0

    def compact_entries(self):
        if callable(self._compact):
            self._compact = self._compact()
        return self._compact


def device_finalize_on(device_finalize: Optional[bool] = None) -> bool:
    """The finalize mode: the argument, else BFC_TPU_DEVICE_FINALIZE=1."""
    if device_finalize is None:
        return os.environ.get("BFC_TPU_DEVICE_FINALIZE", "0") == "1"
    return bool(device_finalize)


def table_c_bits(n: int, k: int, l_pre: int, c_bits_hint: int = 0) -> int:
    """c_bits of the cuckoo table of n entries, in both finalize modes.

    It follows bfc_tpu's _spectrum_from_sorted (load <= 0.4, the
    genome-size hint), raised so that qlow, the l_pre + kb_bits identity
    bits the slot does not give, fits the entry's 49 bits for every k up
    to 63.  A bigger table never changes a lookup."""
    kb_bits = kops.keybody_bits(k, l_pre)
    return max(8, int(np.ceil(np.log2(max(n, 1) * 2.5 + 1))), c_bits_hint,
               l_pre + kb_bits - 49)


def spectrum_from_compact(shard: np.ndarray, keybody: np.ndarray,
                          payload: np.ndarray, k: int, l_pre: int,
                          device, c_bits_hint: int = 0,
                          verdict: str = "host") -> DeviceSpectrum:
    """Cuckoo table from compact (shard, keybody, payload) entries, built
    on the host; c_bits by table_c_bits, and a failed placement retries
    one bit larger."""
    shard = np.asarray(shard, np.uint32)
    keybody = np.asarray(keybody, np.uint64)
    payload = np.asarray(payload, np.uint32)
    n = len(shard)
    kb_bits = kops.keybody_bits(k, l_pre)
    c_bits = table_c_bits(n, k, l_pre, c_bits_hint)
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
                          n, hist, hist_high, (shard, keybody, payload),
                          verdict)


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
            free = kernels.device_free_bytes(self.device)
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

    def pull(self, run: sdn.Run) -> sph.HostAgg:
        """The run on the host: packed by KE while arrivals stay below
        2^47 (bfc_tpu's _run_to_host, counter.py:501), unpacked above.
        Logs the transfer (pack included) and the host unpack apart."""
        t0 = time.time()
        if self.arrival_base < sdn.PACK_ARRIVAL_LIMIT:
            host = pull_columns(sdn.pack_pull(run))
            t1 = time.time()
            ha = sdn.packed_run_to_host_agg(*host, self.k, self.l_pre)
        else:
            host = pull_columns(run)
            t1 = time.time()
            ha = sdn.run_to_host_agg(*host, self.k, self.l_pre)
        log(f"pull {t1 - t0:.1f}s, host aggregate {time.time() - t1:.1f}s",
            func="AggBuilder")
        return ha

    def finish(self, device_finalize: Optional[bool] = None):
        """Fold the tree.  For the device finalize (device_finalize_on)
        return the folded Run as it lies on the card, as bfc_tpu skips its
        pull and sketch there (counter.py:601-610); else pull the
        aggregate and attach the Bloom sketch: a HostAgg."""
        acc = self.fold()
        if acc is not None:
            log(f"{len(acc)} distinct k-mers aggregated", func="AggBuilder")
        if device_finalize_on(device_finalize):
            return sdn.empty_run(self.device) if acc is None else acc
        if acc is None:
            return sph.empty_host_agg()
        ha = self.pull(acc)
        t0 = time.time()
        sketch = sph.BloomMinSketch.create(self.opt.bf_shift, self.opt.n_hashes)
        if sketch is not None:
            sketch.scatter(ha.ret, ha.first_arr)
            if sketch.valid:
                ha = ha._replace(bloom_min=sketch)
            log(f"Bloom sketch {time.time() - t0:.1f}s", func="AggBuilder")
        return ha


def pull_columns(cols):
    """Device columns (None passes through) -> numpy arrays on the host."""
    return [None if f is None else f.cpu().numpy() for f in cols]


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
                            batch_reads: int = 8192,
                            device_finalize: Optional[bool] = None):
    """Aggregate a FASTQ file via the native batched reader (hot path):
    (AggBuilder.finish's aggregate, number of reads)."""
    agg_tree = AggBuilder(opt, device)
    n_reads = 0
    for bases, qok, lens, n in padded_batches(fn, opt, batch_reads):
        agg_tree.add(bases, qok, lens)
        n_reads += n
    return agg_tree.finish(device_finalize), n_reads


def usable_sketch(agg, opt: Opts):
    """The Bloom sketch riding a HostAgg if it holds this Bloom's verdicts
    (bf_shift, n_hashes), else None."""
    sketch = getattr(agg, "bloom_min", None)
    if (sketch is not None and sketch.valid and sketch.bf_shift == opt.bf_shift
            and sketch.n_hashes == opt.n_hashes):
        return sketch
    return None


def host_agg_to_run(agg: sph.HostAgg, device) -> sdn.Run:
    """A host aggregate as a Run on device (its ret kept where present)."""
    def col(x, view=None):
        x = np.asarray(x)
        x = x.view(np.int64) if view else x.astype(np.int64)
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return sdn.Run(col(agg.shard), col(agg.keybody, True),
                   col(agg.first_arr, True), col(agg.n), col(agg.n_high),
                   col(agg.first_high).to(torch.uint8),
                   None if agg.ret is None else col(agg.ret, True))


def finalize_on_device(run: sdn.Run, opt: Opts, device) -> DeviceSpectrum:
    """The device finalize of a folded run (bfc_tpu's finalize_spectrum
    with host=False, counter.py:745-819): KJ where ret is not carried,
    the verdict (KF, or KI past 2^32 arrivals), KK, the kept rows
    compacted, and KL, retried one bit larger on a failed placement.  The
    host copy of the entries is pulled at first use."""
    t0 = time.time()
    k, l_pre = opt.k, opt.effective_l_pre()
    kb_bits = kops.keybody_bits(k, l_pre)
    run = sdn.run_to_aggregate(run, k, l_pre)
    fp, _, verdict = spec.adjudicate(run.ret, run.arr, run.n, opt.bf_shift,
                                     opt.n_hashes)
    payload, keep, hist, hist_high = spec.finalize_counts(
        run.n, run.n_high, run.first_high, fp)
    idx = torch.nonzero(keep).flatten()
    shard, keybody, payload = run.shard[idx], run.keybody[idx], payload[idx]
    n = idx.shape[0]
    t1 = time.time()
    c_bits = table_c_bits(n, k, l_pre, opt.predicted_c_bits())
    while True:
        table, ok = spec.cuckoo_build(shard, keybody, payload, k, l_pre,
                                      kb_bits, c_bits)
        if ok:
            break
        log(f"cuckoo placement failed at c_bits {c_bits}; retrying larger")
        c_bits += 1

    def pull():
        return (shard.cpu().numpy().astype(np.uint32),
                keybody.cpu().numpy().view(np.uint64),
                payload.cpu().numpy().view(np.uint32))

    ds = DeviceSpectrum(spec.SpecTable(table, k, l_pre, kb_bits, c_bits), n,
                        hist.cpu().numpy(), hist_high.cpu().numpy(), pull,
                        verdict)
    log(f"# distinct k-mers in table: {n} (device finalize: {verdict} "
        f"verdict and payloads {t1 - t0:.1f}s, table "
        f"{time.time() - t1:.1f}s, c_bits {c_bits})")
    return ds


def finalize_spectrum(agg, opt: Opts, device,
                      host: Optional[bool] = None) -> DeviceSpectrum:
    """Adjudicate + payloads, then the cuckoo table on the card.

    agg is AggBuilder.finish's aggregate.  host=None finalizes a device
    Run on the card, and a HostAgg where BFC_TPU_DEVICE_FINALIZE says
    (the host by default), as bfc_tpu's finalize_spectrum (counter.py:
    707-725) chooses; host=False takes a HostAgg to the card first."""
    if host is None:
        host = not isinstance(agg, sdn.Run) and not device_finalize_on()
    if not host:
        if not isinstance(agg, sdn.Run):
            agg = host_agg_to_run(agg, device)
        return finalize_on_device(agg, opt, device)
    if isinstance(agg, sdn.Run):
        raise ValueError("the host finalize takes a HostAgg: pull the run "
                         "with AggBuilder.pull")
    t0 = time.time()
    k = opt.k
    l_pre = opt.effective_l_pre()
    shard_c, keybody_c, payload_c, _, _ = sph.finalize_host(
        agg, opt.bf_shift, opt.n_hashes, k=k, l_pre=l_pre)
    t1 = time.time()
    verdict = "host sketch" if usable_sketch(agg, opt) else "host sort"
    ds = spectrum_from_compact(shard_c, keybody_c, payload_c, k, l_pre,
                               device, c_bits_hint=opt.predicted_c_bits(),
                               verdict=verdict)
    log(f"# distinct k-mers in table: {len(shard_c)} "
        f"(adjudicate {t1 - t0:.1f}s, table {time.time() - t1:.1f}s, "
        f"c_bits {ds.c_bits})")
    return ds


def count_file_device(fn: str, opt: Opts, device, batch_reads: int = 8192,
                      device_finalize: Optional[bool] = None
                      ) -> DeviceSpectrum:
    """Counting pass over a FASTQ file (native batched reader), finalized
    on the host or, with device_finalize (default: device_finalize_on()),
    on the card."""
    on = device_finalize_on(device_finalize)
    agg, n_reads = count_batches_aggregate(fn, opt, device, batch_reads, on)
    log(f"processed {n_reads} sequences")
    ds = finalize_spectrum(agg, opt, device, host=not on)
    ds.n_reads, ds.n_aggregated = n_reads, len(agg.shard)
    return ds

