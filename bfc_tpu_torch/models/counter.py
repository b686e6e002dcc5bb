"""The counting pass on the card and the finalized spectrum.

Counterpart of bfc_tpu/models/counter.py: read batches stream through
kernel KA, the sort and kernel KB into sorted runs; runs fold into a
binary-counter merge tree on the card (ops/lsm.py), which spills whole
stream spans to a host merge tree where a merge would not fit the card.
By default finish pulls the aggregate to the host once (KE), where the
Bloom first-occurrence adjudication and the cuckoo table build run
(spectrum_host, numpy and C), and the table goes back to the card as one
int64 tensor.  With the device finalize (BFC_TPU_DEVICE_FINALIZE=1, or
device_finalize=True) the folded run stays on the card and KJ, KF or KI,
KK and KL finalize it there; a spilled aggregate goes back to the card
for them.  Reproduces the reference counting pass (count.c:127-157)
under sequential stream order (bfc -t1).  A spectrum is dumped to and
restored from bfc's -d/-r file format (htab.c:129-176).
"""

from __future__ import annotations

import os
import struct
import time
from typing import Optional

import numpy as np
import torch

from .. import kernels
from ..opts import Opts
from ..ops import kmer as kops
from ..ops import spectrum as spec
from ..ops import spectrum_dense as sdn
from ..ops import spectrum_host as sph
from ..ops.lsm import LsmTree
from ..parallel import comm
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
        # a sharded table's entries on each rank (parallel/mesh.py)
        self.entries_by_rank = None
        # what the mesh's counting pass adds to run_device's report
        self.count_report = {}

    def compact_entries(self):
        if callable(self._compact):
            self._compact = self._compact()
        return self._compact

    def dump(self, fn: str) -> None:
        """Write the bfc -d dump of the entries (bfc_tpu's DeviceSpectrum.
        dump, counter.py:103-116)."""
        write_dump(fn, self.k, self.l_pre, *self.compact_entries())


def _kh_n_buckets(size: np.ndarray) -> np.ndarray:
    """khash's bucket count for each shard size (bfc_tpu's counter.py:
    _kh_n_buckets): the power of two >= int(size / 0.77 + 0.5) + 1, at
    least 4; 0 for an empty shard."""
    need = (size / 0.77 + 0.5).astype(np.int64) + 1
    n = np.full(size.shape, 4, np.int64)
    while bool((n < need).any()):
        n = np.where(n < need, n << 1, n)
    return np.where(size == 0, 0, n)


def write_dump(fn: str, k: int, l_pre: int, shard, keybody, payload) -> None:
    """The bfc -d binary format (htab.c:129-146): {k, l_pre}, then for each
    of the 2^l_pre shards {n_buckets, size} and its size u64 keys
    keybody << 14 | payload.  The entries are sorted by shard."""
    counts = np.bincount(np.asarray(shard, np.int64), minlength=1 << l_pre)
    head = (_kh_n_buckets(counts).astype(np.uint64)
            | (counts.astype(np.uint64) << np.uint64(32)))
    at = np.arange(1 << l_pre) + np.concatenate([[0], np.cumsum(counts)[:-1]])
    words = np.empty((len(counts) + len(shard),), np.uint64)
    is_key = np.ones(words.shape, bool)
    is_key[at] = False
    words[at] = head
    words[is_key] = ((np.asarray(keybody, np.uint64) << np.uint64(14))
                     | np.asarray(payload, np.uint64))
    with open(fn, "wb") as f:
        f.write(struct.pack("<II", k, l_pre))
        f.write(words.astype("<u8").tobytes())


def read_dump(fn: str):
    """A bfc -d dump (htab.c:151-176): (k, l_pre, shard u32, keybody u64,
    payload u32), sorted by (shard, keybody) as bfc_tpu's
    restore_spectrum (counter.py:192-208) sorts them."""
    with open(fn, "rb") as f:
        k, l_pre = struct.unpack("<II", f.read(8))
        words = np.frombuffer(f.read(), "<u8").astype(np.uint64)
    sizes = np.zeros((1 << l_pre,), np.int64)
    at = np.zeros((1 << l_pre,), np.int64)
    i = 0
    for s in range(1 << l_pre):
        at[s] = i
        sizes[s] = int(words[i]) >> 32
        i += 1 + int(sizes[s])
    if i != len(words):
        raise ValueError(f"{fn}: {len(words)} words, the headers span {i}")
    is_key = np.ones(words.shape, bool)
    is_key[at] = False
    keys = words[is_key]
    shard = np.repeat(np.arange(1 << l_pre, dtype=np.uint32), sizes)
    keybody = keys >> np.uint64(14)
    payload = (keys & np.uint64(0x3FFF)).astype(np.uint32)
    order = np.lexsort((keybody, shard))
    return k, l_pre, shard[order], keybody[order], payload[order]


def restore_spectrum(fn: str, device) -> DeviceSpectrum:
    """Load a bfc -r dump into a DeviceSpectrum (bfc_tpu's
    restore_spectrum), its table built as spectrum_from_compact builds
    it; its verdict reads "restored"."""
    k, l_pre, shard, keybody, payload = read_dump(fn)
    return spectrum_from_compact(shard, keybody, payload, k, l_pre, device,
                                 verdict="restored")


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


def subtable_bits(max_local: int, k: int, l_pre: int, db: int) -> int:
    """cb_local of a sharded table of 2^db sub-tables whose fullest holds
    max_local entries: bfc_tpu's _finalize_sharded rule (load <= 0.4,
    mesh.py:644-646), raised as table_c_bits raises c_bits, so that qlow
    (l_pre + kb_bits - db - cb_local bits) fits the entry's 49 bits for
    every k and no 30-bit cap applies."""
    kb_bits = kops.keybody_bits(k, l_pre)
    return max(8, int(np.ceil(np.log2(max(max_local, 1) * 2.5 + 1))),
               l_pre + kb_bits - 49 - db)


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


def merge_cap() -> Optional[int]:
    """The row cap of a merge on the card: BFC_TPU_MAX_MERGE_CAP, bfc_tpu's
    own variable (counter.py:251-253, mesh.py:436), where set; else None.
    bfc_tpu's default of 2^22 rows was sized for a TPU v5e's memory, so
    unset means no row cap here: the byte rule alone decides."""
    v = os.environ.get("BFC_TPU_MAX_MERGE_CAP", "")
    return int(v) if v else None


def merge_on_card(rows_a: int, rows_b: int, need_bytes: int,
                  free_bytes: Optional[int], cap: Optional[int]) -> bool:
    """The spill rule: a merge of runs of rows_a and rows_b rows runs on the
    card only where max(rows_a, rows_b) <= cap (None: no cap) and the
    merge's peak, need_bytes (sdn.merge_bytes), is at most free_bytes
    (kernels.device_free_bytes; None on the CPU: no limit).  Decided
    before the merge, never by catching an allocation failure."""
    if cap is not None and max(rows_a, rows_b) > cap:
        return False
    return free_bytes is None or need_bytes <= free_bytes


class AggBuilder:
    """Incremental per-distinct-k-mer aggregation over padded batches.

    The counting tree of bfc_tpu's AggBuilder (counter.py:244-310,
    450-459, 573-617) on ops.lsm.LsmTree: a binary counter of merges on
    the card, level i holding the run of 2^i batches, so the total merge
    work is O(distinct * log batches).  A merge that the spill rule
    (merge_on_card) keeps off the card makes the tree spill: the device
    levels drain, oldest first, to a host binary counter of whole stream
    spans (merge_host_aggs).  Each spilled span is packed by KE on the
    pushing thread; two worker threads copy it to the host and merge it
    there while the stream goes on, allocating nothing on the card.  BFC_TPU_EAGER_SPILL (default 1)
    also spills, as soon as it forms, a run of more than the row cap's
    rows, which can never merge on the card again (eager_min =
    eager_min_after = the cap); without a row cap there is no eager
    spill, since the byte rule cannot say in advance which run is dead.
    spills and spilled_rows count the spilled spans and their rows, and
    host_merge_rows the input rows of the host merges.

    Each rank of the mesh (parallel/mesh.py) runs one on its own prefix
    range and spills by the same rule, its free bytes its share of a card
    that other ranks use too (_free_bytes); drain and on_host give what
    the ranks gather at the end.  Arrival order across add() calls must be
    the stream order."""

    def __init__(self, opt: Opts, device):
        self.opt = opt
        self.device = torch.device(device)
        self.k = opt.k
        self.l_pre = opt.effective_l_pre()
        self.kb_bits = kops.keybody_bits(self.k, self.l_pre)
        self.carry = not sdn.ret_derivable(self.k, self.l_pre)
        self.arrival_base = 0
        self.n_batches = 0
        self.cap = merge_cap()
        self.sharing = comm.ranks_sharing(self.device)
        self.spills = 0
        self.spilled_rows = 0
        self.host_merge_rows = 0
        eager = (self.cap is not None
                 and os.environ.get("BFC_TPU_EAGER_SPILL", "1") == "1")
        eager_min = self.cap if eager else 0
        self.tree = LsmTree(
            merge=self._merge_bounded, stage=self._spill_stage,
            to_host=self._spill_pull, host_merge=self._host_merge,
            async_spill=True, name="AggBuilder", size=len,
            eager_min=eager_min, eager_min_after=eager_min)

    def add(self, bases: np.ndarray, qok: np.ndarray, lens: np.ndarray) -> None:
        B, L = bases.shape
        dev = self.device
        run = sdn.chunk_run(
            torch.from_numpy(bases).to(dev), torch.from_numpy(qok).to(dev),
            torch.from_numpy(lens).to(dev), self.arrival_base, self.k,
            self.l_pre, self.carry)
        self.arrival_base += B * L
        self.add_run(run)

    def add_run(self, run: sdn.Run) -> None:
        """Push the run of the next stream span into the tree."""
        self.n_batches += 1
        self.tree.push(run)

    def _merge_bounded(self, a: sdn.Run, b: sdn.Run) -> Optional[sdn.Run]:
        """LsmTree's merge: a (the earlier span) and b merged on the card
        where merge_on_card allows it, else None (the tree spills)."""
        need = sdn.merge_bytes(a, b)
        free = self._free_bytes()
        if merge_on_card(len(a), len(b), need, free, self.cap):
            return self._merge(a, b)
        log(f"merge of {len(a)} + {len(b)} rows stays off the card "
            f"(cap {self.cap} rows, needs {need} bytes, {free} free): "
            "spilling", func="AggBuilder")
        return None

    def _free_bytes(self) -> Optional[int]:
        """The spill rule's free bytes: kernels.device_free_bytes on the
        card divided by self.sharing, the ranks of a mesh that run on this
        card (comm.ranks_sharing; 1 for a card of its own), and None (no
        limit) on the CPU.  Within a process only the pushing thread
        allocates on the card (KE's outputs are made in _spill_stage), so
        the bytes free here are still free when the merge runs.  Ranks
        that share the card allocate beside each other: each takes at most
        its 1/sharing of what it sees free, so the merges that the ranks
        check at the same moment fit together."""
        if self.device.type != "cuda":
            return None
        return kernels.device_free_bytes(self.device) // self.sharing

    def _merge(self, a: sdn.Run, b: sdn.Run) -> sdn.Run:
        return sdn.merge_runs(a, b)

    def drain(self):
        """Fold the tree: (the run on the card, None) where nothing spilled,
        else (None, the host tree's HostAgg, ret left out where
        derivable); (None, None) for an empty stream."""
        t0 = time.time()
        acc, host = self.tree.finish()
        if host is not None:
            log(f"{len(host.shard)} distinct k-mers aggregated (host tree): "
                f"{self.spills} spills of {self.spilled_rows} rows, "
                f"{self.tree.timings}, tree finish {time.time() - t0:.1f}s",
                func="AggBuilder")
        elif acc is not None:
            log(f"{len(acc)} distinct k-mers aggregated", func="AggBuilder")
        return acc, host

    def fold(self) -> Optional[sdn.Run]:
        """Merge the tree into one run on the card; for a tree that did not
        spill, else this raises: finish takes it."""
        acc, host = self.drain()
        if host is not None:
            raise RuntimeError("the counting tree spilled to the host: "
                               "AggBuilder.finish returns its aggregate")
        return acc

    def on_host(self, acc: Optional[sdn.Run],
                host: Optional[sph.HostAgg]) -> sph.HostAgg:
        """drain's result on the host, ret left out where derivable: the
        host tree's aggregate, else the folded run pulled (KE, then the
        copy), else an empty aggregate.  A rank of the mesh whose tree did
        not spill where another's did brings its run over this way."""
        if host is not None:
            return host
        if acc is None:
            return sph.empty_host_agg()
        return self.pull(acc, with_ret=self.carry)

    def pull(self, run: sdn.Run, with_ret: bool = True) -> sph.HostAgg:
        """The run on the host: packed by KE while arrivals stay below
        2^47 (bfc_tpu's _run_to_host, counter.py:501), unpacked above.
        ret is derived where the run does not carry it, unless with_ret
        is False."""
        return self._to_host(self._pack(run), with_ret)

    def _pack(self, run: sdn.Run):
        """The card's part of a pull: (packed, columns, rows, done), the
        columns packed by KE where arrivals allow it, and done an event
        after KE on the card (None on the CPU)."""
        packed = self.arrival_base < sdn.PACK_ARRIVAL_LIMIT
        cols = sdn.pack_pull(run) if packed else run
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return packed, cols, len(run), done

    def _to_host(self, staged, with_ret: bool) -> sph.HostAgg:
        """The host's part of a pull: copy _pack's columns and unpack them.
        Allocates nothing on the card.  Logs the copy and the unpack
        apart."""
        packed, cols, _, done = staged
        t0 = time.time()
        if done is not None:
            done.synchronize()
        host = pull_columns(cols)
        t1 = time.time()
        to_agg = sdn.packed_run_to_host_agg if packed else sdn.run_to_host_agg
        ha = to_agg(*host, self.k, self.l_pre, with_ret)
        log(f"pull {t1 - t0:.1f}s, host aggregate {time.time() - t1:.1f}s",
            func="AggBuilder")
        return ha

    def _spill_stage(self, run: sdn.Run):
        """LsmTree's stage, on the pushing thread: a spilled span's pack
        (KE), counted and logged.  Once the tree drops the run, only its
        packed columns stay on the card until the pull worker has copied
        them."""
        self.spills += 1
        self.spilled_rows += len(run)
        log(f"spill {self.spills}: {len(run)} rows", func="AggBuilder")
        return self._pack(run)

    def _spill_pull(self, staged) -> sph.HostAgg:
        """LsmTree's to_host, on the pull worker: one spilled span to the
        host, its ret left out where derivable (finish derives it
        once)."""
        return self._to_host(staged, self.carry)

    def _host_merge(self, a: sph.HostAgg, b: sph.HostAgg) -> sph.HostAgg:
        """LsmTree's host_merge: a covers the earlier span."""
        t0 = time.time()
        out = sph.merge_host_aggs(a, b, l_pre=self.l_pre, kb_bits=self.kb_bits)
        self.host_merge_rows += len(a.shard) + len(b.shard)
        log(f"host merge of {len(a.shard)} + {len(b.shard)} rows in "
            f"{time.time() - t0:.1f}s", func="AggBuilder")
        return out

    def finish(self, device_finalize: Optional[bool] = None):
        """Fold the tree.  Where nothing spilled: for the device finalize
        (device_finalize_on) the folded Run as it lies on the card, as
        bfc_tpu skips its pull and sketch there (counter.py:601-610); else
        the pulled aggregate with the Bloom sketch, a HostAgg.  Where the
        tree spilled, the merged HostAgg in both modes, its ret filled in
        (bfc_tpu's _ensure_ret, counter.py:562-571); the sketch is built
        over it for the host finalize only, as the device finalize's
        verdict (KF or KI, on the aggregate finalize_spectrum or the
        trimmer takes to the card) does not read it."""
        acc, host = self.drain()
        if host is not None:
            host = with_ret(host, self.k, self.l_pre)
            if device_finalize_on(device_finalize):
                return host
            return self.sketched(host)
        if device_finalize_on(device_finalize):
            return sdn.empty_run(self.device) if acc is None else acc
        if acc is None:
            return sph.empty_host_agg()
        return self.sketched(self.pull(acc))

    def sketched(self, ha: sph.HostAgg) -> sph.HostAgg:
        """ha with the Bloom sketch of its first arrivals attached: the
        minimum over the whole aggregate, which is what bfc_tpu's fold of
        span minima (_scatter_sketch, counter.py:527-543) converges to."""
        t0 = time.time()
        sketch = sph.BloomMinSketch.create(self.opt.bf_shift, self.opt.n_hashes)
        if sketch is not None:
            sketch.scatter(ha.ret, ha.first_arr)
            if sketch.valid:
                ha = ha._replace(bloom_min=sketch)
            log(f"Bloom sketch {time.time() - t0:.1f}s", func="AggBuilder")
        return ha


def with_ret(ha: sph.HostAgg, k: int, l_pre: int) -> sph.HostAgg:
    """ha with its ret derived from the identity where it was left out."""
    if ha.ret is not None:
        return ha
    return ha._replace(ret=sdn.derive_ret_np(ha.shard, ha.keybody, k, l_pre))


def pull_columns(cols):
    """Device columns (None passes through) -> numpy arrays on the host."""
    return [None if f is None else f.cpu().numpy() for f in cols]


def padded_batches(fn: str, opt: Opts, batch_reads: int, rows=None):
    """The native reader's batches as AggBuilder.add takes them: (bases,
    qual_ok, lens, n), padded to batch_reads reads and the sticky L, which
    every batch's longest read sets.  rows=(lo, hi) yields only rows
    [lo, hi) of each padded batch and decodes only those
    (count_file_mesh's share); n stays the batch's read count."""
    from ..io import fast_reader as FR

    lo, hi = (0, batch_reads) if rows is None else rows
    pad_L = 0
    for rb in FR.iter_batches_prefetch(fn, batch_reads, max_bases=opt.chunk_size,
                                       decode_range=rows):
        n = rb.n
        a, b = min(lo, n), min(hi, n)
        rb.ensure_decoded(a, b)  # a -L split can shift the decoded rows
        pad_L = max(pad_L, _round_up(int(rb.lens.max()) if n else 1, 32))
        L = pad_L
        m = b - a
        lens0 = rb.lens[a:b]
        Lc = min(L, rb.bases.shape[1])
        bases = np.full((hi - lo, L), 4, np.uint8)
        bases[:m, :Lc] = rb.bases[a:b, :Lc]
        lens = np.zeros((hi - lo,), np.int32)
        lens[:m] = lens0
        qok = np.zeros((hi - lo, L), bool)
        has_q = rb.has_qual()[a:b]
        inb = np.arange(Lc)[None, :] < lens0[:, None]
        qok[:m, :Lc] = np.where(
            has_q[:, None],
            rb.quals[a:b, :Lc].astype(np.int32) - 33 >= opt.q,
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


def kept_on_device(run: sdn.Run, opt: Opts):
    """The device finalize of a folded run up to its table: KJ where ret
    is not carried, the verdict (KF, or KI past 2^32 arrivals), KK and the
    kept rows compacted.  Returns (shard, keybody, payload, hist,
    hist_high, verdict), the entries on the card in (shard, keybody)
    order."""
    run = sdn.run_to_aggregate(run, opt.k, opt.effective_l_pre())
    fp, _, verdict = spec.adjudicate(run.ret, run.arr, run.n, opt.bf_shift,
                                     opt.n_hashes)
    payload, keep, hist, hist_high = spec.finalize_counts(
        run.n, run.n_high, run.first_high, fp)
    idx = torch.nonzero(keep).flatten()
    return (run.shard[idx], run.keybody[idx], payload[idx], hist, hist_high,
            verdict)


def finalize_on_device(run: sdn.Run, opt: Opts, device) -> DeviceSpectrum:
    """The device finalize of a folded run (bfc_tpu's finalize_spectrum
    with host=False, counter.py:745-819): kept_on_device, then KL,
    retried one bit larger on a failed placement.  The host copy of the
    entries is pulled at first use."""
    t0 = time.time()
    *kept, verdict = kept_on_device(run, opt)
    return table_on_device(*kept, opt, verdict, t0)


def table_on_device(shard, keybody, payload, hist, hist_high, opt: Opts,
                    verdict: str, t0: float) -> DeviceSpectrum:
    """The device finalize's table (KL) from the kept entries (int64
    shard and keybody, int32 payload) at table_c_bits, retried one bit
    larger on a failed placement; t0 is when the finalize began."""
    k, l_pre = opt.k, opt.effective_l_pre()
    kb_bits = kops.keybody_bits(k, l_pre)
    n = shard.shape[0]
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

