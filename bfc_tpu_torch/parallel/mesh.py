"""Prefix-sharded counting and the distributed finalize, one rank a device.

Counterpart of bfc_tpu/parallel/mesh.py:

  counting   each rank takes rows [r B/R, (r+1) B/R) of every padded batch
             of B reads, rolls their k-mers (KA), routes each row to the
             owner of its table shard (KM, the prefix rule), exchanges the
             rows with one all_to_all a column, and sorts and combines what
             it received (torch.sort + KB).  Received rows come in source
             rank order, which is arrival order within the batch, so a key
             group's first row stays its first occurrence.  Each rank
             folds its runs in its own merge tree (AggBuilder).
  finalize   each rank derives ret (KJ), routes (ret, arrival) to the owner
             of the row's Bloom block (KM, the Bloom rule), judges the
             rows it received by first occurrence (KI, exact at any
             arrival width, every block wholly on one rank), sends the
             verdicts back, and computes its rows' payloads (KK).  The
             histograms and kept counts are summed.  With the table
             replicated (the default) the kept entries are gathered and
             every rank builds the whole table (KL).  With the sharded
             table (BFC_TPU_SHARD_TABLE=1, R a power of two) a rank's kept
             entries are exactly its sub-table's keys, since the counting
             route's owner (the top log2 R bits of the l_pre prefix) is
             the sub-table's (the top log2 R bits of the position key):
             each rank builds its sub-table (KN) with nothing exchanged,
             and the ranks map each other's (peer.share).

  spill      each rank's AggBuilder spills by the single card's rule (its
             share of a card that ranks share), its spans to a host tree of
             its own, whose two workers copy and merge numpy and run no
             collective.  After the last batch one all_reduce says whether
             any rank spilled.  If one did, every rank brings its aggregate
             to the host (a rank that did not spill pulls its folded run)
             and rank 0 gathers them in rank order: the ranks' prefix
             ranges are disjoint and ascend with the rank, so the
             concatenation is the single-device aggregate, sorted.  Rank 0
             finalizes it once, on the host or with
             BFC_TPU_DEVICE_FINALIZE=1 on its card (finalize_spectrum's
             rule), and sends the kept entries and histograms to every
             rank, which builds the replicated table (KL) or its sub-table
             (KN) from them (finalize_gathered).

  entry      count_encoded_mesh counts an iterator of each rank's rows of
             encoded batches; count_file_mesh is its FASTQ reader.  It is
             count_mesh (the stream, the fold and the spill's meeting),
             then finalize_count, so that a caller can read each rank's
             aggregate between the two (tools/human_scale.py's check).

Arrivals are global (bfc_tpu's mesh.py:110-114), so the counts and
verdicts are those of the single-device pass, and so is the output.
bfc_tpu's fixed bucket and merge capacities and their overflow retries
(mesh.py:493-501) exist for XLA's fixed shapes; the exchanges here take
uneven splits and need neither.  bfc_tpu's mesh spills synchronously
(mesh.py:434-481), as its pull all-gathers a global array; a rank here
spills only its own rows, so its workers need nothing of the others
until the meeting after the last batch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..models import counter as C
from ..ops import kmer as kops
from ..ops import route
from ..ops import spectrum as spec
from ..ops import spectrum_dense as sdn
from ..ops import spectrum_host as sph
from ..opts import Opts
from ..utils.log import log
from . import comm, peer


def sharded_chunk_run(bases, qual_ok, lens, arrival_base: int, k: int,
                      l_pre: int, carry_ret: bool) -> sdn.Run:
    """One rank's share of a counting batch -> the run of the k-mers this
    rank owns, over the whole batch.  bases, qual_ok, lens: this rank's
    rows; arrival_base: the arrival of its first slot."""
    rows = sdn.chunk_rows(bases, qual_ok, lens, arrival_base, k, l_pre,
                          carry_ret)
    routed = route.route_rows(list(rows), comm.size(), route.PREFIX, l_pre,
                              shard=rows.shard)
    recv, _ = comm.all_to_all_rows(routed.cols, routed.counts)
    return sdn.rows_run(sdn.Rows(*recv))


def sharded_merge(a: sdn.Run, b: sdn.Run) -> sdn.Run:
    """Merge two runs of this rank's prefix range (a the earlier span):
    the combine stays local."""
    return sdn.merge_runs(a, b)


def sharded_adjudicate(run: sdn.Run, bf_shift: int, n_hashes: int):
    """First-occurrence verdicts of this rank's rows (bool [C]), judged on
    the ranks that own their Bloom blocks.  run carries ret (run_to_
    aggregate).  Every row of a block lands on one rank, in source rank
    order; KI groups what it receives by block itself, in any order."""
    routed = route.route_rows([run.ret, run.arr], comm.size(), route.BLOOM,
                              bf_shift, ret=run.ret)
    (r_ret, r_arr), recv_counts = comm.all_to_all_rows(routed.cols,
                                                       routed.counts)
    fp_recv = spec.adjudicate_first_occurrence(r_ret, r_arr, bf_shift,
                                               n_hashes)
    (fp_back,), _ = comm.all_to_all_rows([fp_recv.to(torch.uint8)],
                                         recv_counts, routed.counts)
    fp = torch.zeros((len(run),), dtype=torch.bool, device=run.shard.device)
    fp[routed.perm] = fp_back.to(torch.bool)
    return fp


def sharded_payloads(run: sdn.Run, fp):
    """This rank's kept entries and counts (KK, then compaction): (shard,
    keybody, payload int32, n_kept, hist int64 [256], hist_high [64]),
    bfc_tpu's _payloads_sharded (mesh.py:542) for one device."""
    payload, keep, hist, hist_high = spec.finalize_counts(
        run.n, run.n_high, run.first_high, fp)
    idx = torch.nonzero(keep).flatten()
    return (run.shard[idx], run.keybody[idx], payload[idx], idx.shape[0],
            hist, hist_high)


def shardable(shard_table: bool) -> bool:
    """Whether this mesh takes the sharded table: asked for and R a power
    of two (bfc_tpu's mesh.py:650); otherwise it is replicated, and a
    request that cannot be met is logged."""
    R = comm.size()
    if shard_table and R & (R - 1):
        log(f"a sharded table needs a power-of-two number of devices, not "
            f"{R}; correcting with a replicated table", func="mesh")
        return False
    return shard_table


def sharded_spectrum(shard, keybody, payload, hist, hist_high, k: int,
                     l_pre: int, verdict: str, t0: float) -> C.DeviceSpectrum:
    """The sharded table from this rank's kept entries, its own sub-table
    (bfc_tpu's _finalize_sharded with shard_table on, mesh.py:641-660):
    cb_local by counter.subtable_bits from the fullest rank, KN on every
    rank, all ranks again one bit larger if any rank failed a placement,
    then peer.share.  hist and hist_high are the mesh's sums; t0 is when
    the finalize began.  The spectrum's entries are this rank's."""
    R = comm.size()
    db = R.bit_length() - 1
    kb_bits = kops.keybody_bits(k, l_pre)
    dev = shard.device
    by_rank = comm.lengths(shard.shape[0])
    t1 = time.time()
    cb_local = C.subtable_bits(max(by_rank), k, l_pre, db)
    while True:
        buf = peer.alloc(1 << cb_local, dev) if dev.type == "cuda" else None
        own, ok = spec.cuckoo_build_local(
            shard, keybody, payload, l_pre, kb_bits, db + cb_local, db,
            out=None if buf is None else buf.tensor())
        if int(comm.all_reduce(torch.tensor([int(not ok)]))) == 0:
            break
        if buf is not None:
            buf.release()
        log(f"cuckoo placement failed at cb_local {cb_local} on a rank; "
            "retrying larger", func="mesh")
        cb_local += 1
    table = peer.share(own, k, l_pre, kb_bits, buf)

    def pull():
        return (shard.cpu().numpy().astype(np.uint32),
                keybody.cpu().numpy().view(np.uint64),
                payload.cpu().numpy().view(np.uint32))

    ds = C.DeviceSpectrum(table, sum(by_rank), _np(hist), _np(hist_high),
                          pull, verdict)
    ds.entries_by_rank = by_rank
    log(f"# distinct k-mers in table: {sum(by_rank)} (sharded over {R} "
        f"devices: {by_rank} entries; verdict and payloads "
        f"{t1 - t0:.1f}s, sub-tables {time.time() - t1:.1f}s, cb_local "
        f"{cb_local})")
    return ds


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def finalize_mesh(run: sdn.Run, opt: Opts,
                  shard_table: bool = False) -> C.DeviceSpectrum:
    """The distributed finalize of this rank's folded run (bfc_tpu's
    _finalize_sharded, mesh.py:610-667): the sharded table where
    shardable(shard_table), else the replicated table on every rank."""
    t0 = time.time()
    k, l_pre = opt.k, opt.effective_l_pre()
    run = sdn.run_to_aggregate(run, k, l_pre)
    fp = sharded_adjudicate(run, opt.bf_shift, opt.n_hashes)
    shard, keybody, payload, _, hist, hist_high = sharded_payloads(run, fp)
    hist, hist_high = comm.all_reduce(hist), comm.all_reduce(hist_high)
    if shardable(shard_table):
        return sharded_spectrum(shard, keybody, payload, hist, hist_high, k,
                                l_pre, "KI", t0)
    shard, keybody, payload = comm.all_gather_rows([shard, keybody, payload])
    return C.table_on_device(shard, keybody, payload, hist, hist_high, opt,
                             "KI", t0)


def own_spectrum(shard, keybody, payload, hist, hist_high, k: int,
                 l_pre: int, device, verdict: str,
                 t0: float) -> C.DeviceSpectrum:
    """The sharded table from every kept entry, given to every rank (int64
    shard and keybody, int32 payload, on the host): the entries this
    rank's sub-table owns (spec.subtable_owner) built by sharded_spectrum,
    as bfc_tpu's shard_cuckoo_table (mesh.py:287-326) splits them."""
    db = comm.size().bit_length() - 1
    kb_bits = kops.keybody_bits(k, l_pre)
    owner = spec.subtable_owner(shard, keybody, l_pre, kb_bits, db)
    mine = torch.nonzero(owner == comm.rank()).flatten()
    dev = torch.device(device)
    return sharded_spectrum(shard[mine].to(dev), keybody[mine].to(dev),
                            payload[mine].to(dev), hist, hist_high, k, l_pre,
                            verdict, t0)


def restore_mesh(fn: str, device, shard_table: bool) -> C.DeviceSpectrum:
    """A -r dump on every rank: the spectrum restore_spectrum gives, or
    with the sharded table each rank's sub-table of the restored entries
    it owns (own_spectrum)."""
    if not shardable(shard_table):
        return C.restore_spectrum(fn, device)
    t0 = time.time()
    k, l_pre, shard, keybody, payload = C.read_dump(fn)
    hist = np.bincount(payload & 0xFF, minlength=256)[:256]
    hist[0] = 0
    hist_high = np.bincount((payload >> 8) & 0x3F, minlength=64)[:64]
    return own_spectrum(
        torch.from_numpy(shard.astype(np.int64)),
        torch.from_numpy(keybody.view(np.int64)),
        torch.from_numpy(payload.view(np.int32)), hist, hist_high, k, l_pre,
        device, "restored", t0)


def gathered_entries(ds: C.DeviceSpectrum):
    """The kept entries (shard u32, keybody u64, payload u32) in key order
    on rank 0, None on the other ranks.  A sharded spectrum's are
    gathered to rank 0 in rank order, which is shard order, a
    collective; a replicated one's are rank 0's own."""
    if not isinstance(ds.table, spec.ShardedTable):
        return ds.compact_entries() if comm.rank() == 0 else None
    cols = [torch.from_numpy(np.ascontiguousarray(c).view(np.int64)
                             if c.dtype == np.uint64 else c.astype(np.int64))
            for c in ds.compact_entries()]
    got = comm.gather_rows(cols)
    if got is None:
        return None
    shard, keybody, payload = (c.numpy() for c in got)
    return (shard.astype(np.uint32), keybody.view(np.uint64),
            payload.astype(np.uint32))


def dump_mesh(ds: C.DeviceSpectrum, fn: str) -> None:
    """-d in a mesh, a collective: rank 0 alone writes the dump of the
    entries (gathered_entries)."""
    got = gathered_entries(ds)
    if got is not None:
        C.write_dump(fn, ds.k, ds.l_pre, *got)


# a HostAgg's columns as they cross the gloo group: (field, its dtype, the
# signed dtype of the same width that torch carries it in)
AGG_COLUMNS = (("shard", np.uint32, np.int32),
               ("keybody", np.uint64, np.int64),
               ("ret", np.uint64, np.int64), ("n", np.uint32, np.int32),
               ("n_high", np.uint32, np.int32),
               ("first_arr", np.uint64, np.int64),
               ("first_high", np.uint32, np.int32))


def agg_columns(ha: sph.HostAgg, carry: bool) -> list:
    """ha's columns as torch tensors over its arrays (ret only where the
    runs carry it), the list that gather_aggregate consumes."""
    return [torch.from_numpy(np.ascontiguousarray(getattr(ha, f), u).view(i))
            for f, u, i in AGG_COLUMNS if carry or f != "ret"]


def gather_aggregate(cols: list, carry: bool) -> Optional[sph.HostAgg]:
    """Every rank's host aggregate (agg_columns), concatenated in rank
    order on rank 0, None elsewhere.  cols is emptied column by column,
    so a rank's copy of each column goes once it is sent.  Raises on rank
    0 unless the result is in (shard, keybody) order: the ranks' prefix
    ranges must be disjoint and ascend with the rank."""
    got = {}
    for f, u, _ in AGG_COLUMNS:
        if f == "ret" and not carry:
            got[f] = None
            continue
        part = comm.gather_rows([cols.pop(0)])
        if part is not None:
            got[f] = part[0].numpy().view(u)
    if comm.rank() != 0:
        return None
    ha = sph.HostAgg(**got)
    if not sph.in_key_order(ha.shard, ha.keybody):
        raise RuntimeError("the ranks' aggregates, in rank order, are not in "
                           "(shard, keybody) order")
    return ha


def finalize_gathered(cols: list, tree: C.AggBuilder, opt: Opts, device,
                      shard_table: bool,
                      device_finalize: Optional[bool]) -> C.DeviceSpectrum:
    """The finalize of a mesh in which a rank spilled, a collective: every
    rank's aggregate (agg_columns) gathered to rank 0, which fills in ret,
    finalizes it once by finalize_spectrum's rule (on the host with the
    Bloom sketch, or with device_finalize_on(device_finalize) on its card:
    bfc_tpu's finalize_spectrum(hacc, opt), mesh.py:505-513) and sends the
    kept entries and the histograms to every rank; each builds the
    sharded table where shardable(shard_table) (own_spectrum), else the
    replicated one (KL).  The spectrum's count_report holds the finalize
    mode and rank 0's gather, finalize and send seconds."""
    k, l_pre = opt.k, opt.effective_l_pre()
    on = C.device_finalize_on(device_finalize)
    t0 = time.time()
    agg = gather_aggregate(cols, tree.carry)
    t1 = time.time()
    entries = hists = tag = None  # what rank 0 sends
    if agg is not None:
        agg = C.with_ret(agg, k, l_pre)
        if on:
            C.check_upload(agg, opt, device)
            *entries, hist, hist_high, verdict = C.kept_on_device(
                C.host_agg_to_run(agg, device), opt)
        else:
            agg = tree.sketched(agg)
            shard, keybody, payload, hist, hist_high = sph.finalize_host(
                agg, opt.bf_shift, opt.n_hashes, k=k, l_pre=l_pre)
            verdict = "host sketch" if C.usable_sketch(agg, opt) else \
                "host sort"
            entries = [torch.from_numpy(shard.astype(np.int64)),
                       torch.from_numpy(keybody.view(np.int64)),
                       torch.from_numpy(payload.view(np.int32))]
        del agg
        hists = [torch.cat([torch.as_tensor(hist).cpu(),
                            torch.as_tensor(hist_high).cpu()]).to(torch.int64)]
        tag = [torch.tensor(list(verdict.encode()), dtype=torch.uint8)]
        log(f"{len(entries[0])} k-mers kept by the {verdict} verdict on "
            f"rank 0 in {time.time() - t1:.1f}s (gather {t1 - t0:.1f}s)",
            func="count_file_mesh")
    t2 = time.time()
    shard, keybody, payload = comm.broadcast_rows(
        entries, (torch.int64, torch.int64, torch.int32))
    (hists,) = comm.broadcast_rows(hists, (torch.int64,))
    (tag,) = comm.broadcast_rows(tag, (torch.uint8,))
    verdict = bytes(tag.tolist()).decode()
    del entries
    hist, hist_high = hists[:256], hists[256:]
    t3 = time.time()
    if shardable(shard_table):
        ds = own_spectrum(shard, keybody, payload, hist, hist_high, k, l_pre,
                          device, verdict, t2)
    else:
        dev = torch.device(device)
        ds = C.table_on_device(shard.to(dev), keybody.to(dev),
                               payload.to(dev), hist, hist_high, opt,
                               verdict, t2)
    ds.count_report = {"finalize": "device" if on else "host",
                       "gather_s": t1 - t0, "finalize_s": t2 - t1,
                       "send_s": t3 - t2}
    return ds


def share_rows(batch_reads: int):
    """This rank's rows [lo, hi) of every padded batch of batch_reads
    reads: [r B/R, (r+1) B/R).  Raises where R does not divide B."""
    R, r = comm.size(), comm.rank()
    if batch_reads % R:
        raise ValueError(f"batch_reads {batch_reads} is not a multiple of "
                         f"the {R} ranks")
    step = batch_reads // R
    return r * step, (r + 1) * step


@dataclasses.dataclass
class MeshCount:
    """This rank's share of a counting pass, before its finalize
    (count_mesh): the counting tree; where no rank spilled, the folded
    run on the device (run), else this rank's aggregate on the host
    (host: its host tree's, or its folded run pulled), ret left out where
    derivable; the reads of the stream, the mesh's aggregated rows and
    how many ranks spilled.  finalize_count takes run or host out as it
    consumes it."""

    tree: C.AggBuilder
    run: Optional[sdn.Run]
    host: Optional[sph.HostAgg]
    n_reads: int
    n_agg: int
    spilled: int


def count_mesh(batch_iter, opt: Opts, device,
               batch_reads: int = 16384) -> MeshCount:
    """The counting of count_encoded_mesh, a collective: every batch
    through sharded_chunk_run into this rank's tree, then the tree folded
    and one all_reduce telling every rank whether any spilled; a rank
    whose tree did not spill where another's did pulls its folded run
    (AggBuilder.on_host)."""
    lo, hi = share_rows(batch_reads)
    R = comm.size()
    k, l_pre = opt.k, opt.effective_l_pre()
    dev = torch.device(device)
    tree = C.AggBuilder(opt, dev)
    n_reads = 0
    for bases, qok, lens, n_records in batch_iter:
        if bases.shape[0] != hi - lo:
            raise ValueError(f"a batch share of {bases.shape[0]} rows; rank "
                             f"{comm.rank()} of {R} owns {hi - lo}")
        n_reads += int(n_records)
        L = bases.shape[1]
        run = sharded_chunk_run(
            torch.from_numpy(bases).to(dev), torch.from_numpy(qok).to(dev),
            torch.from_numpy(lens).to(dev), tree.arrival_base + lo * L,
            k, l_pre, tree.carry)
        tree.arrival_base += batch_reads * L
        tree.add_run(run)
    log(f"processed {n_reads} sequences over {R} devices",
        func="count_file_mesh")
    acc, host = tree.drain()
    spilled = int(comm.all_reduce(torch.tensor([int(host is not None)])))
    if spilled:
        host = tree.on_host(acc, host)
        acc = None
        n_agg = sum(comm.lengths(len(host.shard)))
        log(f"{n_agg} distinct k-mers aggregated; {spilled} of {R} ranks "
            "spilled", func="count_file_mesh")
    else:
        acc = sdn.empty_run(dev) if acc is None else acc
        n_agg = int(comm.all_reduce(torch.tensor([len(acc)])))
        log(f"{n_agg} distinct k-mers aggregated", func="count_file_mesh")
    return MeshCount(tree, acc, host, n_reads, n_agg, spilled)


def finalize_count(mc: MeshCount, opt: Opts, device,
                   shard_table: bool = False,
                   device_finalize: Optional[bool] = None
                   ) -> C.DeviceSpectrum:
    """The finalize of count_mesh's share, a collective: where no rank
    spilled, the distributed finalize on the devices, its table sharded
    with shard_table (finalize_mesh); else rank 0's finalize of the
    gathered aggregate (finalize_gathered, device_finalize choosing the
    mode).  The spectrum's count_report holds every rank's spills and
    rows spilled."""
    tree = mc.tree
    if mc.spilled:
        cols = agg_columns(mc.host, tree.carry)
        mc.host = None
        ds = finalize_gathered(cols, tree, opt, torch.device(device),
                               shard_table, device_finalize)
    else:
        run, mc.run = mc.run, None
        ds = finalize_mesh(run, opt, shard_table)
        ds.count_report = {"finalize": "device"}
    ds.count_report.update(spills_by_rank=comm.lengths(tree.spills),
                           spilled_rows_by_rank=comm.lengths(
                               tree.spilled_rows))
    ds.n_reads, ds.n_aggregated = mc.n_reads, mc.n_agg
    return ds


def count_encoded_mesh(batch_iter, opt: Opts, device,
                       batch_reads: int = 16384, shard_table: bool = False,
                       device_finalize: Optional[bool] = None
                       ) -> C.DeviceSpectrum:
    """Counting pass sharded over the ranks from encoded batches (bfc_tpu's
    count_encoded_mesh, mesh.py:401-538): count_mesh, then finalize_count.

    batch_iter yields this rank's rows [r B/R, (r+1) B/R) of each padded
    batch of B = batch_reads reads, in stream order, as (bases u8
    [B/R, L], qual_ok bool, lens i32, n_records): n_records is the
    whole batch's read count, the same on every rank (bfc_tpu's optional
    fourth item is required here).  Every rank's iterator yields
    the same number of batches, each with the same L (L may grow from
    batch to batch).  Arrivals stay global: rank r's rows of a batch
    start at arrival_base + r (B/R) L, and arrival_base advances by B L a
    batch, so the spectrum is the single-device pass's."""
    return finalize_count(count_mesh(batch_iter, opt, device, batch_reads),
                          opt, device, shard_table, device_finalize)


def count_file_mesh(fn: str, opt: Opts, device, batch_reads: int = 16384,
                    shard_table: bool = False,
                    device_finalize: Optional[bool] = None
                    ) -> C.DeviceSpectrum:
    """Counting pass sharded over the ranks from a FASTQ file (bfc_tpu's
    count_file_mesh, mesh.py:346-398): this rank decodes rows [r B/R,
    (r+1) B/R) of every batch (counter.padded_batches) and feeds them to
    count_encoded_mesh."""
    rows = share_rows(batch_reads)
    return count_encoded_mesh(C.padded_batches(fn, opt, batch_reads,
                                               rows=rows),
                              opt, device, batch_reads, shard_table,
                              device_finalize)
