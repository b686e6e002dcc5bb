"""Prefix-sharded counting and the distributed finalize, one rank a device.

Counterpart of bfc_tpu/parallel/mesh.py with the table replicated
(shard_table off, its default):

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
             histograms and kept counts are summed, the kept entries
             gathered, and every rank builds the whole table (KL).

Arrivals are global (bfc_tpu's mesh.py:110-114), so the counts and
verdicts are those of the single-device pass, and so is the output.
bfc_tpu's fixed bucket and merge capacities and their overflow retries
(mesh.py:493-501) exist for XLA's fixed shapes; the exchanges here take
uneven splits and need neither.  A merge that does not fit the card
raises, as AggBuilder's does.
"""

from __future__ import annotations

import time

import torch

from ..models import counter as C
from ..ops import route
from ..ops import spectrum as spec
from ..ops import spectrum_dense as sdn
from ..opts import Opts
from ..utils.log import log
from . import comm


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
    order; KI sorts what it receives by (block, arrival) itself."""
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


def finalize_mesh(run: sdn.Run, opt: Opts) -> C.DeviceSpectrum:
    """The distributed finalize of this rank's folded run: the replicated
    table on every rank (bfc_tpu's _finalize_sharded with shard_table off,
    mesh.py:610-667)."""
    t0 = time.time()
    run = sdn.run_to_aggregate(run, opt.k, opt.effective_l_pre())
    fp = sharded_adjudicate(run, opt.bf_shift, opt.n_hashes)
    shard, keybody, payload, _, hist, hist_high = sharded_payloads(run, fp)
    hist, hist_high = comm.all_reduce(hist), comm.all_reduce(hist_high)
    shard, keybody, payload = comm.all_gather_rows([shard, keybody, payload])
    return C.table_on_device(shard, keybody, payload, hist, hist_high, opt,
                             "KI", t0)


def count_file_mesh(fn: str, opt: Opts, device,
                    batch_reads: int = 16384) -> C.DeviceSpectrum:
    """Counting pass sharded over the ranks from a FASTQ file (bfc_tpu's
    count_file_mesh, mesh.py:346-398, and count_encoded_mesh, :401-538):
    this rank decodes and counts rows [r B/R, (r+1) B/R) of every batch,
    and the spectrum is finalized on the devices."""
    R, r = comm.size(), comm.rank()
    if batch_reads % R:
        raise ValueError(f"batch_reads {batch_reads} is not a multiple of "
                         f"the {R} ranks")
    step = batch_reads // R
    k, l_pre = opt.k, opt.effective_l_pre()
    dev = torch.device(device)
    tree = C.AggBuilder(opt, dev)
    n_reads = 0
    for bases, qok, lens, n in C.padded_batches(fn, opt, batch_reads,
                                                rows=(r * step, (r + 1) * step)):
        L = bases.shape[1]
        run = sharded_chunk_run(
            torch.from_numpy(bases).to(dev), torch.from_numpy(qok).to(dev),
            torch.from_numpy(lens).to(dev), tree.arrival_base + r * step * L,
            k, l_pre, tree.carry)
        tree.arrival_base += batch_reads * L
        tree.add_run(run)
        n_reads += n
    log(f"processed {n_reads} sequences over {R} devices",
        func="count_file_mesh")
    acc = tree.fold()
    if acc is None:
        acc = sdn.empty_run(dev)
    n_agg = int(comm.all_reduce(torch.tensor([len(acc)])))
    log(f"{n_agg} distinct k-mers aggregated", func="count_file_mesh")
    ds = finalize_mesh(acc, opt)
    ds.n_reads, ds.n_aggregated = n_reads, n_agg
    return ds
