"""End-to-end pipeline on the card: count -> correct (or trim) ->
formatted output.

Counterpart of bfc_tpu/models/device_pipeline.py, mirroring main() of the
reference CLI (bfc.c:126-150).  Reads stream through the corrector, or in
trim mode (-1) the trimmer, in batches and records are written in input
order (the reference's kt_pipeline ordering guarantee), through the
native formatter.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..io.fastq import Read, format_corrected, pack_stats
from ..io.writer import OutputWriter
from ..ops import search as srch
from ..ops.spectrum import ShardedTable
from ..opts import Opts
from ..parallel import comm, peer
from ..utils.log import log
from . import refine as RF
from .corrector import BatchResult, Corrector
from .counter import (DeviceSpectrum, count_file_device, device_finalize_on,
                      restore_spectrum)
from .trimmer import Trimmer, count_file_filter_device, popcount


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def resolve_device(device=None) -> torch.device:
    """The device entry points run on: the card unless the caller asks for
    the CPU.  Without a card and without that request, raise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (CLI --cpu) "
                           "to run on the CPU")
    return dev


def correct_file_device(fn: str, opt: Opts, ds: DeviceSpectrum, out,
                        batch_reads: int = srch.CORRECT_BATCH,
                        mesh: bool = False) -> Corrector:
    """Correct (under -R refine, models/refine.py) fn batch by batch and
    write the records in input order.
    A batch is one launch of KC and one of KD: at most batch_reads reads,
    and the reader ends it where its 4 MB block of text ends (search.py:
    CORRECT_BATCH says why the default is not smaller).

    With mesh (data-parallel correction, bfc_tpu's device_pipeline.py:
    58-91) rank r of R corrects and formats rows [n r/R, n (r+1)/R) of
    every batch of n reads against its own copy of the table, and rank 0
    gathers the byte segments in rank order and writes them; the other
    ranks write nothing."""
    from ..io import fast_reader as FR

    R, r = (comm.size(), comm.rank()) if mesh else (1, 0)
    corr = Corrector(opt, ds)
    carry = None
    if opt.refine_ec:
        carry = RF.RefineCarry()
        corr.refine_counts = RF.RefineCounts()
    n_done = 0
    t_corr = t_emit = 0.0
    for rb in FR.iter_batches_prefetch(fn, batch_reads, max_bases=opt.chunk_size):
        if rb.n == 0:
            continue
        a, b = rb.n * r // R, rb.n * (r + 1) // R
        dst = OutputWriter(None) if mesh else out
        t0 = time.time()
        res = None
        if carry is not None:
            # -R: every rank reads the whole batch's tags, so the stats
            # carried into its rows are right
            tags = RF.parse_tags(rb, carry)
            corr.refine_counts.tags_s += time.time() - t0
            if b > a:
                RF.refine_rows(corr, rb, tags, a, b, dst)
        elif b > a:
            res = corr.correct_arrays(
                rb.bases[a:b], rb.quals[a:b], rb.lens[a:b],
                rb.has_qual()[a:b],
                lambda i, rb=rb, a=a: (rb.seq(a + i), rb.qual(a + i)))
        t1 = time.time()
        if res is not None and not _emit_rb_native(rb, res, opt, dst, a):
            _emit_rb_python(rb, res, opt, dst, a)
        if mesh:
            for seg in comm.gather_segments(dst.getbytes()):
                out.write_bytes(seg)
        t_corr += t1 - t0
        t_emit += time.time() - t1
        n_done += rb.n
        log(f"processed {n_done} sequences", func="correct_file_device")
    log(f"correct {t_corr:.1f}s (device step {corr.t_device:.1f}s), "
        f"emit {t_emit:.1f}s", func="correct_file_device")
    return corr


def _emit_rb_native(rb, res: BatchResult, opt: Opts, out, a: int = 0) -> bool:
    """Emit the records of rows [a, a + res.n) of a batch via the native
    formatter (native/fastxio.c:fastx_format, the counterpart of the
    reference's output loop correct.c:596-611).  Returns False to fall
    back to the per-read Python path (slow-parser batches, scalar-fallback
    reads, no native library)."""
    import ctypes

    from ..native.build import get_lib

    lib = get_lib()
    if (lib is None or rb._strings is not None or res.exceptional
            or not hasattr(out, "write_bytes")):
        return False
    code = res.code
    is_fq = res.has_q & (not opt.no_qual)
    mode = np.where(code == 0, 0, 1).astype(np.uint8) | (
        is_fq.astype(np.uint8) << 2)
    if opt.discard:
        mode = np.where(code != 0, 3, mode).astype(np.uint8)
    b = a + res.n
    lens = np.ascontiguousarray(res.lens, dtype=np.int32)
    name_off = np.ascontiguousarray(rb.name_off[a:b], dtype=np.int64)
    name_len = np.ascontiguousarray(rb.name_len[a:b], dtype=np.int32)
    seq_off = np.ascontiguousarray(rb.seq_off[a:b], dtype=np.int64)
    qual_off = np.ascontiguousarray(rb.qual_off[a:b], dtype=np.int64)
    seq_rows = np.ascontiguousarray(res.seq_rows)
    qual_rows = np.ascontiguousarray(res.qual_rows)
    aux = np.ascontiguousarray(res.aux)
    aux2 = np.ascontiguousarray(res.aux2)
    cap = int((name_len.astype(np.int64) + 2 * lens + 96).sum()) + 16
    buf = ctypes.create_string_buffer(cap)

    def p(arr, ct):
        return arr.ctypes.data_as(ctypes.POINTER(ct))

    ret = lib.fastx_format(
        res.n, rb.buf,
        p(name_off, ctypes.c_int64), p(name_len, ctypes.c_int32),
        p(seq_off, ctypes.c_int64), p(qual_off, ctypes.c_int64),
        p(seq_rows, ctypes.c_ubyte), p(qual_rows, ctypes.c_ubyte),
        seq_rows.shape[1],
        p(lens, ctypes.c_int32),
        p(aux, ctypes.c_uint64), p(aux2, ctypes.c_uint64),
        p(mode, ctypes.c_ubyte),
        buf, cap, None, None, None,
    )
    if ret < 0:
        raise RuntimeError("fastx_format: output buffer too small")
    out.write_bytes(buf.raw[:ret])
    return True


def _emit_rb_python(rb, res: BatchResult, opt: Opts, out, a: int = 0) -> None:
    """Per-read emit path (slow-parser batches and fallback reads) for
    rows [a, a + res.n) of a batch."""
    for i in range(res.n):
        st, s2, q2 = res.tuple_of(i)
        r = Read(name=rb.name(a + i), comment=None, seq=s2, qual=q2)
        r.aux, r.aux2 = pack_stats(st)
        format_corrected(r, opt.no_qual, False, opt.discard, out)


def shard_table_on(shard_table: Optional[bool] = None) -> bool:
    """The table layout of a mesh: the argument, else
    BFC_TPU_SHARD_TABLE=1 (bfc_tpu's device_pipeline.py:334-335)."""
    if shard_table is None:
        return os.environ.get("BFC_TPU_SHARD_TABLE", "0") == "1"
    return bool(shard_table)


def run_device(opt: Opts, count_fn: str, correct_fn: Optional[str] = None,
               no_ec: bool = False, batch_reads: Optional[int] = None,
               count_batch_reads: int = 16384, sink=None,
               device=None, report: Optional[dict] = None,
               device_finalize: Optional[bool] = None,
               in_hash: Optional[str] = None, out_hash: Optional[str] = None,
               shard_table: Optional[bool] = None) -> str:
    """Count, then correct (or, with opt.filter_mode, trim); returns the
    output text (reference stdout).

    batch_reads: reads a correction batch (default CORRECT_BATCH) or a
    trim batch (default Trimmer's 8,192).  With `sink` (a binary
    file-like), records stream out as batches finish and the return
    value is "".  device: "cuda" (the default) or
    "cpu", which runs every kernel's plain version instead.
    device_finalize: finalize the counting aggregate on the card rather
    than the host (default: BFC_TPU_DEVICE_FINALIZE=1).  A `report` dict
    receives the phase wall times (each ending in a device synchronize),
    the finalize mode ("host" or "device") and which first-occurrence
    verdict ran, and counts: for correction the read and k-mer counts,
    the spectrum and the number of reads corrected by the scalar
    fallback; for trim the reads kept and dropped, the k-mers kept, the
    set bits of the Bloom filter and the filter itself.  Under -R
    (opt.refine_ec) it also holds `refine` (refine.RefineCounts: reads
    skipped, refined, reverted and failed, and host seconds of the tags,
    the bookkeeping and the emit) and device_s, the host seconds of KC
    and KD's steps.

    in_hash restores the spectrum from a bfc -r dump instead of
    counting (opt.k then becomes the dump's k); out_hash dumps it (-d).
    Trim mode ignores both, as bfc_tpu does.  The report's table is
    "sharded" or "replicated", beside its c_bits; dump_s is the -d
    write's wall, in neither phase.  On a card it also holds the device
    memory peaks of the counting (with -d) and of the correction alone
    (count_peak_bytes, correct_peak_bytes); the correction's starts from
    a reset of the peak.

    In a rank of a torch.distributed process group it runs the
    multi-device path (bfc_tpu's mesh_devices,
    device_pipeline.py:340-380): prefix-sharded counting, the distributed
    finalize on the devices (or, where a rank's counting tree spilled,
    rank 0's finalize of the gathered aggregate, on the host unless
    device_finalize says the card) and data-parallel correction, with
    rank 0 writing the output.  With shard_table (default:
    BFC_TPU_SHARD_TABLE=1) and a power-of-two number of ranks, each rank
    holds only its sub-table of a sharded table, which the others map
    (parallel/peer.py), unless no_ec; a restored spectrum is sharded the
    same way.  The report then also holds the world size, the backend,
    every rank's kernel launch counts, spills and rows spilled
    (spills_by_rank, spilled_rows_by_rank) and, with the sharded table,
    cb_local and each rank's sub-table entries, and the fallback count
    of all ranks; where a rank spilled, rank 0's gather_s, finalize_s
    and send_s, and `finalize` says where rank 0 finalized.  A sharded table is released when correction ends
    (peer.release): the report's spectrum then keeps its entries and
    histograms, not its sub-tables.  Trim mode ignores the mesh, as bfc_tpu does: rank 0
    trims on its device and the other ranks return."""
    dev = resolve_device(device)
    mesh = comm.active()
    if opt.filter_mode and mesh:
        if comm.rank() != 0:
            return ""
        mesh = False
    on = mesh or device_finalize_on(device_finalize)
    out = OutputWriter(sink)
    next_fn = correct_fn if correct_fn is not None else count_fn
    t0 = time.time()
    if opt.filter_mode:
        info = {} if report is not None else None
        bloom = count_file_filter_device(count_fn, opt, dev,
                                         batch_reads=count_batch_reads,
                                         info=info, device_finalize=on)
        _sync(dev)
        t1 = time.time()
        trimmer = Trimmer(opt, bloom)
        if batch_reads is None:
            trimmer.trim_file(next_fn, out)
        else:
            trimmer.trim_file(next_fn, out, batch_reads=batch_reads)
        _sync(dev)
        if report is not None:
            report.update(info, count_s=t1 - t0, trim_s=time.time() - t1,
                          reads_trimmed=trimmer.n_reads,
                          reads_kept=trimmer.n_kept,
                          reads_dropped=trimmer.n_reads - trimmer.n_kept,
                          n_set_bits=popcount(bloom.words), bloom=bloom)
    else:
        from ..parallel import mesh as pmesh

        sharded = mesh and shard_table_on(shard_table) and not no_ec
        if in_hash is not None:
            ds = (pmesh.restore_mesh(in_hash, dev, sharded) if mesh
                  else restore_spectrum(in_hash, dev))
            opt.k = ds.k
        elif mesh:
            R = comm.size()  # each rank takes an equal share of a batch
            ds = pmesh.count_file_mesh(
                count_fn, opt, dev,
                batch_reads=-(-count_batch_reads // R) * R,
                shard_table=sharded, device_finalize=device_finalize)
        else:
            ds = count_file_device(count_fn, opt, dev,
                                   batch_reads=count_batch_reads,
                                   device_finalize=on)
        _sync(dev)
        t1 = time.time()
        if out_hash is not None:
            if mesh:
                pmesh.dump_mesh(ds, out_hash)
            else:
                ds.dump(out_hash)
        t2 = time.time()
        if report is not None and dev.type == "cuda":
            # the counting's peak, then the correction's alone
            report["count_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        corr = None
        if not no_ec:
            corr = correct_file_device(
                next_fn, opt, ds, out, mesh=mesh,
                batch_reads=batch_reads or srch.CORRECT_BATCH)
            _sync(dev)
        sharded = isinstance(ds.table, ShardedTable)
        if sharded:
            peer.release(ds.table)
        n_fallback = corr.n_fallback if corr is not None else 0
        if report is not None:
            report.update(
                finalize="device" if on else "host", verdict=ds.verdict,
                count_s=t1 - t0, dump_s=t2 - t1, correct_s=time.time() - t2,
                n_reads=ds.n_reads, n_aggregated=ds.n_aggregated,
                n_kept=ds.n_entries, spectrum=ds, n_fallback=n_fallback,
                table="sharded" if sharded else "replicated",
                c_bits=ds.c_bits)
            report.update(ds.count_report)
            if dev.type == "cuda":
                report["correct_peak_bytes"] = torch.cuda.max_memory_allocated(
                    dev)
            if sharded:
                report.update(cb_local=ds.table.cb_local,
                              entries_by_rank=ds.entries_by_rank)
            if corr is not None and corr.refine_counts is not None:
                report.update(refine=dataclasses.asdict(corr.refine_counts),
                              device_s=corr.t_device)
        if mesh:
            _report_ranks(report, n_fallback)
    if sink is not None:
        out.flush()
        return ""
    return out.getvalue()


def _report_ranks(report: Optional[dict], n_fallback: int) -> None:
    """The mesh's part of the report, a collective: world size, backend,
    every rank's launch counts (in rank order) and the fallback reads of
    all ranks."""
    import json

    from .. import kernels

    mine = json.dumps({k.name: k.launches for k in kernels.KERNELS.values()})
    ranks = [json.loads(b.tobytes()) for b in comm.all_gather_bytes(
        np.frombuffer(mine.encode(), np.uint8))]
    total = int(comm.all_reduce(torch.tensor([n_fallback])))
    if report is not None:
        report.update(world_size=comm.size(), backend=comm.backend(),
                      launches_by_rank=ranks, n_fallback=total)
