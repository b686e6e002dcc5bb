"""End-to-end pipeline on the card: count -> correct (or trim) ->
formatted output.

Counterpart of bfc_tpu/models/device_pipeline.py, mirroring main() of the
reference CLI (bfc.c:126-150).  Reads stream through the corrector, or in
trim mode (-1) the trimmer, in batches and records are written in input
order (the reference's kt_pipeline ordering guarantee), through the
native formatter.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..io.fastq import Read, format_corrected, pack_stats
from ..opts import Opts
from ..utils.log import log
from .corrector import BatchResult, Corrector
from .counter import DeviceSpectrum, count_file_device, device_finalize_on
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
                        batch_reads: int = 8192) -> Corrector:
    from ..io import fast_reader as FR

    corr = Corrector(opt, ds)
    n_done = 0
    t_corr = t_emit = 0.0
    for rb in FR.iter_batches_prefetch(fn, batch_reads, max_bases=opt.chunk_size):
        if rb.n == 0:
            continue
        t0 = time.time()
        res = corr.correct_arrays(rb.bases, rb.quals, rb.lens, rb.has_qual(),
                                  lambda i, rb=rb: (rb.seq(i), rb.qual(i)))
        t1 = time.time()
        if not _emit_rb_native(rb, res, opt, out):
            _emit_rb_python(rb, res, opt, out)
        t_corr += t1 - t0
        t_emit += time.time() - t1
        n_done += rb.n
        log(f"processed {n_done} sequences", func="correct_file_device")
    log(f"correct {t_corr:.1f}s (device step {corr.t_device:.1f}s), "
        f"emit {t_emit:.1f}s", func="correct_file_device")
    return corr


def _emit_rb_native(rb, res: BatchResult, opt: Opts, out) -> bool:
    """Emit one batch's records via the native formatter
    (native/fastxio.c:fastx_format, the counterpart of the reference's
    output loop correct.c:596-611).  Returns False to fall back to the
    per-read Python path (slow-parser batches, scalar-fallback reads, no
    native library)."""
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
    lens = np.ascontiguousarray(res.lens, dtype=np.int32)
    name_off = np.ascontiguousarray(rb.name_off, dtype=np.int64)
    name_len = np.ascontiguousarray(rb.name_len, dtype=np.int32)
    seq_off = np.ascontiguousarray(rb.seq_off, dtype=np.int64)
    qual_off = np.ascontiguousarray(rb.qual_off, dtype=np.int64)
    seq_rows = np.ascontiguousarray(res.seq_rows)
    qual_rows = np.ascontiguousarray(res.qual_rows)
    aux = np.ascontiguousarray(res.aux)
    aux2 = np.ascontiguousarray(res.aux2)
    cap = int((name_len.astype(np.int64) + 2 * lens + 96).sum()) + 16
    buf = ctypes.create_string_buffer(cap)

    def p(arr, ct):
        return arr.ctypes.data_as(ctypes.POINTER(ct))

    ret = lib.fastx_format(
        rb.n, rb.buf,
        p(name_off, ctypes.c_int64), p(name_len, ctypes.c_int32),
        p(seq_off, ctypes.c_int64), p(qual_off, ctypes.c_int64),
        p(seq_rows, ctypes.c_ubyte), p(qual_rows, ctypes.c_ubyte),
        seq_rows.shape[1],
        p(lens, ctypes.c_int32),
        p(aux, ctypes.c_uint64), p(aux2, ctypes.c_uint64),
        p(mode, ctypes.c_ubyte),
        buf, cap,
    )
    if ret < 0:
        raise RuntimeError("fastx_format: output buffer too small")
    out.write_bytes(buf.raw[:ret])
    return True


def _emit_rb_python(rb, res: BatchResult, opt: Opts, out) -> None:
    """Per-read emit path (slow-parser batches and fallback reads)."""
    for i in range(rb.n):
        st, s2, q2 = res.tuple_of(i)
        r = Read(name=rb.name(i), comment=None, seq=s2, qual=q2)
        r.aux, r.aux2 = pack_stats(st)
        format_corrected(r, opt.no_qual, False, opt.discard, out)


def run_device(opt: Opts, count_fn: str, correct_fn: Optional[str] = None,
               no_ec: bool = False, batch_reads: int = 8192,
               count_batch_reads: int = 16384, sink=None,
               device=None, report: Optional[dict] = None,
               device_finalize: Optional[bool] = None) -> str:
    """Count, then correct (or, with opt.filter_mode, trim); returns the
    output text (reference stdout).

    With `sink` (a binary file-like), records stream out as batches
    finish and the return value is "".  device: "cuda" (the default) or
    "cpu", which runs every kernel's plain version instead.
    device_finalize: finalize the counting aggregate on the card rather
    than the host (default: BFC_TPU_DEVICE_FINALIZE=1).  A `report` dict
    receives the phase wall times (each ending in a device synchronize),
    the finalize mode ("host" or "device") and which first-occurrence
    verdict ran, and counts: for correction the read and k-mer counts,
    the spectrum and the number of reads corrected by the scalar
    fallback; for trim the reads kept and dropped, the k-mers kept, the
    set bits of the Bloom filter and the filter itself."""
    from ..io.writer import OutputWriter

    dev = resolve_device(device)
    on = device_finalize_on(device_finalize)
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
        trimmer.trim_file(next_fn, out, batch_reads=batch_reads)
        _sync(dev)
        if report is not None:
            report.update(info, count_s=t1 - t0, trim_s=time.time() - t1,
                          reads_trimmed=trimmer.n_reads,
                          reads_kept=trimmer.n_kept,
                          reads_dropped=trimmer.n_reads - trimmer.n_kept,
                          n_set_bits=popcount(bloom.words), bloom=bloom)
    else:
        ds = count_file_device(count_fn, opt, dev,
                               batch_reads=count_batch_reads,
                               device_finalize=on)
        _sync(dev)
        t1 = time.time()
        corr = None
        if not no_ec:
            corr = correct_file_device(next_fn, opt, ds, out,
                                       batch_reads=batch_reads)
            _sync(dev)
        if report is not None:
            report.update(
                finalize="device" if on else "host", verdict=ds.verdict,
                count_s=t1 - t0, correct_s=time.time() - t1,
                n_reads=ds.n_reads, n_aggregated=ds.n_aggregated,
                n_kept=ds.n_entries, spectrum=ds,
                n_fallback=corr.n_fallback if corr is not None else 0)
    if sink is not None:
        out.flush()
        return ""
    return out.getvalue()
