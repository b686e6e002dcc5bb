"""Smoke run of bfc_tpu_torch on one CUDA card: builds the twelve kernels,
drives the count + correct main path and the trim path (-1) at E. coli
scale, with the host finalize and with the device finalize, and holds
every kernel against its plain PyTorch version.

    python3 chip_smoke.py [--genome BASES] [--seed N]

Phases (any failure raises; nothing is caught):

1. The card's name and power limit (nvidia-smi), then the nvcc build of
   csrc/*.cu with each kernel's register and spill report.
2. The main path, as `python -m bfc_tpu_torch -s 5m reads.fq` runs it
   (k = 23, -b 30): run_device over a seeded synthetic genome of 5 Mb with
   10% repeats (bench.py's recipe), 60x coverage of 100 bp reads with 1%
   substitution errors on low qualities: 3,000,000 reads.  Every launch
   count is zeroed just before and read just after; each kernel must have
   launched.  The output must hold one record per input read, and 1,000
   seeded reads re-corrected by the scalar model (refmodel.ec1) on the
   same spectrum must give byte-identical records.
3. The counting against plain versions: the main path's counting tree is
   built again from the same reads with KB held against its plain
   version on every merge (up to the final fold of ~50M rows), and must
   fold to the main path's number of distinct k-mers; KE is held against
   its plain version on that fold, and the fold's pull is timed unpacked
   and packed (KE) in turns.  Then the card's count of the first 80,000
   reads (~9 batches) must equal a plain count of them on the CPU,
   aggregate field for field and finalized spectrum.
4. Each of KA-KD against its plain version on the same CUDA tensors at
   the main path's shapes (KA and KB: a 16,384-read counting batch of 128
   slots; KC and KD: an 8,192-read correction batch of 100 bp, KD's plain
   version on its first 512 reads) with the k = 23 spectrum of phase 2,
   then again at k = 33 on a spectrum of the first 200,000 reads.
5. The trim path, as `python -m bfc_tpu_torch -1 -k51 reads.fq` runs it
   (the default -b33, where the verdict is KF's): run_device over the same
   3,000,000 reads, launch counts zeroed just before and read just after;
   KA, KB, KE, KF, KG and KH must have launched.  1,000 seeded reads
   trimmed by the scalar model (refmodel.trim_read) over a copy of the
   card's Bloom words must give the output's records byte for byte,
   matched by name, and the dropped ones must be absent.
6. The trim kernels against their plain versions and the host: KF's
   verdicts on the whole trim aggregate against the exact 1-bit replay
   (spectrum_host.adjudicate_replay_np) and the sort formulation; KG on
   the aggregate's kept rows; KH on an 8,192-read trim batch.  Then the
   card's -1 -k51 count of the first 80,000 reads must give the plain
   CPU run's aggregate, keep set and Bloom bits.
7. The main path with the device finalize (device_finalize=True, as
   BFC_TPU_DEVICE_FINALIZE=1 selects it) on the same reads, counts zeroed
   just before and read just after: KA, KB, KJ, KF, KK, KL, KC and KD must
   have launched and KE must not.  The output must hash as phase 2's, the
   card-built table must give the host-built table's payload for every
   kept entry and its answer (-1 but for chance hits) for 1,000,000 seeded
   other keys, and the entries and histograms must be equal.
8. The trim path with the device finalize: KE must not launch, and the
   output must hash as phase 5's.  Then the same with arrivals numbered
   from 2^33 (AggBuilder.arrival_base), where the verdict is KI: KI must
   launch and KF not, and the output must hash as phase 5's; and the main
   path's count with arrivals from 2^33 and the device finalize, where KI
   must launch and the spectrum equal phase 2's.
9. The finalize kernels against their plain versions and the host: KI on
   the main fold (49.8M rows, -b30) and the trim fold (63.1M rows, -b33)
   against KF's verdicts, with arrivals from 0 and from 2^33, against its
   plain version on the trim fold and against the host's exact replay
   there; KJ and KK on the main fold; KL on the main fold's kept entries,
   compared by lookups with its plain version's table.

The tolerance is exact equality throughout: every output is an integer.
Kernel times are CUDA-event means over repeated launches after a warm-up.

The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or outside the
repository, the script exits non-zero before printing either.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from bfc_tpu_torch import cli, kernels
from bfc_tpu_torch.io.fastq import Read, format_corrected, pack_stats
from bfc_tpu_torch.io.writer import OutputWriter
from bfc_tpu_torch.models import counter as C
from bfc_tpu_torch.models import device_pipeline as DP
from bfc_tpu_torch.models import refmodel as M
from bfc_tpu_torch.models import trimmer as TT
from bfc_tpu_torch.ops import annotate as ann
from bfc_tpu_torch.ops import kmer as kops
from bfc_tpu_torch.ops import search as srch
from bfc_tpu_torch.ops import spectrum as spec
from bfc_tpu_torch.ops import spectrum_dense as sdn
from bfc_tpu_torch.ops import spectrum_host as sph
from bfc_tpu_torch.ops.spectrum import IntProbe
from bfc_tpu_torch.opts import Opts

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# HBM3 at 3.35 TB/s.  The 32-bit integer pipe has 64 lanes per SM, one op
# each a clock: 64 x 132 SMs x 1.98 GHz boost = 16.7e12 ops/s (half the
# 67 TFLOP/s fp32 figure, which counts an FMA as two flops on 128 lanes).
# A u64 add, shift or logic op counts as two 32-bit integer ops.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
SECTOR = 32  # bytes of one random device-memory access
# 32-bit integer ops per unit of work, counted from the kernels' source:
# one canonical hash + shard split ~60 u64 ops; a probe adds ~20 more.
OPS_KMER = 2 * 60
OPS_PROBE = 2 * 80
OPS_KB_ROW = 2 * 8
# Bloom addressing of one row (csrc/bloom.cuh): ~20 u64 ops for the block,
# offsets and stride plus ~4 a probed bit; one row's bits share one
# 64-byte block, counted as one random access of two sectors.
OPS_BLOOM = 2 * (20 + 4 * 4)
BLOCK = 2 * SECTOR
OPS_KE_ROW = 2 * 8
OPS_KJ_ROW = 2 * 15   # the identity inverted and ret rebuilt
OPS_KK_ROW = 2 * 10   # the payload rule and two bin increments

COUNT_B, COUNT_L = 16384, 128   # run_device's counting batch (padded to 32)
CORR_B = 8192                   # run_device's correction batch
KD_PLAIN_READS = 512
SAMPLE_READS = 1000
HEAD_READS = 80_000             # ~9 counting batches for the plain count
TRIM_K = 51                     # README's trim command: -1 -k51 (-b33)
TRIM_B, TRIM_L = 8192, 128      # Trimmer.trim_file's batch (L padded to 32)
ABSENT_KEYS = 1_000_000         # seeded keys probed in both tables
FAR = 1 << 33                   # arrivals from here take the KI verdict


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


# --------------------------------------------------------------------------
# Seeded synthetic reads (bench.py's genome recipe), written with numpy
# --------------------------------------------------------------------------

def make_reads(glen: int, seed: int, cov: int = 60, rlen: int = 100):
    """Seeded genome with 10% repeats and its reads: (bases u8 codes
    [n, rlen], quals u8 ASCII [n, rlen])."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, glen).astype(np.uint8)
    seg = 2000
    for _ in range(int(glen * 0.1) // seg):
        src = int(rng.integers(0, glen - seg))
        dst = int(rng.integers(0, glen - seg))
        g[dst:dst + seg] = g[src:src + seg]
    n = glen * cov // rlen
    bases = np.empty((n, rlen), np.uint8)
    quals = np.empty((n, rlen), np.uint8)
    step = 250_000
    for a in range(0, n, step):
        m = min(step, n - a)
        starts = rng.integers(0, glen - rlen, m)
        mat = g[starts[:, None] + np.arange(rlen)[None, :]]
        rc = rng.random(m) < 0.5
        mat[rc] = 3 - mat[rc, ::-1]
        err = rng.random((m, rlen)) < 0.01
        bases[a:a + m] = np.where(
            err, (mat + rng.integers(1, 4, mat.shape)) % 4, mat)
        quals[a:a + m] = np.where(err, 35 + rng.integers(0, 13, mat.shape),
                                  63 + rng.integers(0, 10, mat.shape))
    return bases, quals


def write_fastq(path: Path, bases: np.ndarray, quals: np.ndarray,
                first: int = 0) -> None:
    """Fixed-width records @r%08d / seq / + / qual, built as one byte
    matrix per chunk."""
    n, rlen = bases.shape
    acgt = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for a in range(0, n, 250_000):
            m = min(250_000, n - a)
            ids = np.arange(first + a, first + a + m)
            digits = (ids[:, None] // 10 ** np.arange(7, -1, -1)) % 10
            rec = np.concatenate([
                np.full((m, 2), [ord("@"), ord("r")], np.uint8),
                (48 + digits).astype(np.uint8),
                np.full((m, 1), 10, np.uint8),
                acgt[bases[a:a + m]],
                np.full((m, 3), [10, ord("+"), 10], np.uint8),
                quals[a:a + m],
                np.full((m, 1), 10, np.uint8)], axis=1)
            rec.tofile(f)


# --------------------------------------------------------------------------
# Timing and comparison helpers
# --------------------------------------------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over reps runs, after one."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def compare(got, want):
    """(max absolute difference, number of differing elements) over
    matching output tensors; a shape mismatch counts as (inf, -1)."""
    worst, n_diff = 0.0, 0
    for g, w in zip(got, want):
        if g is None and w is None:
            continue
        if g is None or w is None or g.shape != w.shape:
            return float("inf"), -1
        ne = g != w
        if bool(ne.any()):
            n_diff += int(ne.sum())
            d = float((g[ne].double() - w[ne].double()).abs().max())
            worst = max(worst, d, 1.0)
    return worst, n_diff


def bound(bytes_moved: float, int_ops: float):
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_o = int_ops / INT32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def count_batch(bases, quals, opt, dev):
    """The first COUNT_B reads as count_batches_aggregate pads them."""
    b = np.full((COUNT_B, COUNT_L), 4, np.uint8)
    q = np.zeros((COUNT_B, COUNT_L), bool)
    rlen = bases.shape[1]
    b[:, :rlen] = bases[:COUNT_B]
    q[:, :rlen] = quals[:COUNT_B].astype(np.int32) - 33 >= opt.q
    lens = np.full((COUNT_B,), rlen, np.int32)
    return (torch.from_numpy(b).to(dev), torch.from_numpy(q).to(dev),
            torch.from_numpy(lens).to(dev))


def corr_batch(bases, quals, opt, dev, first: int):
    """CORR_B reads as Corrector.device_step hands them to KC and KD."""
    b = bases[first:first + CORR_B]
    q = (quals[first:first + CORR_B].astype(np.int32) - 33 >= opt.q) & (b <= 3)
    lens = np.full((len(b),), b.shape[1], np.int32)
    return (torch.from_numpy(np.ascontiguousarray(b)).to(dev),
            torch.from_numpy(q).to(dev), torch.from_numpy(lens).to(dev))


# --------------------------------------------------------------------------
# Kernel checks
# --------------------------------------------------------------------------

def check_kernels(opt, ds, bases, quals, dev, timed: bool):
    """Each kernel against its plain version at the main path's shapes.
    Returns {name: {max_abs_err, and when timed: ms, plain_ms, bound}}."""
    k, l_pre = opt.k, opt.effective_l_pre()
    carry = not sdn.ret_derivable(k, l_pre)
    res = {}

    # KA: one counting batch; ret checked too, timed as the main path runs
    cb, cq, cl = count_batch(bases, quals, opt, dev)
    ka = kops.kmer_stream(cb, cq, cl, k, l_pre, 0, with_ret=True)
    ka_p = kops.kmer_stream_plain(cb, cq, cl, k, l_pre, 0, True)
    r = dict(zip(("max_abs_err", "mismatches"), compare(ka, ka_p)))
    if timed:
        slots = COUNT_B * COUNT_L
        valid = int((ka[0] != kops.INVALID_SHARD).sum())
        r["ms"] = cuda_ms(lambda: kops.kmer_stream(
            cb, cq, cl, k, l_pre, 0, with_ret=carry), 20)
        r["plain_ms"] = cuda_ms(lambda: kops.kmer_stream_plain(
            cb, cq, cl, k, l_pre, 0, carry), 2)
        r["bound"] = bound(slots * 2 + COUNT_B * 4
                           + slots * 8 * (4 if carry else 3),
                           valid * OPS_KMER)
    res["kmer_stream"] = r

    # KB: the sorted run of that batch
    shard, keybody, arrp, ret = ka
    shard, keybody, arrp = shard.view(-1), keybody.view(-1), arrp.view(-1)
    perm = sdn.stable_order(shard, keybody)
    arrp = arrp[perm]
    high = arrp & 1
    srt = sdn.Run(shard[perm], keybody[perm], arrp >> 1, torch.ones_like(high),
                  high, high.to(torch.uint8),
                  ret.view(-1)[perm] if carry else None)
    kb = sdn.run_combine(srt)
    kb_p = sdn.run_combine_plain(srt)
    r = dict(zip(("max_abs_err", "mismatches"), compare(kb, kb_p)))
    if timed:
        N, Cn = len(srt), len(kb)
        row = 8 * (6 if carry else 5) + 1
        r["ms"] = cuda_ms(lambda: sdn.run_combine(srt), 20)
        r["plain_ms"] = cuda_ms(lambda: sdn.run_combine_plain(srt), 3)
        r["bound"] = bound((N + Cn) * row, N * OPS_KB_ROW)
    res["run_combine"] = r

    # KC and KD: one correction batch of reads after the counting batch
    t = ds.table
    b, q, lens = corr_batch(bases, quals, opt, dev, COUNT_B)
    kc = ann.kcov_island(t, b, lens, opt.min_cov)
    kc_p = ann.kcov_island_plain(t, b, lens, opt.min_cov)
    r = dict(zip(("max_abs_err", "mismatches"), compare(kc, kc_p)))
    B, L = b.shape
    if timed:
        # one probe at every slot where a full ACGT k-mer ends
        probes = int((kops.kmer_stream_plain(b, q, lens, k, l_pre)[0]
                      != kops.INVALID_SHARD).sum())
        r["ms"] = cuda_ms(lambda: ann.kcov_island(t, b, lens, opt.min_cov), 20)
        r["plain_ms"] = cuda_ms(
            lambda: ann.kcov_island_plain(t, b, lens, opt.min_cov), 2)
        r["bound"] = bound(B * L * 7 + B * 16 + probes * 2 * SECTOR,
                           probes * OPS_PROBE)
    res["kcov_island"] = r

    _, lcov, hcov, isl = kc
    kd = srch.ec1_search(t, opt, ds.mode, b, q, lens, lcov, hcov, isl)
    n = KD_PLAIN_READS
    torch.cuda.synchronize()
    t0 = time.time()
    kd_p = srch.ec1_search_plain(t, opt, ds.mode, b[:n], q[:n], lens[:n],
                                 lcov[:n], hcov[:n], isl[:n])
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    r = dict(zip(("max_abs_err", "mismatches"),
                 compare([x[:n] for x in kd], kd_p)))
    r["overflow"] = int(kd[1][:, srch.OVERFLOW].sum())
    if timed:
        probes = int(kd[1][:, srch.PROBES].sum())
        r["ms"] = cuda_ms(lambda: srch.ec1_search(
            t, opt, ds.mode, b, q, lens, lcov, hcov, isl), 3)
        r["plain_ms"] = plain_s * 1e3
        r["plain_reads"] = n
        r["bound"] = bound(B * L * 5 + B * (16 + 4 * srch.N_OUT)
                           + probes * 2 * SECTOR, probes * OPS_PROBE)
    res["ec1_search"] = r
    return res


# --------------------------------------------------------------------------
# Counting checks
# --------------------------------------------------------------------------

class CheckedAgg(C.AggBuilder):
    """AggBuilder that holds KB against its plain version, on the card, on
    the sorted [older, newer] input of every merge of its tree."""

    def __init__(self, opt, device):
        super().__init__(opt, device)
        self.merges = self.max_rows = self.mismatches = 0
        self.max_abs_err = 0.0

    def _merge(self, a, b):
        srt = sdn.concat_sorted(a, b)
        got = sdn.run_combine(srt)
        err, n_diff = compare(got, sdn.run_combine_plain(srt))
        self.merges += 1
        self.max_rows = max(self.max_rows, len(srt))
        self.mismatches += n_diff if n_diff >= 0 else len(srt)
        self.max_abs_err = max(self.max_abs_err, err)
        return got


def check_merges(fq: Path, opt, dev, n_aggregated: int) -> CheckedAgg:
    """The main path's counting tree again over the same reads, with every
    merge (n > 1, key groups spanning runs, up to the final fold) held
    against the plain combine; the fold (kept as .folded) must hold the
    main path's number of distinct k-mers."""
    agg = CheckedAgg(opt, dev)
    for bases, qok, lens, _ in C.padded_batches(str(fq), opt, COUNT_B):
        agg.add(bases, qok, lens)
    agg.folded = agg.fold()
    rows = len(agg.folded)
    if agg.mismatches:
        fail(f"KB disagrees with its plain version on {agg.mismatches} merged "
             "rows")
    if rows != n_aggregated:
        fail(f"the checked tree folds to {rows} k-mers, the main path to "
             f"{n_aggregated}")
    return agg


def check_head_count(fq: Path, opt, dev):
    """The card's count of the first HEAD_READS reads against a plain
    count of them (every kernel's plain version, on the CPU): the
    aggregate field for field, then the finalized spectrum's entries and
    histograms.  Returns (distinct k-mers aggregated, kept)."""
    got, n_got = C.count_batches_aggregate(str(fq), opt, dev, COUNT_B)
    want, n_want = C.count_batches_aggregate(str(fq), opt, "cpu", COUNT_B)
    for f in ("shard", "keybody", "ret", "n", "n_high", "first_arr",
              "first_high"):
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            fail(f"head count: aggregate field {f} differs from the plain "
                 "count")
    ds_g = C.finalize_spectrum(got, opt, dev)
    ds_w = C.finalize_spectrum(want, opt, "cpu")
    same = (n_got == n_want and ds_g.mode == ds_w.mode
            and np.array_equal(ds_g.hist, ds_w.hist)
            and np.array_equal(ds_g.hist_high, ds_w.hist_high)
            and all(np.array_equal(a, b) for a, b in
                    zip(ds_g.compact_entries(), ds_w.compact_entries())))
    if not same:
        fail("head count: the finalized spectrum differs from the plain count")
    return len(got.shard), ds_g.n_entries


def drive(opt, fq: Path, out: Path, device_finalize: bool = False):
    """One run of run_device over fq into out, with every launch count
    zeroed just before and read just after.  Returns (report, launches,
    device memory peak in bytes)."""
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    report = {}
    with open(out, "wb") as sink:
        DP.run_device(opt, str(fq), sink=sink, device="cuda", report=report,
                      device_finalize=device_finalize)
    launches = {k.name: k.launches for k in kernels.KERNELS.values()}
    return report, launches, torch.cuda.max_memory_allocated()


def file_hash(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


@contextlib.contextmanager
def arrivals_from(base: int):
    """Every AggBuilder numbers its stream's slots from base."""
    init = C.AggBuilder.__init__

    def shifted(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.arrival_base = base

    C.AggBuilder.__init__ = shifted
    try:
        yield
    finally:
        C.AggBuilder.__init__ = init


def need_silent(launches, names, path: str) -> None:
    for name in names:
        if launches[name] != 0:
            fail(f"kernel {name} launched {launches[name]} times on {path}")


def need_launched(launches, names, path: str) -> None:
    for name in names:
        if launches[name] == 0:
            fail(f"kernel {name} never launched on {path}")


def check_pack_pull(run):
    """KE against its plain version on the main path's final fold; the
    fold's pull to the host (host clock, synchronized) unpacked, packed,
    packed, unpacked."""
    rows = len(run)
    r = dict(zip(("max_abs_err", "mismatches"),
                 compare(sdn.pack_pull(run), sdn.pack_pull_plain(run))))
    r["ms"] = cuda_ms(lambda: sdn.pack_pull(run), 10)
    r["plain_ms"] = cuda_ms(lambda: sdn.pack_pull_plain(run), 3)
    r["bound"] = bound(rows * (3 * 8 + 1 + 2 * 4), rows * OPS_KE_ROW)
    walls = {"unpacked": [], "packed": []}
    for kind in ("unpacked", "packed", "packed", "unpacked"):
        torch.cuda.synchronize()
        t0 = time.time()
        C.pull_columns(run if kind == "unpacked" else sdn.pack_pull(run))
        walls[kind].append(time.time() - t0)
    r["pull_s"] = walls
    r["rows"] = rows
    return r


def small_spectrum(fq: Path, k: int, dev):
    opt = Opts()
    opt.k = k
    opt.bf_shift = 30
    agg, _ = C.count_batches_aggregate(str(fq), opt, dev, batch_reads=COUNT_B)
    return opt, C.finalize_spectrum(agg, opt, dev)


# --------------------------------------------------------------------------
# Output checks
# --------------------------------------------------------------------------

def check_output(out_fq: Path, n_reads: int, bases, quals, opt, ds, seed):
    """Record count, then SAMPLE_READS reads re-corrected by refmodel.ec1
    on the same table, formatted as the emit formats them."""
    lines = out_fq.read_bytes().split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    if len(lines) != 4 * n_reads:
        fail(f"{len(lines) // 4} records out for {n_reads} reads in")
    probe = IntProbe(ds.table)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    idx = np.sort(np.random.default_rng(seed + 1).choice(
        n_reads, SAMPLE_READS, replace=False))
    differ = 0
    n_corrected = 0
    for i in idx:
        seq = acgt[bases[i]].tobytes().decode()
        qual = quals[i].tobytes().decode()
        st, s2, q2 = M.ec1(opt, probe, ds.mode, seq, qual)
        r = Read(name=f"r{i:08d}", comment=None, seq=s2, qual=q2)
        r.aux, r.aux2 = pack_stats(st)
        w = OutputWriter()
        format_corrected(r, opt.no_qual, False, opt.discard, w)
        want = w.getbytes().split(b"\n")[:4]
        differ += want != lines[4 * i:4 * i + 4]
        n_corrected += st.n_ec > 0
    if differ:
        fail(f"{differ} of {SAMPLE_READS} sampled records differ from "
             "refmodel.ec1")
    return n_corrected


def check_trim_output(out_fq: Path, n_reads: int, bases, quals, opt, bloom,
                      seed):
    """SAMPLE_READS reads trimmed by refmodel.trim_read over a host copy
    of the card's Bloom words: a kept read's record must be in the output
    byte for byte, a dropped read must be absent.  Returns (records out,
    sampled reads kept)."""
    lines = out_fq.read_bytes().split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    if len(lines) % 4:
        fail(f"trim output has {len(lines)} lines, not whole FASTQ records")
    where = {lines[j][1:]: j for j in range(0, len(lines), 4)}
    probe = TT.WordsProbe(bloom)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    idx = np.sort(np.random.default_rng(seed + 2).choice(
        n_reads, SAMPLE_READS, replace=False))
    differ = kept = 0
    for i in idx:
        seq = acgt[bases[i]].tobytes().decode()
        qual = quals[i].tobytes().decode()
        keep, s2, q2 = M.trim_read(opt, probe, seq, qual)
        j = where.get(b"r%08d" % i)
        if keep:
            kept += 1
            want = [b"@r%08d" % i, s2.encode(), b"+", q2.encode()]
            differ += j is None or lines[j:j + 4] != want
        else:
            differ += j is not None
    if differ:
        fail(f"{differ} of {SAMPLE_READS} sampled reads trim otherwise than "
             "refmodel.trim_read")
    return len(lines) // 4, kept


def check_trim_kernels(agg, keep_path, bloom, opt, bases, dev):
    """KF, KG and KH against their plain versions on the card at the trim
    path's shapes, and KF's verdicts against the host's exact replay.
    Returns {name: result}."""
    b, H = opt.bf_shift, opt.n_hashes
    rows = len(agg.ret)
    ret = torch.from_numpy(agg.ret.view(np.int64)).to(dev)
    arr = torch.from_numpy(
        agg.first_arr.astype(np.uint32).view(np.int32)).to(dev)
    n = torch.from_numpy(np.minimum(agg.n, 0x7FFFFFFF).astype(np.int32)).to(dev)
    res = {}

    fp, keep = spec.adjudicate_sketch(ret, arr, n, b, H)
    if not torch.equal(keep, keep_path):
        fail("KF's keep flags differ from the trim path's")
    replay = sph.adjudicate_replay_np(agg.ret, agg.first_arr,
                                      np.ones(rows, bool), b, H)
    if replay is None:
        fail("the native replay library did not load")
    n_replay = int((fp.cpu().numpy() != replay).sum())
    if n_replay:
        fail(f"KF's verdicts differ from the host replay on {n_replay} rows")
    r = {"replay_mismatches": n_replay, "fp": int(fp.sum()),
         "kept": int(keep.sum()), "rows": rows}
    r["ms"] = cuda_ms(lambda: spec.adjudicate_sketch(ret, arr, n, b, H), 3)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.time()
    want = spec.adjudicate_sketch_plain(ret, arr, n, b, H)
    torch.cuda.synchronize()
    r["plain_ms"] = (time.time() - t0) * 1e3
    r.update(zip(("max_abs_err", "mismatches"), compare((fp, keep), want)))
    del want
    torch.cuda.empty_cache()
    r["bound"] = bound((4 << b) + rows * (8 + 4 + 4 + 2) + 2 * rows * BLOCK,
                       2 * rows * OPS_BLOOM)
    res["bloom_adjudicate"] = r

    words = TT.bloom_build(ret, keep, b, H)
    kept = r["kept"]
    r = dict(zip(("max_abs_err", "mismatches"), compare(
        (words, words), (bloom.words, TT.bloom_build_plain(ret, keep, b, H)))))
    r["ms"] = cuda_ms(lambda: TT.bloom_build(ret, keep, b, H), 5)
    r["plain_ms"] = cuda_ms(lambda: TT.bloom_build_plain(ret, keep, b, H), 1)
    r["bound"] = bound((1 << (b - 3)) + rows * 9 + kept * BLOCK,
                       kept * OPS_BLOOM)
    res["bloom_build"] = r
    del ret, arr, n, fp, keep, words
    torch.cuda.empty_cache()

    tb = np.full((TRIM_B, TRIM_L), 4, np.uint8)
    tb[:, :bases.shape[1]] = bases[:TRIM_B]
    tb = torch.from_numpy(tb).to(dev)
    lens = torch.full((TRIM_B,), bases.shape[1], dtype=torch.int32, device=dev)
    args = (bloom.words, tb, lens, opt.k, b, H)
    r = dict(zip(("max_abs_err", "mismatches"), compare(
        (TT.max_streak_batch(*args),), (TT.max_streak_plain(*args),))))
    probes = TRIM_B * max(bases.shape[1] - opt.k + 1, 0)
    r["ms"] = cuda_ms(lambda: TT.max_streak_batch(*args), 20)
    r["plain_ms"] = cuda_ms(lambda: TT.max_streak_plain(*args), 2)
    r["bound"] = bound(TRIM_B * (TRIM_L + 4 + 8) + probes * BLOCK,
                       probes * (OPS_KMER + OPS_BLOOM))
    res["max_streak"] = r
    return res


def check_trim_head(fq: Path, opt, dev):
    """The card's -1 count of the first HEAD_READS reads against a plain
    run on the CPU: aggregate, keep set and Bloom bits.  Returns
    (distinct k-mers, kept, set bits)."""
    got, want = {}, {}
    bg = TT.count_file_filter_device(str(fq), opt, dev, COUNT_B, info=got)
    bw = TT.count_file_filter_device(str(fq), opt, "cpu", COUNT_B, info=want)
    if got["verdict"] != "KF" or want["verdict"] != "KF":
        fail(f"trim head count: verdicts {got['verdict']}, {want['verdict']}")
    for f in ("shard", "keybody", "ret", "n", "n_high", "first_arr",
              "first_high"):
        if not np.array_equal(getattr(got["aggregate"], f),
                              getattr(want["aggregate"], f)):
            fail(f"trim head count: aggregate field {f} differs")
    if not torch.equal(got["keep"].cpu(), want["keep"]):
        fail("trim head count: the keep set differs from the plain run")
    if not torch.equal(bg.words.cpu(), bw.words):
        fail("trim head count: the Bloom bits differ from the plain run")
    return got["n_aggregated"], got["n_kept"], TT.popcount(bw.words)


def same_spectrum(got, want) -> bool:
    return (got.n_entries == want.n_entries and got.mode == want.mode
            and np.array_equal(got.hist, want.hist)
            and np.array_equal(got.hist_high, want.hist_high)
            and all(np.array_equal(a, b) for a, b in
                    zip(got.compact_entries(), want.compact_entries())))


def lookup(t, shard, keybody):
    """Payloads (-1 absent) of int64 (shard, keybody) queries on the card,
    in chunks."""
    step = 1 << 24
    return torch.cat([spec.cuckoo_lookup_plain(t, shard[a:a + step],
                                               keybody[a:a + step])
                      for a in range(0, shard.shape[0], step)])


def check_device_table(dds, hds, dev, seed):
    """The card-built spectrum against the host-built one: entries,
    histograms and mode, then both tables probed with every kept entry and
    ABSENT_KEYS seeded other keys.  Returns (entries, absent keys)."""
    if not same_spectrum(dds, hds):
        fail("the device finalize's entries or histograms differ from the "
             "host finalize's")
    shard, keybody, payload = hds.compact_entries()
    s = torch.from_numpy(shard.astype(np.int64)).to(dev)
    kb = torch.from_numpy(keybody.view(np.int64)).to(dev)
    got = lookup(dds.table, s, kb)
    if not torch.equal(got, torch.from_numpy(payload.astype(np.int64)).to(dev)):
        fail("the card-built table misses kept entries")
    rng = np.random.default_rng(seed + 3)
    t = hds.table
    qs = torch.from_numpy(rng.integers(0, 1 << t.l_pre, ABSENT_KEYS)).to(dev)
    qk = torch.from_numpy(rng.integers(0, 1 << t.kb_bits, ABSENT_KEYS)).to(dev)
    want = lookup(t, qs, qk)
    if not torch.equal(lookup(dds.table, qs, qk), want):
        fail("the card-built and host-built tables answer other keys "
             "differently")
    return len(shard), int((want == -1).sum())


def check_finalize_kernels(main_fold, trim_fold, opt, topt, dev):
    """KI, KJ, KK and KL against their plain versions (and KI against KF
    and the host replay) at the folds' shapes.  Returns {name: result}."""
    k, l_pre = opt.k, opt.effective_l_pre()
    H = opt.n_hashes
    res = {}

    # KJ: the main fold's ret, which the run does not carry at k = 23
    rows = len(main_fold)
    s, kb = main_fold.shard, main_fold.keybody
    ret = sdn.derive_ret(s, kb, k, l_pre)
    r = dict(zip(("max_abs_err", "mismatches"),
                 compare((ret,), (sdn.derive_ret_plain(s, kb, k, l_pre),))))
    r["ms"] = cuda_ms(lambda: sdn.derive_ret(s, kb, k, l_pre), 10)
    r["plain_ms"] = cuda_ms(lambda: sdn.derive_ret_plain(s, kb, k, l_pre), 3)
    r["bound"] = bound(rows * 24, rows * OPS_KJ_ROW)
    r["rows"] = rows
    res["derive_ret"] = r

    # KI on both folds against KF, from 0 and from 2^33
    ki = {"mismatches": 0, "max_abs_err": 0.0}
    for fold, o, r_fold in ((main_fold, opt, ret), (trim_fold, topt, None)):
        b = o.bf_shift
        ret_f = fold.ret if r_fold is None else r_fold
        n32 = fold.n.clamp(max=0x7FFFFFFF).to(torch.int32)
        kf, _ = spec.adjudicate_sketch(ret_f, sdn.as_i32(fold.arr), n32, b, H)
        torch.cuda.empty_cache()
        for shift in (0, FAR):
            got = spec.adjudicate_first_occurrence(ret_f, fold.arr + shift, b,
                                                   H)
            err, n_diff = compare((got,), (kf,))
            ki["mismatches"] += n_diff
            ki["max_abs_err"] = max(ki["max_abs_err"], err)
        ki[f"fp_b{b}"] = int(kf.sum())
        ki[f"ms_b{b}"] = cuda_ms(lambda: spec.adjudicate_first_occurrence(
            ret_f, fold.arr, b, H), 3)
        ki[f"rows_b{b}"] = len(fold)
        del kf, got
    # the trim fold: KI's plain version and the host's exact replay
    b = topt.bf_shift
    tr, ta = trim_fold.ret, trim_fold.arr
    got = spec.adjudicate_first_occurrence(tr, ta, b, H)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.time()
    want = spec.adjudicate_first_occurrence_plain(tr, ta, b, H)
    torch.cuda.synchronize()
    ki["plain_ms"] = (time.time() - t0) * 1e3
    err, n_diff = compare((got,), (want,))
    ki["mismatches"] += n_diff
    ki["max_abs_err"] = max(ki["max_abs_err"], err)
    del want
    torch.cuda.empty_cache()
    replay = sph.adjudicate_replay_np(
        tr.cpu().numpy().view(np.uint64), ta.cpu().numpy().view(np.uint64),
        np.ones(len(trim_fold), bool), b, H)
    if replay is None:
        fail("the native replay library did not load")
    ki["replay_mismatches"] = int((got.cpu().numpy() != replay).sum())
    ki["mismatches"] += ki["replay_mismatches"]
    trows = len(trim_fold)
    ki["ms"] = ki[f"ms_b{b}"]
    ki["bound"] = bound(trows * (8 + 8 + 1), trows * OPS_BLOOM)
    res["first_occurrence"] = ki
    del got

    # KK on the main fold with KI's verdicts
    fp = spec.adjudicate_first_occurrence(ret, main_fold.arr, opt.bf_shift, H)
    cols = (main_fold.n, main_fold.n_high, main_fold.first_high, fp)
    kk = spec.finalize_counts(*cols)
    r = dict(zip(("max_abs_err", "mismatches"),
                 compare(kk, spec.finalize_counts_plain(*cols))))
    r["ms"] = cuda_ms(lambda: spec.finalize_counts(*cols), 10)
    r["plain_ms"] = cuda_ms(lambda: spec.finalize_counts_plain(*cols), 3)
    r["bound"] = bound(rows * 23, rows * OPS_KK_ROW)
    r["rows"] = rows
    res["finalize_counts"] = r

    # KL on the kept entries, compared by lookups of every fold row
    payload, keep = kk[:2]
    ks, kkb, kp = s[keep], kb[keep], payload[keep]
    n = ks.shape[0]
    kb_bits = kops.keybody_bits(k, l_pre)
    c_bits = C.table_c_bits(n, k, l_pre, opt.predicted_c_bits())
    table, ok = spec.cuckoo_build(ks, kkb, kp, k, l_pre, kb_bits, c_bits)
    torch.cuda.synchronize()
    t0 = time.time()
    plain, pok = spec.cuckoo_build_plain(ks, kkb, kp, k, l_pre, kb_bits,
                                         c_bits)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    want = torch.where(keep, payload, -1).to(torch.int64)
    r = {"max_abs_err": 0.0, "mismatches": 0}
    for tab in (table, plain):
        got = lookup(spec.SpecTable(tab, k, l_pre, kb_bits, c_bits), s, kb)
        err, n_diff = compare((got,), (want,))
        r["mismatches"] += n_diff
        r["max_abs_err"] = max(r["max_abs_err"], err)
    if not (ok and pok):
        fail(f"cuckoo placement failed at c_bits {c_bits} (KL {ok}, plain "
             f"{pok})")
    r["ms"] = cuda_ms(lambda: spec.cuckoo_build(ks, kkb, kp, k, l_pre,
                                                kb_bits, c_bits), 5)
    r["plain_ms"] = plain_ms
    r["bound"] = bound(n * (8 + 8 + 4 + SECTOR) + (8 << c_bits),
                       n * OPS_PROBE)
    r["rows"], r["c_bits"] = n, c_bits
    res["cuckoo_build"] = r
    return res


# --------------------------------------------------------------------------

SOURCES = {
    "kmer_stream": ("KA", "bfc_tpu_torch/csrc/kmer_stream.cu",
                    "bfc_tpu/ops/kmer.py:199"),
    "run_combine": ("KB", "bfc_tpu_torch/csrc/run_combine.cu",
                    "bfc_tpu/ops/spectrum_dense.py:103"),
    "kcov_island": ("KC", "bfc_tpu_torch/csrc/kcov_island.cu",
                    "bfc_tpu/ops/annotate.py:67"),
    "ec1_search": ("KD", "bfc_tpu_torch/csrc/ec1_search.cu",
                   "bfc_tpu/ops/search.py:436"),
    "pack_pull": ("KE", "bfc_tpu_torch/csrc/pack_pull.cu",
                  "bfc_tpu/ops/spectrum_dense.py:233"),
    "bloom_adjudicate": ("KF", "bfc_tpu_torch/csrc/bloom_adjudicate.cu",
                         "bfc_tpu/ops/spectrum.py:843"),
    "bloom_build": ("KG", "bfc_tpu_torch/csrc/bloom_build.cu",
                    "bfc_tpu/models/trimmer.py:49"),
    "max_streak": ("KH", "bfc_tpu_torch/csrc/max_streak.cu",
                   "bfc_tpu/models/trimmer.py:136"),
    "first_occurrence": ("KI", "bfc_tpu_torch/csrc/first_occurrence.cu",
                         "bfc_tpu/ops/spectrum.py:217"),
    "derive_ret": ("KJ", "bfc_tpu_torch/csrc/derive_ret.cu",
                   "bfc_tpu/ops/spectrum_dense.py:312"),
    "finalize_counts": ("KK", "bfc_tpu_torch/csrc/finalize_counts.cu",
                        "bfc_tpu/ops/spectrum.py:868"),
    "cuckoo_build": ("KL", "bfc_tpu_torch/csrc/cuckoo_build.cu",
                     "bfc_tpu/ops/spectrum.py:543"),
}
MAIN_KERNELS = ("kmer_stream", "run_combine", "pack_pull", "kcov_island",
                "ec1_search")
TRIM_KERNELS = ("kmer_stream", "run_combine", "pack_pull",
                "bloom_adjudicate", "bloom_build", "max_streak")
MAIN_DEVICE_KERNELS = ("kmer_stream", "run_combine", "derive_ret",
                       "bloom_adjudicate", "finalize_counts", "cuckoo_build",
                       "kcov_island", "ec1_search")
TRIM_DEVICE_KERNELS = ("kmer_stream", "run_combine", "bloom_adjudicate",
                       "bloom_build", "max_streak")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome", type=int, default=5_000_000,
                    help="synthetic genome length in bases [5,000,000]")
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)

    build_s = kernels.build_all()
    print(f"kernel build: {build_s:.1f} s", flush=True)
    for k in kernels.KERNELS.values():
        rep = (kernels.BUILD / f"{k.name}.ptxas.txt").read_text()
        for ln in rep.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  {k.name}: {ln.strip()}")

    tmp = Path(tempfile.mkdtemp(prefix="bfc_chip_smoke_"))
    try:
        t0 = time.time()
        bases, quals = make_reads(args.genome, args.seed)
        n_reads = len(bases)
        fq = tmp / "reads.fq"
        write_fastq(fq, bases, quals)
        print(f"data: {args.genome} bp genome, {n_reads} reads of 100 bp, "
              f"{time.time() - t0:.1f} s", flush=True)

        # ---- the main path, as `python -m bfc_tpu_torch -s 5m reads.fq`
        opt = Opts()
        opt.apply_genome_size(cli.parse_size("5m"))
        out_fq = tmp / "corrected.fq"
        report, launches, peak = drive(opt, fq, out_fq)
        cs, es = report["count_s"], report["correct_s"]
        print(f"main path (k={opt.k}, -b{opt.bf_shift}): counting {cs:.2f} s "
              f"({n_reads / cs:.0f} reads/s), correction {es:.2f} s "
              f"({n_reads / es:.0f} reads/s), end to end "
              f"{n_reads / (cs + es):.0f} reads/s; "
              f"{report['n_aggregated']} distinct k-mers aggregated, "
              f"{report['n_kept']} kept; device memory peak "
              f"{peak / 2**30:.2f} GiB; scalar fallback "
              f"{report['n_fallback']} reads; launches {launches}",
              flush=True)
        if report["n_reads"] != n_reads:
            fail(f"counted {report['n_reads']} reads of {n_reads}")
        need_launched(launches, MAIN_KERNELS, "the main path")
        ds = report["spectrum"]
        n_corr = check_output(out_fq, n_reads, bases, quals, opt, ds,
                              args.seed)
        print(f"output: {n_reads} records; {SAMPLE_READS} sampled records "
              f"byte-identical to refmodel.ec1 ({n_corr} of them corrected)",
              flush=True)
        main_hash = file_hash(out_fq)
        out_fq.unlink()

        # ---- the counting against plain versions
        t0 = time.time()
        merged = check_merges(fq, opt, dev, report["n_aggregated"])
        print(f"merges: KB equal to its plain version on all {merged.merges} "
              f"merges of the counting tree (largest {merged.max_rows} rows); "
              f"the fold holds {report['n_aggregated']} k-mers as the main "
              f"path did; {time.time() - t0:.1f} s", flush=True)
        res = {"pack_pull": check_pack_pull(merged.folded),
               "run_combine_merges": (merged.max_abs_err, merged.merges,
                                      merged.max_rows)}
        w = res["pack_pull"]["pull_s"]
        print(f"pull of the {res['pack_pull']['rows']}-row fold: unpacked "
              f"{w['unpacked']} s, packed by KE {w['packed']} s", flush=True)
        main_fold = merged.folded
        del merged
        torch.cuda.empty_cache()
        t0 = time.time()
        head = tmp / "reads_80k.fq"
        write_fastq(head, bases[:HEAD_READS], quals[:HEAD_READS])
        n_agg, n_kept = check_head_count(head, opt, dev)
        print(f"head count: the card's count of the first {HEAD_READS} reads "
              f"equals the plain count on the CPU ({n_agg} k-mers "
              f"aggregated, {n_kept} kept, same histograms); "
              f"{time.time() - t0:.1f} s", flush=True)

        # ---- KA-KD against their plain versions
        res.update(check_kernels(opt, ds, bases, quals, dev, timed=True))
        small = tmp / "reads_head.fq"
        write_fastq(small, bases[:200_000], quals[:200_000])
        opt33, ds33 = small_spectrum(small, 33, dev)
        res33 = check_kernels(opt33, ds33, bases, quals, dev, timed=False)
        del ds33, report
        torch.cuda.empty_cache()

        # ---- the trim path, as `python -m bfc_tpu_torch -1 -k51 reads.fq`
        topt = Opts()
        topt.k = TRIM_K
        topt.filter_mode = True
        trim_fq = tmp / "trimmed.fq"
        trep, tlaunches, tpeak = drive(topt, fq, trim_fq)
        cs, ts = trep["count_s"], trep["trim_s"]
        print(f"trim path (-1 -k{topt.k}, -b{topt.bf_shift}, verdict "
              f"{trep['verdict']}): counting {cs:.2f} s, trim {ts:.2f} s, end "
              f"to end {n_reads / (cs + ts):.0f} reads/s; reads kept "
              f"{trep['reads_kept']}, dropped {trep['reads_dropped']}; "
              f"{trep['n_aggregated']} distinct k-mers aggregated, "
              f"{trep['n_kept']} kept; {trep['n_set_bits']} Bloom bits set; "
              f"device memory peak {tpeak / 2**30:.2f} GiB; launches "
              f"{tlaunches}", flush=True)
        if trep["n_reads"] != n_reads or trep["reads_trimmed"] != n_reads:
            fail(f"trim path: counted {trep['n_reads']} and trimmed "
                 f"{trep['reads_trimmed']} reads of {n_reads}")
        if trep["verdict"] != "KF":
            fail(f"trim path took the {trep['verdict']} verdict, not KF")
        need_launched(tlaunches, TRIM_KERNELS, "the trim path")
        bloom = trep["bloom"]
        n_out, n_sampled_kept = check_trim_output(
            trim_fq, n_reads, bases, quals, topt, bloom, args.seed)
        if n_out != trep["reads_kept"]:
            fail(f"trim output holds {n_out} records, {trep['reads_kept']} "
                 "reads were kept")
        print(f"trim output: {n_out} records; {SAMPLE_READS} sampled reads "
              f"trimmed as refmodel.trim_read trims them ({n_sampled_kept} "
              "kept, the rest absent)", flush=True)
        trim_hash = file_hash(trim_fq)
        trim_fq.unlink()

        # ---- the trim kernels against their plain versions and the host
        t0 = time.time()
        res.update(check_trim_kernels(trep["aggregate"], trep["keep"], bloom,
                                      topt, bases, dev))
        r = res["bloom_adjudicate"]
        print(f"KF verdicts: equal to the host replay on all {r['rows']} "
              f"rows ({r['fp']} first occurrences found their bits set, "
              f"{r['kept']} k-mers kept); {time.time() - t0:.1f} s",
              flush=True)
        del trep, bloom
        torch.cuda.empty_cache()
        t0 = time.time()
        n_agg, n_kept, n_bits = check_trim_head(head, topt, dev)
        print(f"trim head count: the card's -1 count of the first "
              f"{HEAD_READS} reads equals the plain run on the CPU ({n_agg} "
              f"k-mers aggregated, {n_kept} kept, {n_bits} Bloom bits set); "
              f"{time.time() - t0:.1f} s", flush=True)

        # ---- the main path with the device finalize
        dout = tmp / "corrected_device.fq"
        drep, dlaunches, dpeak = drive(opt, fq, dout, device_finalize=True)
        cs, es = drep["count_s"], drep["correct_s"]
        print(f"main path, device finalize (verdict {drep['verdict']}): "
              f"counting {cs:.2f} s, correction {es:.2f} s, end to end "
              f"{n_reads / (cs + es):.0f} reads/s; {drep['n_aggregated']} "
              f"distinct k-mers aggregated, {drep['n_kept']} kept, c_bits "
              f"{drep['spectrum'].c_bits}; device memory peak "
              f"{dpeak / 2**30:.2f} GiB; launches {dlaunches}", flush=True)
        need_launched(dlaunches, MAIN_DEVICE_KERNELS,
                      "the main path with the device finalize")
        need_silent(dlaunches, ("pack_pull", "first_occurrence"),
                    "the main path with the device finalize")
        if (drep["finalize"], drep["verdict"]) != ("device", "KF"):
            fail(f"main path: {drep['finalize']} finalize, verdict "
                 f"{drep['verdict']}")
        if file_hash(dout) != main_hash:
            fail("the device finalize's output differs from the host "
                 "finalize's")
        dout.unlink()
        t0 = time.time()
        n_ent, n_abs = check_device_table(drep["spectrum"], ds, dev, args.seed)
        print(f"device finalize: output byte-identical to the host "
              f"finalize's; the card-built table gives the host table's "
              f"payload for all {n_ent} kept entries and its answer for "
              f"{ABSENT_KEYS} other keys ({n_abs} absent); same histograms; "
              f"{time.time() - t0:.1f} s", flush=True)
        del drep
        torch.cuda.empty_cache()

        # ---- the trim path with the device finalize, then from 2^33
        dtrim = tmp / "trimmed_device.fq"
        dtrep, dtlaunches, dtpeak = drive(topt, fq, dtrim,
                                          device_finalize=True)
        print(f"trim path, device finalize (verdict {dtrep['verdict']}): "
              f"counting {dtrep['count_s']:.2f} s, trim "
              f"{dtrep['trim_s']:.2f} s; {dtrep['n_kept']} k-mers kept; "
              f"device memory peak {dtpeak / 2**30:.2f} GiB; launches "
              f"{dtlaunches}", flush=True)
        need_launched(dtlaunches, TRIM_DEVICE_KERNELS,
                      "the trim path with the device finalize")
        need_silent(dtlaunches, ("pack_pull", "derive_ret"),
                    "the trim path with the device finalize")
        if file_hash(dtrim) != trim_hash:
            fail("the trim path's output differs with the device finalize")
        trim_fold = dtrep["aggregate"]
        del dtrep
        torch.cuda.empty_cache()
        with arrivals_from(FAR):
            ftrep, ftlaunches, _ = drive(topt, fq, dtrim,
                                         device_finalize=True)
            print(f"trim path, device finalize, arrivals from 2^33 (verdict "
                  f"{ftrep['verdict']}): counting {ftrep['count_s']:.2f} s, "
                  f"trim {ftrep['trim_s']:.2f} s; launches {ftlaunches}",
                  flush=True)
            need_launched(ftlaunches, ("first_occurrence",),
                          "the trim path from 2^33")
            need_silent(ftlaunches, ("bloom_adjudicate", "pack_pull"),
                        "the trim path from 2^33")
            if file_hash(dtrim) != trim_hash:
                fail("the trim path's output differs with arrivals from 2^33")
            del ftrep
            torch.cuda.empty_cache()
            kernels.reset_launches()
            t0 = time.time()
            fds = C.count_file_device(str(fq), opt, dev, COUNT_B,
                                      device_finalize=True)
            torch.cuda.synchronize()
            fcount_s = time.time() - t0
            fclaunches = {k.name: k.launches
                          for k in kernels.KERNELS.values()}
        need_launched(fclaunches, ("first_occurrence", "derive_ret",
                                   "finalize_counts", "cuckoo_build"),
                      "the main count from 2^33")
        need_silent(fclaunches, ("bloom_adjudicate", "pack_pull"),
                    "the main count from 2^33")
        if fds.verdict != "KI" or not same_spectrum(fds, ds):
            fail("the main count from 2^33 gives another spectrum")
        print(f"trim output from 2^33 byte-identical; main count from 2^33 "
              f"(verdict KI) {fcount_s:.2f} s, spectrum equal to the host "
              f"finalize's; launches {fclaunches}", flush=True)
        del fds, ds
        dtrim.unlink()
        torch.cuda.empty_cache()

        # ---- the finalize kernels against their plain versions
        t0 = time.time()
        res.update(check_finalize_kernels(main_fold, trim_fold, opt, topt,
                                          dev))
        r = res["first_occurrence"]
        print(f"KI verdicts: equal to KF's on the {r['rows_b30']}-row main "
              f"fold ({r['fp_b30']} Bloom hits) and the {r['rows_b33']}-row "
              f"trim fold ({r['fp_b33']}), arrivals from 0 and from 2^33; "
              f"equal to its plain version and the host replay on the trim "
              f"fold; {time.time() - t0:.1f} s", flush=True)
        del main_fold, trim_fold
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    paths = {"main": launches, "trim": tlaunches,
             "main_device_finalize": dlaunches,
             "trim_device_finalize": dtlaunches,
             "trim_device_finalize_from_2^33": ftlaunches,
             "main_count_device_finalize_from_2^33": fclaunches}
    rows = []
    for name, (tag, src, replaces) in SOURCES.items():
        r = res[name]
        errs = [r] + ([res33[name]] if name in res33 else [])
        mism = sum(x["mismatches"] for x in errs)
        by_path = {p: ls[name] for p, ls in paths.items()}
        print(f"{tag} {name}: mismatches {mism}; {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.1f} ms, bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]}); launches {by_path}", flush=True)
        if mism != 0:
            fail(f"kernel {name} disagrees with its plain version")
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces,
               "launches": sum(by_path.values()),
               "launches_by_path": by_path,
               "max_abs_err": max(x["max_abs_err"] for x in errs),
               "mismatches": mism,
               "ms": r["ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
               "library_ms": None}
        for extra in ("plain_reads", "rows", "pull_s", "replay_mismatches",
                      "c_bits", "ms_b30", "ms_b33", "rows_b30", "rows_b33"):
            if extra in r:
                row[extra] = r[extra]
        if name == "run_combine":
            row["max_abs_err"] = max(row["max_abs_err"],
                                     res["run_combine_merges"][0])
            row["merges_checked"], row["max_merge_rows"] = \
                res["run_combine_merges"][1:]
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
