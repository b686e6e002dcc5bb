"""Smoke run of bfc_tpu_torch on one CUDA card: builds the four kernels,
drives the count + correct main path at E. coli scale, and holds every
kernel against its plain PyTorch version.

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
   fold to the main path's number of distinct k-mers; then the card's
   count of the first 80,000 reads (~9 batches) must equal a plain count
   of them on the CPU, aggregate field for field and finalized spectrum.
4. Each kernel against its plain version on the same CUDA tensors at the
   main path's shapes (KA and KB: a 16,384-read counting batch of 128
   slots; KC and KD: an 8,192-read correction batch of 100 bp, KD's plain
   version on its first 512 reads) with the k = 23 spectrum of phase 2,
   then again at k = 33 on a spectrum of the first 200,000 reads.  The
   tolerance is exact equality: every output is an integer.  Kernel times
   are CUDA-event means over repeated launches after a warm-up.

The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or outside the
repository, the script exits non-zero before printing either.
"""

from __future__ import annotations

import argparse
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
from bfc_tpu_torch.ops import annotate as ann
from bfc_tpu_torch.ops import kmer as kops
from bfc_tpu_torch.ops import search as srch
from bfc_tpu_torch.ops import spectrum_dense as sdn
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

COUNT_B, COUNT_L = 16384, 128   # run_device's counting batch (padded to 32)
CORR_B = 8192                   # run_device's correction batch
KD_PLAIN_READS = 512
SAMPLE_READS = 1000
HEAD_READS = 80_000             # ~9 counting batches for the plain count


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
    against the plain combine; the fold must hold the main path's number
    of distinct k-mers."""
    agg = CheckedAgg(opt, dev)
    for bases, qok, lens, _ in C.padded_batches(str(fq), opt, COUNT_B):
        agg.add(bases, qok, lens)
    rows = len(agg.fold())
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
}


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
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        report = {}
        with open(out_fq, "wb") as sink:
            DP.run_device(opt, str(fq), sink=sink, device="cuda",
                          report=report)
        launches = {k.name: k.launches for k in kernels.KERNELS.values()}
        peak = torch.cuda.max_memory_allocated()
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
        for name, n in launches.items():
            if n == 0:
                fail(f"kernel {name} never launched on the main path")
        ds = report["spectrum"]
        n_corr = check_output(out_fq, n_reads, bases, quals, opt, ds,
                              args.seed)
        print(f"output: {n_reads} records; {SAMPLE_READS} sampled records "
              f"byte-identical to refmodel.ec1 ({n_corr} of them corrected)",
              flush=True)

        # ---- the counting against plain versions
        t0 = time.time()
        merged = check_merges(fq, opt, dev, report["n_aggregated"])
        print(f"merges: KB equal to its plain version on all {merged.merges} "
              f"merges of the counting tree (largest {merged.max_rows} rows); "
              f"the fold holds {report['n_aggregated']} k-mers as the main "
              f"path did; {time.time() - t0:.1f} s", flush=True)
        t0 = time.time()
        head = tmp / "reads_80k.fq"
        write_fastq(head, bases[:HEAD_READS], quals[:HEAD_READS])
        n_agg, n_kept = check_head_count(head, opt, dev)
        print(f"head count: the card's count of the first {HEAD_READS} reads "
              f"equals the plain count on the CPU ({n_agg} k-mers "
              f"aggregated, {n_kept} kept, same histograms); "
              f"{time.time() - t0:.1f} s", flush=True)

        # ---- each kernel against its plain version
        res = check_kernels(opt, ds, bases, quals, dev, timed=True)
        small = tmp / "reads_head.fq"
        write_fastq(small, bases[:200_000], quals[:200_000])
        opt33, ds33 = small_spectrum(small, 33, dev)
        res33 = check_kernels(opt33, ds33, bases, quals, dev, timed=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    rows = []
    for name, (tag, src, replaces) in SOURCES.items():
        r, r33 = res[name], res33[name]
        print(f"{tag} {name}: mismatches k=23 {r['mismatches']}, "
              f"k=33 {r33['mismatches']}; {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.1f} ms, bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]})", flush=True)
        if r["mismatches"] != 0 or r33["mismatches"] != 0:
            fail(f"kernel {name} disagrees with its plain version")
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": max(r["max_abs_err"], r33["max_abs_err"]),
               "mismatches": r["mismatches"] + r33["mismatches"],
               "ms": r["ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
               "library_ms": None}
        if "plain_reads" in r:
            row["plain_reads"] = r["plain_reads"]
        if name == "run_combine":
            row["max_abs_err"] = max(row["max_abs_err"], merged.max_abs_err)
            row["merges_checked"] = merged.merges
            row["max_merge_rows"] = merged.max_rows
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
