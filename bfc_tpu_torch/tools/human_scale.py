"""Human-scale capacity rehearsal: stream millions of reads through the
card's counting tree, its spill to the host, a finalize and correction.

Counterpart of scripts/human_scale.py, which rehearses bfc_tpu at a scale
approaching the reference's human benchmark (889M reads, 67.9 GB peak,
tex/bfc.tex:188-189).  Synthetic reads of a seeded genome (the same
recipe) go batch by batch through AggBuilder.add; the tree spills to the
host where a merge would not fit the card (the byte rule,
counter.merge_on_card); finish, then the host finalize, the device
finalize or both on the one aggregate; then Corrector.correct_arrays on
the first --correct-reads reads.

    python -m bfc_tpu_torch.tools.human_scale [--reads 10e6]
        [--genome 100e6] [--readlen 100] [--k 27] [--batch 8192]
        [--err 0.01] [--count-only] [--correct-reads 500e3] [--seed 7]
        [--device-finalize | --both-finalize] [--merge-cap ROWS]
        [--leave-free GIB] [--cpu]

The run checks itself, apart from the spill chain: a sample of 4,096
canonical keys (half at random genome offsets, half from the first
batch's k-mers) is tallied from every batch's KA rows, and at the end
each key must be in the final aggregate exactly where tallied, with its
counts (to the payload's caps of 255 and 63) and first occurrence; the
aggregate must be in key order; 1,000 corrected reads must equal the
scalar model's (refmodel.ec1) on the same table; and with
--both-finalize the two finalizes must keep the same entries.  Without
--cpu the card must be there.  --merge-cap sets BFC_TPU_MAX_MERGE_CAP
for the run (a row cap, for the CPU, where the byte rule has no limit);
without it the variable must be unset, so that on the card the byte rule
alone decides.  --leave-free holds a ballast on the card, from before
the stream to the end of finish, that leaves GIB GiB free.

Progress lines start with "[hs]"; the last line of stdout is one JSON
report.  Exits 1 where a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np
import torch

from .. import kernels
from ..io.fastq import Read, format_corrected, pack_stats
from ..io.writer import OutputWriter
from ..models import corrector as DC
from ..models import counter as C
from ..models import refmodel as M
from ..ops import kmer as kops
from ..ops import spectrum_dense as sdn
from ..ops import spectrum_host as sph
from ..ops.spectrum import IntProbe
from ..opts import Opts

SAMPLE_KEYS = 2048     # keys drawn at genome offsets, and again from batch 0
SAMPLE_READS = 1000    # corrected reads held against refmodel.ec1
N_CAP, HIGH_CAP = 255, 63  # the payload's caps (spectrum_host.py:591-592)


def gen_batch(genome: np.ndarray, seed: int, B: int, rlen: int, err: float,
              q: int):
    """One encoded batch of B reads of rlen bases at random offsets of
    genome, half reverse-complemented, each base wrong with probability
    err and then given a low quality: (bases u8 [B, rlen], qok bool,
    lens i32 [B], raw quality ASCII u8 [B, rlen]).  scripts/human_scale.py's
    gen_batch."""
    r = np.random.default_rng(seed)
    glen = len(genome)
    starts = r.integers(0, glen - rlen, B)
    mat = genome[starts[:, None] + np.arange(rlen)[None, :]]
    rc = r.random(B) < 0.5
    mat[rc] = 3 - mat[rc, ::-1]
    wrong = r.random((B, rlen)) < err
    mat = np.where(wrong, (mat + r.integers(1, 4, mat.shape)) % 4,
                   mat).astype(np.uint8)
    qmat = np.where(wrong, 33 + 2 + r.integers(0, 13, mat.shape),
                    33 + 30 + r.integers(0, 10, mat.shape)).astype(np.uint8)
    qok = qmat.astype(np.int32) - 33 >= q
    lens = np.full((B,), rlen, np.int32)
    return mat, qok, lens, qmat


def mem_line(dev: torch.device) -> str:
    """Host VmHWM and VmRSS, and the card's allocated bytes and peak."""
    st = host_rss()
    s = f"rss {st['VmRSS'] / 2**30:.2f} GiB (peak {st['VmHWM'] / 2**30:.2f})"
    if dev.type == "cuda":
        s += (f" dev {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
              f"(peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f})")
    return s


def host_rss() -> dict:
    """VmHWM and VmRSS of /proc/self/status in bytes; where the status
    has no VmHWM, the peak is getrusage's ru_maxrss, which a process
    started by a larger one begins at that one's peak."""
    got = {"VmHWM": 0, "VmRSS": 0}
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                key = ln.split(":")[0]
                if key in got:
                    got[key] = int(ln.split()[1]) * 1024
    except OSError:
        pass
    if not got["VmHWM"]:
        got["VmHWM"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return got


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "-i", str(dev.index or 0),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def key_of(shard, keybody):
    """The int64 search key of (shard, keybody): keybody (below 2^50)
    xor shard (below 2^24) shifted to bits 39-62; not one to one for
    every k, so a match is confirmed on both columns."""
    return keybody ^ (shard << 39)


class Tally:
    """Exact occurrence counts of a sample of keys, from KA's rows of each
    batch (the call spectrum_dense.chunk_rows makes), kept apart from the
    counting tree: n, n_high and the smallest arrival << 1 | is_high of
    each key.  shard, keybody: int64 sample keys whose key_of values are
    distinct."""

    def __init__(self, shard, keybody, k: int, l_pre: int, device):
        dev = torch.device(device)
        order = torch.argsort(key_of(shard, keybody))
        self.shard = shard[order].to(dev)
        self.keybody = keybody[order].to(dev)
        self.key = key_of(self.shard, self.keybody)
        if bool((self.key[1:] == self.key[:-1]).any()):
            raise ValueError("the sample's search keys are not distinct")
        self.k, self.l_pre, self.device = k, l_pre, dev
        S = len(self.shard)
        self.n = torch.zeros((S,), dtype=torch.int64, device=dev)
        self.n_high = torch.zeros_like(self.n)
        self.first = torch.full((S,), torch.iinfo(torch.int64).max,
                                dtype=torch.int64, device=dev)

    def add(self, bases: np.ndarray, qok: np.ndarray, lens: np.ndarray,
            arrival_base: int) -> None:
        dev = self.device
        shard, keybody, arrp, _ = kops.kmer_stream(
            torch.from_numpy(bases).to(dev), torch.from_numpy(qok).to(dev),
            torch.from_numpy(lens).to(dev), self.k, self.l_pre, arrival_base)
        shard, keybody, arrp = shard.view(-1), keybody.view(-1), arrp.view(-1)
        key = key_of(shard, keybody)
        at = torch.searchsorted(self.key, key).clamp(max=len(self.key) - 1)
        hit = ((shard != kops.INVALID_SHARD) & (self.key[at] == key)
               & (self.shard[at] == shard) & (self.keybody[at] == keybody))
        at, arrp = at[hit], arrp[hit]
        self.n.index_add_(0, at, torch.ones_like(at))
        self.n_high.index_add_(0, at, arrp & 1)
        self.first.scatter_reduce_(0, at, arrp, "amin")

    def check(self, agg: sph.HostAgg) -> dict:
        """Mismatches of the sample against the final aggregate: presence,
        min(n, 255), min(n_high, 63), first_arr, first_high; and how many
        sampled keys were tallied and how many not."""
        n, n_high, first = (x.cpu().numpy() for x in
                            (self.n, self.n_high, self.first))
        tallied = n > 0
        found, g_n, g_high, g_arr, g_fh = host_lookup(
            agg, self.shard.cpu().numpy(), self.keybody.cpu().numpy())
        t = tallied & found
        return {
            "tallied": int(tallied.sum()),
            "untallied": int((~tallied).sum()),
            "presence": int((found != tallied).sum()),
            "n": int((np.minimum(g_n[t], N_CAP)
                      != np.minimum(n[t], N_CAP)).sum()),
            "n_high": int((np.minimum(g_high[t], HIGH_CAP)
                           != np.minimum(n_high[t], HIGH_CAP)).sum()),
            "first_arr": int((g_arr[t] != first[t] >> 1).sum()),
            "first_high": int((g_fh[t] != (first[t] & 1)).sum()),
        }


def lower_bound(shard, keybody, qs, qk):
    """The first row of (shard, keybody), sorted by that pair, not below
    each query (qs, qk): a binary search of all queries at once."""
    N = len(shard)
    lo = np.zeros(len(qs), np.int64)
    hi = lo + N
    for _ in range(max(N, 1).bit_length() + 1):
        mid = (lo + hi) // 2
        m = np.minimum(mid, max(N - 1, 0))
        s, kb = shard[m], keybody[m]
        less = (mid < hi) & ((s < qs) | ((s == qs) & (kb < qk)))
        lo = np.where(less, mid + 1, lo)
        hi = np.where(less, hi, mid)
    return lo


def host_lookup(agg: sph.HostAgg, qs: np.ndarray, qk: np.ndarray):
    """(found, n, n_high, first_arr, first_high) of the query keys in a
    HostAgg, int64 arrays (0 where not found)."""
    N = len(agg.shard)
    if N == 0:
        return (np.zeros(len(qs), bool),) + tuple(
            np.zeros(len(qs), np.int64) for _ in range(4))
    qs = qs.astype(np.uint32)
    qk = qk.astype(np.uint64)
    at = lower_bound(agg.shard, agg.keybody, qs, qk)
    m = np.minimum(at, N - 1)
    found = (at < N) & (agg.shard[m] == qs) & (agg.keybody[m] == qk)

    def col(c):
        return np.where(found, c[m].astype(np.int64), 0)

    return (found, col(agg.n), col(agg.n_high), col(agg.first_arr),
            col(agg.first_high))


def apart(counts: dict, fn, *args):
    """fn(*args), the launches it makes added to counts by kernel: the
    checks' launches, kept out of the path's."""
    before = {k.name: k.launches for k in kernels.KERNELS.values()}
    out = fn(*args)
    for k in kernels.KERNELS.values():
        counts[k.name] += k.launches - before[k.name]
    return out


def sample_keys(genome: np.ndarray, first_batch, k: int, l_pre: int,
                rng, device):
    """SAMPLE_KEYS canonical keys at random genome offsets and SAMPLE_KEYS
    from the first batch's k-mers (KA over both), less those whose
    key_of repeats: (shard, keybody) int64 tensors on the CPU."""
    dev = torch.device(device)
    starts = rng.integers(0, len(genome) - k, SAMPLE_KEYS)
    win = genome[starts[:, None] + np.arange(k)[None, :]].astype(np.uint8)
    s, kb, _, _ = kops.kmer_stream(
        torch.from_numpy(win).to(dev),
        torch.ones(win.shape, dtype=torch.bool, device=dev),
        torch.full((SAMPLE_KEYS,), k, dtype=torch.int32, device=dev), k, l_pre)
    g_s, g_kb = s[:, k - 1].cpu(), kb[:, k - 1].cpu()
    bases, qok, lens, _ = first_batch
    s, kb, _, _ = kops.kmer_stream(
        torch.from_numpy(bases).to(dev), torch.from_numpy(qok).to(dev),
        torch.from_numpy(lens).to(dev), k, l_pre)
    s, kb = s.view(-1).cpu(), kb.view(-1).cpu()
    valid = torch.nonzero(s != kops.INVALID_SHARD).flatten().numpy()
    pick = torch.from_numpy(rng.choice(valid, SAMPLE_KEYS, replace=False))
    shard = torch.cat([g_s, s[pick]])
    keybody = torch.cat([g_kb, kb[pick]])
    key = key_of(shard, keybody).numpy()
    _, first = np.unique(key, return_index=True)
    first = torch.from_numpy(np.sort(first))
    return shard[first], keybody[first]


def record(name: str, st, s2, q2, opt: Opts) -> list:
    """A read's (EcStat, seq, qual) as the emit formats its record."""
    r = Read(name=name, comment=None, seq=s2, qual=q2)
    r.aux, r.aux2 = pack_stats(st)
    w = OutputWriter()
    format_corrected(r, opt.no_qual, False, opt.discard, w)
    return w.getbytes().split(b"\n")[:4]


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=float, default=10e6)
    ap.add_argument("--genome", type=float, default=100e6)
    ap.add_argument("--readlen", type=int, default=100)
    ap.add_argument("--k", type=int, default=27)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--err", type=float, default=0.01)
    ap.add_argument("--count-only", action="store_true")
    ap.add_argument("--correct-reads", type=float, default=500e3,
                    help="reads to push through correction (the full set "
                         "takes hours; throughput is batch-stationary)")
    ap.add_argument("--seed", type=int, default=7,
                    help="the genome's seed, and the checks' samples'")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--device-finalize", action="store_true",
                      help="finalize on the card (default: the host)")
    mode.add_argument("--both-finalize", action="store_true",
                      help="both finalizes on the same aggregate; their "
                           "kept entries must be equal")
    ap.add_argument("--merge-cap", type=int, default=None,
                    help="BFC_TPU_MAX_MERGE_CAP for this run, in rows")
    ap.add_argument("--leave-free", type=float, default=None,
                    help="GiB of the card left free by a ballast held "
                         "through the counting")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.cpu:
        dev = torch.device("cpu")
    elif torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        print("human_scale: no CUDA device (--cpu runs on the CPU)",
              file=sys.stderr)
        return 2
    if args.merge_cap is not None:
        os.environ["BFC_TPU_MAX_MERGE_CAP"] = str(args.merge_cap)
    elif os.environ.get("BFC_TPU_MAX_MERGE_CAP"):
        print("human_scale: BFC_TPU_MAX_MERGE_CAP is set; unset it so that "
              "the byte rule alone decides, or pass --merge-cap",
              file=sys.stderr)
        return 2
    if args.leave_free is not None and dev.type != "cuda":
        print("human_scale: --leave-free needs the card", file=sys.stderr)
        return 2
    modes = (["host", "device"] if args.both_finalize
             else ["device"] if args.device_finalize else ["host"])
    n_reads, glen, rlen, B = int(args.reads), int(args.genome), \
        args.readlen, args.batch
    card = card_line(dev)
    print(f"[hs] {card}; genome {glen / 1e6:.1f} Mbp, {n_reads / 1e6:.2f}M "
          f"reads x {rlen} bp ({n_reads * rlen / 1e9:.2f} Gbp), k={args.k}, "
          f"finalize {'+'.join(modes)}", flush=True)
    t0 = time.time()
    genome = np.random.default_rng(args.seed).integers(0, 4, glen).astype(
        np.uint8)
    print(f"[hs] genome in {time.time() - t0:.1f} s; {mem_line(dev)}",
          flush=True)
    opt = Opts()
    opt.k = args.k
    opt.apply_genome_size(glen)
    opt.k = args.k  # the requested k; -s only sizes the Bloom filter
    l_pre = opt.effective_l_pre()
    rep = {"card": card, "device": str(dev), "reads": 0, "gbp": 0.0,
           "k": opt.k, "bf_shift": opt.bf_shift, "genome": glen,
           "readlen": rlen, "batch": B, "seed": args.seed,
           "merge_cap": args.merge_cap, "finalize": modes}
    checks = {}

    # ---- counting ----------------------------------------------------------
    rng = np.random.default_rng(args.seed + 1)
    n_batches = n_reads // B
    ballast = None
    kernels.reset_launches()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        if args.leave_free is not None:
            size = max(kernels.device_free_bytes(dev)
                       - int(args.leave_free * 2**30), 0)
            ballast = torch.empty((size,), dtype=torch.uint8, device=dev)
            rep["ballast_bytes"] = size
            rep["free_beside_ballast"] = kernels.device_free_bytes(dev)
    builder = C.AggBuilder(opt, dev)
    tally = None
    check_launches = dict.fromkeys(kernels.KERNELS, 0)
    sync(dev)
    t0 = t_log = time.time()
    for bi in range(n_batches):
        batch = gen_batch(genome, 1000 + bi, B, rlen, args.err, opt.q)
        if tally is None:
            tally = Tally(*apart(check_launches, sample_keys, genome, batch,
                                 opt.k, l_pre, rng, dev), opt.k, l_pre, dev)
        base = builder.arrival_base
        builder.add(*batch[:3])
        apart(check_launches, tally.add, *batch[:3], base)
        if time.time() - t_log > 60:
            t_log = time.time()
            done = (bi + 1) * B
            print(f"[hs] counted {done / 1e6:.2f}M reads "
                  f"({done / (t_log - t0):.0f} reads/s), {builder.spills} "
                  f"spills; {mem_line(dev)}", flush=True)
    t_stream = time.time() - t0
    agg = builder.finish(device_finalize="device" in modes)
    sync(dev)
    t_count = time.time() - t0
    n_in = n_batches * B
    rep.update(reads=n_in, gbp=n_in * rlen / 1e9, count_s=t_count,
               stream_s=t_stream, count_reads_per_s=n_in / max(t_count, 1e-9),
               rows_aggregated=len(agg) if isinstance(agg, sdn.Run)
               else len(agg.shard),
               spilled=builder.spills > 0, spills=builder.spills,
               spilled_rows=builder.spilled_rows,
               host_merge_rows=builder.host_merge_rows,
               lsm_timings=dict(builder.tree.timings))
    if ballast is not None:
        del ballast
        torch.cuda.empty_cache()
    if dev.type == "cuda":
        rep["count_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                   - rep.get("ballast_bytes", 0))
    print(f"[hs] counting: {n_in / 1e6:.2f}M reads in {t_count:.1f} s "
          f"({rep['count_reads_per_s']:.0f} reads/s; finish "
          f"{t_count - t_stream:.1f} s); {rep['rows_aggregated']} rows "
          f"aggregated, {builder.spills} spills of {builder.spilled_rows} "
          f"rows, host merges of {builder.host_merge_rows} rows, "
          f"{builder.tree.timings}; {mem_line(dev)}", flush=True)
    # a Run (nothing spilled) is checked on the host, pulled once: the
    # host finalize's pull, or else the check's
    hagg = agg
    if isinstance(agg, sdn.Run):
        hagg = (builder.pull(agg) if "host" in modes
                else apart(check_launches, builder.pull, agg))
    checks["tally"] = tally.check(hagg)
    checks["key_order"] = sph.in_key_order(hagg.shard, hagg.keybody)
    print(f"[hs] checks: sampled keys {checks['tally']}, key order "
          f"{checks['key_order']}", flush=True)

    # ---- finalize ----------------------------------------------------------
    spectra = {}
    rep["finalize_modes"] = {}
    for mode in modes:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        a = agg
        if mode == "host" and hagg.bloom_min is None:
            a = builder.sketched(hagg)  # as finish gives it the host finalize
        ds = C.finalize_spectrum(a, opt, dev, host=mode == "host")
        sync(dev)
        t_fin = time.time() - t0
        del a
        tb = ds.table.table
        rep["finalize_modes"][mode] = {
            "s": t_fin, "c_bits": ds.c_bits, "entries": ds.n_entries,
            "table_bytes": tb.numel() * tb.element_size(),
            "verdict": ds.verdict,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None)}
        spectra[mode] = ds
        print(f"[hs] {mode} finalize: {ds.n_entries} entries kept in "
              f"{t_fin:.1f} s ({ds.verdict} verdict), c_bits {ds.c_bits}; "
              f"{mem_line(dev)}", flush=True)
    del agg, hagg
    if args.both_finalize:
        h, d = (spectra[m].compact_entries() for m in ("host", "device"))
        checks["finalizes_equal"] = all(
            len(x) == len(y) and bool(np.array_equal(x, y))
            for x, y in zip(h, d))
        del spectra["device"]
    ds = spectra[modes[0]]
    del spectra
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rep["entries"] = ds.n_entries

    # ---- correction --------------------------------------------------------
    if not args.count_only:
        corr = DC.Corrector(opt, ds)
        n_corr = max(min(int(args.correct_reads), n_reads) // B, 1) * B
        pick = set(rng.choice(n_corr, min(SAMPLE_READS, n_corr),
                              replace=False).tolist())
        acgt = np.frombuffer(b"ACGT", np.uint8)
        probe = IntProbe(ds.table)
        differ = 0
        done = 0
        t_dev = 0.0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        for bi in range(n_corr // B):
            mat, _, lens, qmat = gen_batch(genome, 1000 + bi, B, rlen,
                                           args.err, opt.q)

            def text_of(i, mat=mat, qmat=qmat):
                return (acgt[mat[i]].tobytes().decode(),
                        qmat[i].tobytes().decode())

            sync(dev)
            t0 = time.time()
            res = corr.correct_arrays(mat, qmat, lens, np.ones((B,), bool),
                                      text_of)
            sync(dev)
            if bi > 0:  # the first batch builds the kernels' state
                t_dev += time.time() - t0
                done += B
            for i in range(B):
                if bi * B + i not in pick:
                    continue
                st, s2, q2 = M.ec1(opt, probe, ds.mode, *text_of(i))
                differ += (record(f"r{i}", st, s2, q2, opt)
                           != record(f"r{i}", *res.tuple_of(i), opt))
        rep.update(correct_reads=n_corr, correct_timed_reads=done,
                   correct_s=t_dev,
                   correct_reads_per_s=done / t_dev if t_dev else None,
                   fallback=corr.n_fallback,
                   fallback_share=corr.n_fallback / n_corr)
        if dev.type == "cuda":
            rep["correct_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        checks["records"] = {"sampled": len(pick), "differ": differ}
        print(f"[hs] correction: {n_corr} reads, {done} timed in "
              f"{t_dev:.1f} s ({rep['correct_reads_per_s']} reads/s), "
              f"fallback {corr.n_fallback}; {len(pick)} sampled records, "
              f"{differ} differ from refmodel.ec1; {mem_line(dev)}",
              flush=True)

    st = host_rss()
    rep["host_peak_rss_bytes"] = st["VmHWM"]
    rep["launches"] = {k.name: k.launches - check_launches[k.name]
                       for k in kernels.KERNELS.values()}
    rep["check_launches"] = {n: v for n, v in check_launches.items() if v}
    t = checks["tally"]
    passed = (t["presence"] == t["n"] == t["n_high"] == t["first_arr"]
              == t["first_high"] == 0 and t["tallied"] > 0
              and checks["key_order"]
              and checks.get("finalizes_equal", True)
              and checks.get("records", {}).get("differ", 0) == 0)
    rep["checks"] = checks
    rep["ok"] = passed
    print(json.dumps(rep), flush=True)
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
