"""A/B measurement of KA (kmer_stream), KB (run_combine), KC (kcov_island)
and KD (ec1_search) of one tree of bfc_tpu_torch on one CUDA card.

    python3 chip_ab.py [--tree DIR] [--genome BASES] [--seed N]
                       [--correct-batch N]

bfc_tpu_torch is imported from DIR (default: this script's directory), so
an older tree unpacked with `git archive` into a directory that
.gitignore lists runs the same measurement on its own kernels, which it
builds into DIR/build.  To compare two trees on one card, run them in
turns in one call: A, B, B, A.  The reads are chip_smoke.py's (3,000,000
reads of 100 bp from a seeded 5 Mb genome), counted with the device
finalize at `-s 5m` (k = 23).

Prints one JSON line: the card and its power limit; KA on the
16,384-read counting batch of 128 slots and KC on the main path's
correction batch (as the reader cuts it: 19,508 reads), each as the mean
of 20 wrapper calls (host cost included) and as a kernel (the median
replay of a CUDA graph of 50 calls, host cost excluded), with the sha256
of its outputs; KD on the first 8,192,
65,536 and 131,072 reads of a correction batch (the median of 7 calls, each
timed alone with CUDA events, the wrapper's host cost included; us a
read, the spec's probes, G sectors/s, overflows, and the sha256 of its
output columns), and at 65,536 reads the spec's probes a read (mean,
99.9th percentile, most) and KD without the 64 heaviest reads and on
those alone; KB on the 2,097,152-row counting batch (median of 11);
and the correction pass over all reads with the tree's default batch
(wall, device step, batches, peak device memory above what the spectrum
holds, scalar fallbacks and the output's sha256); --correct-batch sets
that pass's batch instead.  Without a CUDA device
it exits non-zero.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
KD_READS = (8192, 65536, 131072)
TAIL_READS = 64
CALL_REPS = 20   # KA's and KC's wrapper calls a mean (chip_smoke.py's)
GRAPH_REPS = 50  # calls in a timed CUDA graph (chip_probe.py's REPS)


def _load_smoke():
    """chip_smoke.py of this directory (data recipe, batches, timing)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sha(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(HERE),
                    help="directory holding the bfc_tpu_torch to measure")
    ap.add_argument("--genome", type=int, default=5_000_000)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--correct-batch", type=int, default=None,
                    help="reads a batch of the correction pass [the tree's "
                    "default]")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    from bfc_tpu_torch import cli, kernels
    from bfc_tpu_torch.io import fast_reader as FR
    from bfc_tpu_torch.io.writer import OutputWriter
    from bfc_tpu_torch.models import counter as C
    from bfc_tpu_torch.models import device_pipeline as DP
    from bfc_tpu_torch.ops import annotate as ann
    from bfc_tpu_torch.ops import kmer as kops
    from bfc_tpu_torch.ops import search as srch
    from bfc_tpu_torch.ops import spectrum_dense as sdn
    from bfc_tpu_torch.opts import Opts

    smoke = _load_smoke()
    dev = torch.device("cuda")
    rec = {"tree": str(tree), "card": smoke.card_line(),
           "build_s": kernels.build_all()}
    tmp = Path(tempfile.mkdtemp(prefix="bfc_chip_ab_"))
    try:
        bases, quals = smoke.make_reads(args.genome, args.seed)
        fq = tmp / "reads.fq"
        smoke.write_fastq(fq, bases, quals)
        opt = Opts()
        opt.apply_genome_size(cli.parse_size("5m"))
        t0 = time.time()
        ds = C.count_file_device(str(fq), opt, dev, batch_reads=smoke.COUNT_B,
                                 device_finalize=True)
        torch.cuda.synchronize()
        rec["count_s"] = time.time() - t0

        # KB on one counting batch's sorted rows
        k, l_pre = opt.k, opt.effective_l_pre()
        carry = not sdn.ret_derivable(k, l_pre)
        cb, cq, cl = smoke.count_batch(bases, quals, opt, dev)
        ka = lambda: kops.kmer_stream(cb, cq, cl, k, l_pre, 0, with_ret=carry)
        shard, keybody, arrp, ret = ka()
        rec["ka"] = {"reads": smoke.COUNT_B, "slots": smoke.COUNT_L,
                     "sha256": _sha(*(f for f in (shard, keybody, arrp, ret)
                                      if f is not None)),
                     "ms": smoke.cuda_ms(ka, CALL_REPS),
                     "kernel_ms": smoke.graph_ms([ka], GRAPH_REPS)}
        shard, keybody, arrp = (x.view(-1) for x in (shard, keybody, arrp))
        perm = sdn.stable_order(shard, keybody)
        arrp = arrp[perm]
        high = arrp & 1
        srt = sdn.Run(shard[perm], keybody[perm], arrp >> 1,
                      torch.ones_like(high), high, high.to(torch.uint8),
                      ret.view(-1)[perm] if carry else None)
        got = sdn.run_combine(srt)
        rec["kb"] = {"rows": len(srt), "groups": len(got),
                     "sha256": _sha(*(f for f in got if f is not None)),
                     "ms": smoke.cuda_median_ms(lambda: sdn.run_combine(srt),
                                                11)}
        del got, srt, cb, cq, cl, shard, keybody, arrp, ret, perm, high

        # KC on the main path's correction batch (as the reader cuts it)
        # of the reads after the counting batch; KD on correction batches
        # of those reads
        t = ds.table
        b, q, lens = smoke.corr_batch(bases, quals, opt, dev, smoke.COUNT_B,
                                      max(KD_READS))
        m = next(iter(FR.iter_batches(str(fq), srch.CORRECT_BATCH,
                                      max_bases=opt.chunk_size))).n
        kc = lambda: ann.kcov_island(t, b[:m], lens[:m], opt.min_cov)
        rec["kc"] = {"reads": m, "sha256": _sha(*kc()),
                     "ms": smoke.cuda_ms(kc, CALL_REPS),
                     "kernel_ms": smoke.graph_ms([kc], GRAPH_REPS)}
        _, lcov, hcov, isl = ann.kcov_island(t, b, lens, opt.min_cov)
        rec["kd"] = {}
        if hasattr(srch, "kd_plan"):  # the persistent KD's launch plan
            rec["kd_plan"] = srch.kd_plan()._asdict()
        for m in KD_READS:
            cols = tuple(x[:m] for x in (b, q, lens, lcov, hcov, isl))
            packed, out = srch.ec1_search(t, opt, ds.mode, *cols)
            probes = int(out[:, srch.PROBES].sum())
            ms = smoke.cuda_median_ms(
                lambda: srch.ec1_search(t, opt, ds.mode, *cols))
            rec["kd"][m] = {
                "ms": ms, "us_per_read": ms * 1e3 / m, "spec_probes": probes,
                "g_sectors_per_s": probes * 2 / (ms * 1e-3) / 1e9,
                "overflow": int(out[:, srch.OVERFLOW].sum()),
                "sha256": _sha(packed, out)}
        # the tail: KD without the 65,536-read batch's heaviest reads (by
        # the spec's probes), and on those reads alone
        cols = tuple(x[:65536] for x in (b, q, lens, lcov, hcov, isl))
        out = out[:65536]
        probes = out[:, srch.PROBES]
        heavy = torch.argsort(probes, descending=True)[:TAIL_READS]
        rest = torch.ones_like(probes, dtype=torch.bool)
        rest[heavy] = False
        rest = torch.nonzero(rest).flatten()
        pf = probes.double()
        rec["kd_tail"] = {
            "reads": TAIL_READS, "probes_max": int(probes.max()),
            "probes_p999": float(torch.quantile(pf, 0.999)),
            "probes_mean": float(pf.mean()),
            "heaviest_probes": probes[heavy[:8]].tolist()}
        for name, idx in (("without_heaviest", rest), ("heaviest", heavy)):
            sub = tuple(x[idx].contiguous() for x in cols)
            rec["kd_tail"][f"ms_{name}"] = smoke.cuda_median_ms(
                lambda: srch.ec1_search(t, opt, ds.mode, *sub))
        del b, q, lens, lcov, hcov, isl, packed, out, cols, sub
        torch.cuda.empty_cache()

        # the correction pass with the tree's default batch
        out_fq = tmp / "corrected.fq"
        kernels.reset_launches()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with open(out_fq, "wb") as sink:
            w = OutputWriter(sink)
            kw = ({} if args.correct_batch is None
                  else {"batch_reads": args.correct_batch})
            corr = DP.correct_file_device(str(fq), opt, ds, w, **kw)
            w.flush()
        torch.cuda.synchronize()
        h = hashlib.sha256(out_fq.read_bytes()).hexdigest()
        rec["correction"] = {
            "batch_reads": args.correct_batch, "wall_s": time.time() - t0, "device_step_s": corr.t_device,
            "kd_launches": kernels.KD.launches,
            "peak_bytes_above_spectrum":
                torch.cuda.max_memory_allocated() - base,
            "allocated_before_bytes": base, "n_fallback": corr.n_fallback,
            "sha256": h}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
