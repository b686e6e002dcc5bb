"""Drop-in compatible CLI (reference surface: bfc.c:55-158).

Usage: python -m bfc_tpu_torch [options] <to-count.fq> [to-correct.fq]

The flag parsing of bfc_tpu's CLI.  Runs on the CUDA card unless --cpu
asks for the CPU, where every kernel's plain version runs instead.
--mesh N (N > 1) launches N ranks (parallel/multihost.py) that run this
CLI as a mesh and passes rank 0's stdout through; with
BFC_TPU_SHARD_TABLE=1 and N a power of two each rank holds only its
sub-table of the spectrum.  Trim mode (-1) ignores the mesh, -d and -r,
as bfc_tpu's CLI does.  --scalar, and -V4 (whose per-read search trace
only the scalar model prints), run the scalar pipeline on the host
(models/pipeline.py) and start no ranks; --profile DIR writes a
torch.profiler trace of the device run into DIR, a file a rank.
"""

from __future__ import annotations

import contextlib
import getopt
import sys
from typing import List, Optional

from . import __version__
from .opts import Opts
from .utils import log as ulog

VERSION = f"torch-{__version__}(r181-compat)"
SHORT_OPTS = "hvV:Ed:k:s:b:L:t:C:H:q:Jr:c:w:D1QR"
LONG_OPTS = ["batch=", "cpu", "scalar", "mesh=", "profile="]


def usage(fp, o: Opts) -> None:
    fp.write("Usage: bfc-tpu-torch [options] <to-count.fq> [to-correct.fq]\n")
    fp.write("Options:\n")
    fp.write("  -s FLOAT     approx genome size (k/m/g allowed; change -k and -b) [unset]\n")
    fp.write(f"  -k INT       k-mer length [{o.k}]\n")
    fp.write(f"  -t INT       number of threads (I/O only; compute is batched) [{o.n_threads}]\n")
    fp.write(f"  -b INT       set Bloom filter size to pow(2,INT) bits [{o.bf_shift}]\n")
    fp.write(f"  -H INT       use INT hash functions for Bloom filter [{o.n_hashes}]\n")
    fp.write("  -d FILE      dump hash table to FILE [null]\n")
    fp.write("  -E           skip error correction\n")
    fp.write("  -R           refine bfc-corrected reads\n")
    fp.write("  -r FILE      restore hash table from FILE [null]\n")
    fp.write(f"  -w INT       no more than 5 ec or 2 highQ ec in INT-bp window [{o.win_multi_ec}]\n")
    fp.write(f"  -c INT       min k-mer coverage [{o.min_cov}]\n")
    fp.write("  -Q           force FASTA output\n")
    fp.write("  -1           drop reads containing unique k-mers\n")
    fp.write("  -v           show version number\n")
    fp.write("  -h           show command line help\n")
    fp.write("Device options:\n")
    fp.write("  --batch INT     reads per correction batch [65536] (trim: [8192])\n")
    fp.write("  --cpu           run on the CPU (the kernels' plain versions)\n")
    fp.write("  --scalar        use the scalar reference model (debug)\n")
    fp.write("  --mesh INT      shard over INT devices\n")
    fp.write("  --profile DIR   write a torch.profiler trace of the run to DIR\n")


def parse_size(s: str) -> int:
    """strtod-style size parse: leading float, then only the FIRST char of
    the remainder selects the multiplier (bfc.c:112-121)."""
    import re

    m = re.match(r"\s*[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?", s)
    x = float(m.group(0)) if m else 0.0
    rest = s[m.end():] if m else s
    if rest[:1] in ("g", "G"):
        x *= 1e9
    elif rest[:1] in ("m", "M"):
        x *= 1e6
    elif rest[:1] in ("k", "K"):
        x *= 1e3
    return int(x) + 1


def main(argv: Optional[List[str]] = None,
         report: Optional[dict] = None) -> int:
    """Run the CLI; report, where given, receives run_device's report."""
    from .parallel import comm

    argv = sys.argv[1:] if argv is None else argv
    opt = Opts()
    no_ec = False
    batch_reads = None
    device = "cuda"
    use_scalar = False
    profile_dir = None
    mesh = 1
    in_hash = out_hash = None
    ulog.reset_clock()
    try:
        optlist, args = getopt.getopt(argv, SHORT_OPTS, LONG_OPTS)
    except getopt.GetoptError as e:
        sys.stderr.write(f"bfc-tpu-torch: {e}\n")
        usage(sys.stderr, opt)
        return 1
    for flag, val in optlist:
        if flag == "-d":
            out_hash = val
        elif flag == "-r":
            in_hash = val
        elif flag == "-q":
            opt.q = int(val)
        elif flag == "-b":
            opt.bf_shift = int(val)
        elif flag == "-t":
            opt.n_threads = int(val)
        elif flag == "-H":
            opt.n_hashes = int(val)
        elif flag == "-c":
            opt.min_cov = int(val)
        elif flag == "-w":
            opt.win_multi_ec = int(val)
        elif flag == "-R":
            opt.refine_ec = True
        elif flag == "-D":
            opt.discard = True
        elif flag == "-1":
            opt.filter_mode = True
        elif flag == "-Q":
            opt.no_qual = True
        elif flag == "-J":
            opt.no_mt_io = True
        elif flag == "-E":
            no_ec = True
        elif flag == "-V":
            opt.verbose = int(val)
            ulog.verbosity = opt.verbose
        elif flag == "-k":
            opt.k = int(val)
            sys.stderr.write(f"[M::main] set k to {opt.k}\n")
        elif flag == "-h":
            usage(sys.stdout, opt)
            return 0
        elif flag == "-v":
            print(VERSION)
            return 0
        elif flag == "-s":
            opt.apply_genome_size(parse_size(val))
            sys.stderr.write(f"[M::main] applied `-k {opt.k} -b {opt.bf_shift}'\n")
        elif flag == "-L":
            opt.chunk_size = parse_size(val)
        elif flag == "--batch":
            batch_reads = int(val)
        elif flag == "--cpu":
            device = "cpu"
        elif flag == "--scalar":
            use_scalar = True
        elif flag == "--mesh":
            mesh = int(val)
        elif flag == "--profile":
            profile_dir = val
    if not args:
        usage(sys.stderr, opt)
        return 1

    if opt.verbose >= 4 and not use_scalar:
        # the per-read search trace (correct.c:284-287 etc.) exists only in
        # the scalar engine; output is byte-identical either way, so -V4
        # routes through it to reproduce the reference's debugging hook
        sys.stderr.write("[M::main] -V4 search trace: using the scalar engine\n")
        use_scalar = True
    if use_scalar:
        from .models import pipeline as P
        from .models import refmodel as _rm

        _rm.verbose = opt.verbose
        sys.stdout.write(P.run(opt, args[0],
                               correct_fn=args[1] if len(args) > 1 else None,
                               in_hash=in_hash, out_hash=out_hash,
                               no_ec=no_ec))
        _epilogue(argv)
        return 0

    in_mesh = comm.active()
    if in_mesh and mesh not in (1, comm.size()):
        raise ValueError(f"--mesh {mesh} in a mesh of {comm.size()} ranks")
    if mesh > 1 and not in_mesh and not opt.filter_mode:
        from .parallel import multihost

        return multihost.launch(mesh, argv)

    from .models import device_pipeline as DP

    with _profiled(profile_dir, device, comm.rank() if in_mesh else 0):
        # stream records to stdout as batches finish (O(batch) memory,
        # the reference's pipeline behavior)
        DP.run_device(opt, args[0],
                      correct_fn=args[1] if len(args) > 1 else None,
                      no_ec=no_ec, batch_reads=batch_reads,
                      sink=sys.stdout.buffer, device=device, report=report,
                      in_hash=in_hash, out_hash=out_hash)
    _epilogue(argv)
    return 0


@contextlib.contextmanager
def _profiled(profile_dir: Optional[str], device: str, rank: int):
    """torch.profiler over the run (CPU activity, and the card's where the
    run is on one), written as a Chrome trace, trace.rank<rank>.json, into
    profile_dir: bfc_tpu's --profile (cli.py:181-194) with
    jax.profiler."""
    if not profile_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if device != "cpu":
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(profile_dir, f"trace.rank{rank}.json"))
    sys.stderr.write(f"[M::main] profiler trace written to {profile_dir}\n")


def _epilogue(argv: List[str]) -> None:
    sys.stderr.write(f"[M::main] Version: {VERSION}\n")
    sys.stderr.write("[M::main] CMD: bfc-tpu-torch " + " ".join(argv) + "\n")
    sys.stderr.write(
        f"[M::main] Real time: {ulog.realtime():.3f} sec; CPU: {ulog.cputime():.3f} sec\n"
    )
