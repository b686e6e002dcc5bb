"""Drop-in compatible CLI (reference surface: bfc.c:55-158).

Usage: python -m bfc_tpu_torch [options] <to-count.fq> [to-correct.fq]

The flag parsing of bfc_tpu's CLI.  Runs on the CUDA card unless --cpu
asks for the CPU, where every kernel's plain version runs instead.
Modes that later slices of the port bring raise NotImplementedError
naming their ROADMAP item.
"""

from __future__ import annotations

import getopt
import sys
from typing import List, Optional

from . import __version__
from .opts import Opts
from .utils import log as ulog

VERSION = f"torch-{__version__}(r181-compat)"


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
    fp.write("  --batch INT     reads per correction batch [8192]\n")
    fp.write("  --cpu           run on the CPU (the kernels' plain versions)\n")
    fp.write("  --mesh INT      shard over INT devices\n")


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


def _not_in_slice(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opt = Opts()
    no_ec = False
    batch_reads = 8192
    device = "cuda"
    ulog.reset_clock()
    try:
        optlist, args = getopt.getopt(
            argv, "hvV:Ed:k:s:b:L:t:C:H:q:Jr:c:w:D1QR",
            ["batch=", "cpu", "mesh="],
        )
    except getopt.GetoptError as e:
        sys.stderr.write(f"bfc-tpu-torch: {e}\n")
        usage(sys.stderr, opt)
        return 1
    for flag, val in optlist:
        if flag == "-d":
            _not_in_slice("-d (dump)", "8")
        elif flag == "-r":
            _not_in_slice("-r (restore)", "8")
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
            _not_in_slice("-R (refine)", "8")
        elif flag == "-D":
            opt.discard = True
        elif flag == "-1":
            _not_in_slice("-1 (trim)", "7")
        elif flag == "-Q":
            opt.no_qual = True
        elif flag == "-J":
            opt.no_mt_io = True
        elif flag == "-E":
            no_ec = True
        elif flag == "-V":
            opt.verbose = int(val)
            ulog.verbosity = opt.verbose
            if opt.verbose >= 4:
                _not_in_slice("-V4 (search trace)", "8")
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
        elif flag == "--mesh":
            if int(val) > 1:
                _not_in_slice("--mesh (multiple devices)", "11")
    if not args:
        usage(sys.stderr, opt)
        return 1

    from .models import device_pipeline as DP

    # stream records to stdout as batches finish (O(batch) memory, the
    # reference's pipeline behavior)
    DP.run_device(opt, args[0], correct_fn=args[1] if len(args) > 1 else None,
                  no_ec=no_ec, batch_reads=batch_reads,
                  sink=sys.stdout.buffer, device=device)
    sys.stderr.write(f"[M::main] Version: {VERSION}\n")
    sys.stderr.write("[M::main] CMD: bfc-tpu-torch " + " ".join(argv) + "\n")
    sys.stderr.write(
        f"[M::main] Real time: {ulog.realtime():.3f} sec; CPU: {ulog.cputime():.3f} sec\n"
    )
    return 0
