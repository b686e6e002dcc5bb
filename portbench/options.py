"""A configuration's command-line flags, made into options twice: for the
program, as `python -m bfc_tpu_torch` makes them (its Opts, its -s
parser), and for the reference, by the benchmark's own reading of bfc's
flags (bfc.c:55-158).  The two are made apart, so a program that reads a
flag otherwise than bfc does shows in the check."""

from __future__ import annotations

import getopt
import re
from typing import List

from .reference import scalar as S

# the flags a configuration may give, with bfc's meaning (output options
# such as -Q and -D are left out: the check reads FASTQ records, one a read)
SHORT = "s:k:b:H:c:q:w:1"


def parse_size(s: str) -> int:
    """bfc's -s: a leading float, the first character after it picking
    k, m or g (bfc.c:112-121), plus one."""
    m = re.match(r"\s*[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?", s)
    x = float(m.group(0)) if m else 0.0
    rest = s[m.end():] if m else s
    x *= {"g": 1e9, "m": 1e6, "k": 1e3}.get(rest[:1].lower(), 1.0)
    return int(x) + 1


def _apply(opt, flags: List[str], size) -> None:
    optlist, args = getopt.getopt(flags, SHORT)
    if args:
        raise ValueError(f"flags {flags}: unexpected arguments {args}")
    for flag, val in optlist:
        if flag == "-s":
            opt.apply_genome_size(size(val))
        elif flag == "-k":
            opt.k = int(val)
        elif flag == "-b":
            opt.bf_shift = int(val)
        elif flag == "-H":
            opt.n_hashes = int(val)
        elif flag == "-c":
            opt.min_cov = int(val)
        elif flag == "-q":
            opt.q = int(val)
        elif flag == "-w":
            opt.win_multi_ec = int(val)
        elif flag == "-1":
            opt.filter_mode = True


def program_opts(flags: List[str]):
    """The program's Opts for flags, through its own -s parser."""
    from bfc_tpu_torch.cli import parse_size as program_size
    from bfc_tpu_torch.opts import Opts

    opt = Opts()
    _apply(opt, flags, program_size)
    return opt


def reference_opts(flags: List[str]) -> S.Opts:
    opt = S.Opts()
    _apply(opt, flags, parse_size)
    return opt
