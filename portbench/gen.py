"""The one generator of the benchmark's inputs: a genome from the
configuration's recipe and reads from the traffic mix's parameters, all
drawn from --seed with numpy, and the FASTQ file the program reads.

The recipe is bench.py's (lines 40-84), rewritten here: a random genome
with a share of it overwritten by copies of earlier segments (repeats),
reads drawn uniformly from both strands, and substitutions at a fixed
rate whose bases carry low qualities while the others carry high ones.
Read lengths are the same multiset for every seed (drawn from a fixed
stream, then put in the seed's order), so seeds change which reads come
and never how much work they make.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .reference.spectrum import Reads

LENGTH_STREAM = 0x5EED   # the fixed stream that draws the read lengths
CHUNK = 1 << 24          # bases made at once


def rng_for(seed: int, salt: int) -> np.random.Generator:
    """A generator for one use of a seed; any whole number works."""
    return np.random.default_rng(np.random.SeedSequence(
        [seed % (1 << 64), salt]))


def make_genome(recipe: dict, seed: int) -> np.ndarray:
    """Codes 0..3 [length]: random bases, then repeat_fraction of them
    overwritten by copies of repeat_segment-base segments."""
    rng = rng_for(seed, 1)
    glen = int(recipe["length"])
    seg = int(recipe.get("repeat_segment", 2000))
    g = rng.integers(0, 4, glen, dtype=np.uint8)
    for _ in range(int(glen * float(recipe.get("repeat_fraction", 0.0))) // seg):
        src = int(rng.integers(0, glen - seg))
        dst = int(rng.integers(0, glen - seg))
        g[dst:dst + seg] = g[src:src + seg]
    return g


def read_lengths(mix: dict, seed: int) -> np.ndarray:
    """The mix's read lengths, uniform in [lo, hi]: one multiset for all
    seeds, in the seed's order."""
    n = int(mix["reads"])
    lo, hi = (int(x) for x in mix["length"])
    lens = np.random.default_rng(LENGTH_STREAM).integers(lo, hi + 1, n)
    return lens[rng_for(seed, 2).permutation(n)].astype(np.int64)


def make_reads(recipe: dict, mix: dict, seed: int,
               n_reads: Optional[int] = None) -> Reads:
    """The mix's reads of the seed's genome: each from a uniform start on
    a strand picked with probability revcomp, each base substituted with
    probability error_rate (quality drawn from qual_error) or kept
    (quality from qual_ok).  n_reads, where given, keeps only the first
    n_reads (tests)."""
    g = make_genome(recipe, seed)
    lens = read_lengths(mix, seed)
    if n_reads is not None:
        lens = lens[:n_reads]
    rng = rng_for(seed, 3)
    n = len(lens)
    offs = np.zeros(n, np.int64)
    if n:
        offs[1:] = np.cumsum(lens)[:-1]
    total = int(lens.sum())
    codes = np.empty(total, np.uint8)
    quals = np.empty(total, np.uint8)
    starts = rng.integers(0, len(g) - lens + 1)
    rc = rng.random(n) < float(mix.get("revcomp", 0.5))
    err_rate = float(mix["error_rate"])
    qe_lo, qe_hi = (int(x) for x in mix["qual_error"])
    qo_lo, qo_hi = (int(x) for x in mix["qual_ok"])
    # base i of a read lies at first + step * i of the genome, step -1 on
    # the reverse strand, whose bases are complemented (c ^ 3)
    step = np.where(rc, -1, 1)
    first = np.where(rc, starts + lens - 1, starts)
    # whole reads a chunk, so each chunk's draws depend only on its reads
    bounds = np.searchsorted(np.cumsum(lens), np.arange(CHUNK, total, CHUNK),
                             side="right")
    for a, b in zip(np.r_[0, bounds], np.r_[bounds, n]):
        if b <= a:
            continue
        ln = lens[a:b]
        base = int(offs[a])
        m = int(ln.sum())
        comp = (rc[a:b] * 3).astype(np.uint8)
        if (ln == ln[0]).all():   # one length: reads as rows
            rows = np.lib.stride_tricks.sliding_window_view(
                g, int(ln[0]))[starts[a:b]]
            r = rc[a:b]
            rows[r] = rows[r, ::-1] ^ 3
            flat = rows.reshape(-1)
        else:
            at = np.arange(base, base + m)
            pos = np.repeat(first[a:b] - step[a:b] * offs[a:b], ln) + \
                np.repeat(step[a:b], ln) * at
            flat = g[pos] ^ np.repeat(comp, ln)
        q = rng.integers(qo_lo, qo_hi + 1, m, dtype=np.uint8)
        err = np.flatnonzero(rng.random(m) < err_rate)
        flat[err] = (flat[err] + rng.integers(1, 4, len(err),
                                              dtype=np.uint8)) % 4
        q[err] = rng.integers(qe_lo, qe_hi + 1, len(err), dtype=np.uint8)
        codes[base:base + m] = flat
        quals[base:base + m] = q + 33
    return Reads(codes, quals, lens, offs)


def read_name(i: int) -> str:
    return "r%08d" % i


def write_fastq(path: str, reads: Reads) -> int:
    """Records @r%08d / bases / + / qualities, built as byte arrays a
    chunk of reads at a time.  Returns the bytes written."""
    n = len(reads.lens)
    if n > 10 ** 8:
        raise ValueError("read names hold 8 digits")
    written = 0
    cum = np.cumsum(reads.lens)
    bounds = np.searchsorted(cum, np.arange(CHUNK, int(cum[-1]) if n else 0,
                                            CHUNK), side="right")
    with open(path, "wb") as f:
        for a, b in zip(np.r_[0, bounds], np.r_[bounds, n]):
            if b > a:
                out = _records(reads, a, b)
                out.tofile(f)
                written += out.size
    return written


def _records(reads: Reads, a: int, b: int) -> np.ndarray:
    """The FASTQ bytes of reads [a, b)."""
    acgt = np.frombuffer(b"ACGTN", np.uint8)
    ln = reads.lens[a:b]
    base, m = int(reads.offs[a]), int(ln.sum())
    ids = np.arange(a, b)
    head = np.empty((b - a, 11), np.uint8)
    head[:, :2] = [ord("@"), ord("r")]
    head[:, 2:10] = 48 + (ids[:, None] // 10 ** np.arange(7, -1, -1)) % 10
    head[:, 10] = 10
    seq = acgt[reads.codes[base:base + m]]
    qual = reads.quals[base:base + m]
    if (ln == ln[0]).all():   # one length: one row a record
        L = int(ln[0])
        rec = np.empty((b - a, 15 + 2 * L), np.uint8)
        rec[:, :11] = head
        rec[:, 11:11 + L] = seq.reshape(-1, L)
        rec[:, 11 + L:14 + L] = [10, ord("+"), 10]
        rec[:, 14 + L:14 + 2 * L] = qual.reshape(-1, L)
        rec[:, -1] = 10
        return rec.reshape(-1)
    size = 15 + 2 * ln
    at = np.zeros(b - a, np.int64)
    at[1:] = np.cumsum(size)[:-1]
    out = np.empty(int(size.sum()), np.uint8)
    out[at[:, None] + np.arange(11)] = head
    j = np.arange(m) - np.repeat(reads.offs[a:b] - base, ln)
    seq_at = np.repeat(at + 11, ln) + j
    out[seq_at] = seq
    out[(at + 11 + ln)[:, None] + np.arange(3)] = [10, ord("+"), 10]
    out[seq_at + np.repeat(ln, ln) + 3] = qual
    out[at + size - 1] = 10
    return out


def read_text(reads: Reads, i: int):
    """Read i's (sequence, quality) strings."""
    a, n = int(reads.offs[i]), int(reads.lens[i])
    acgt = np.frombuffer(b"ACGTN", np.uint8)
    return (acgt[reads.codes[a:a + n]].tobytes().decode(),
            reads.quals[a:a + n].tobytes().decode())


def sample_ids(lens: np.ndarray, count: int, seed: int) -> np.ndarray:
    """The sorted reads whose records the check compares: the longest
    read (the first of them) and count - 1 more drawn from the seed."""
    n = len(lens)
    longest = int(np.argmax(lens)) if n else 0
    rest = np.delete(np.arange(n), longest) if n else np.arange(0)
    pick = rng_for(seed, 4).choice(rest, min(count, n) - 1, replace=False) \
        if n and count > 1 else np.arange(0)
    return np.sort(np.r_[longest, pick].astype(np.int64)) if n else pick


def scratch_path(name: str) -> str:
    """A path for the input file under TMPDIR (the run's own)."""
    import tempfile

    d = tempfile.mkdtemp(prefix="portbench-")
    return os.path.join(d, name)
