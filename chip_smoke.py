"""Smoke run of bfc_tpu_torch on one CUDA card: builds the eighteen
kernels, drives the count + correct main path and the trim path (-1) at
E. coli scale, with the host finalize, with the device finalize, over a
mesh of ranks with the table replicated and sharded, and from a dump
(-d/-r), then the probe path (chip_probe.py), -R over the main path's
output, a --profile run, the counting spill to the host, on one card
and over the mesh, the human-scale rehearsal tool at a small size and
reads of 300-3,000 bp, and holds every kernel against its plain PyTorch
version.

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
   same spectrum must give byte-identical records, and at most 0.1% of
   the reads may fall back to the scalar model.  The run dumps its
   spectrum (-d) for phase 14, timed apart from both phases; the report
   gives the counting's and the correction's device memory peaks.
3. The counting against plain versions: the main path's counting tree is
   built again from the same reads with KB held against its plain
   version on every merge (up to the final fold of ~50M rows), and must
   fold to the main path's number of distinct k-mers; KB is timed on the
   top merge's input (the median of 7 calls); KE is held against
   its plain version on that fold, timed as calls and, on the fold and on
   its first SPAN_ROWS rows (a spilled span of phase 18 (a)), as a CUDA
   graph's replay, and the fold's pull is timed unpacked and packed (KE)
   in turns.  Then the card's count of the first 80,000
   reads (~9 batches) must equal a plain count of them on the CPU,
   aggregate field for field and finalized spectrum.
4. Each of KA-KD against its plain version on the same CUDA tensors at
   the main path's shapes (KA and KB: a 16,384-read counting batch of 128
   slots; KC and KD: the main path's correction batch of 100 bp reads,
   as the reader cuts it, KD's plain version on its first 512 reads, and
   KD on its first 8,192 reads and on 65,536 reads, the batch's cap, equal
   to KD on the batch there) with the k = 23 spectrum of phase 2, then
   again at k = 33 on a spectrum of the first 200,000 reads.  KA and KC
   also on 4,096 rows of 600 slots (six reads end to end, lengths ending
   mid-chunk).  KB and KD are timed as the median of 7
   calls, KD at the three sizes (us a read, G sectors/s of the spec's
   probes), beside KD's registers, local memory, blocks an SM and a
   batch's peak memory; KA and KC as calls and as kernels (CUDA graphs),
   KC with its sectors a second and, at the end, against the
   random-sector rate that phase 15 measures (KC's ceiling).
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
   the aggregate's kept rows; KH on an 8,192-read trim batch and on 4,096
   rows of 600 slots (timed as a call and as a kernel).  Then the
   card's -1 -k51 count of the first 80,000 reads must give the plain
   CPU run's aggregate, keep set and Bloom bits; and `-1 -k51 -b35` on
   those reads twice: from arrival 0 it must take the verdict from KF
   (KI silent), from 2^33 from KI (KF silent), and both outputs must
   hash equal to the --cpu run.
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
9. The finalize kernels against their plain versions and the host: KF
   (arrivals from 0) and KI (from 0 and from 2^33) on the main fold
   (49.8M rows, -b30), the trim fold (63.1M rows, -b33) and the main fold
   at -b24, where a Bloom block holds over 1,000 rows, each against its
   plain version and the host's exact replay; KJ and KK on the main fold;
   KL on the main fold's kept entries, which must be in (shard, keybody)
   order, built from them and from a seeded shuffle of them, each table
   compared by lookups of every fold row with its plain version's; timed
   as a call (also shuffled) and as its device work.
10. The main path over the mesh, as `python -m bfc_tpu_torch --mesh R -s 5m
   reads.fq` runs it, through the launcher (parallel/multihost.py) on the
   same reads: (a) R = torch.cuda.device_count() ranks over NCCL (one rank
   on a one-card machine, whose all_to_alls send to itself); (b) two ranks
   sharing cuda:0 over gloo, whose exchanges are staged through host
   memory.  Each rank's launch counts start at 0 in its new process and
   are read at its end; in every rank KA, KM, KB, KJ, KI, KK, KL, KC and
   KD must have launched and KE and KF not, and each output must hash as
   phase 2's.  A rank that fails fails the run.  Then (c) one NCCL rank
   reading the counting input from stdin (`--mesh 1 -s 5m - reads.fq <
   reads.fq`, which the launcher spools once) must hash as phase 2's.
11. KM against its plain version: by the prefix rule on the counting
   batch's KA rows (16,384 reads x 128 slots) at R = 1, 2, 3, 4, 8 and
   256, by the Bloom-block rule on the main fold's (ret, arrival) rows at
   R = 1, 2, 8 and 256, and by both rules on one row, two tiles and 5
   rows, and a tile of dropped rows at R = 3 and 256; timed at R = 2 as a
   call and as its launches alone.
12. The main path over the mesh with the sharded table
   (BFC_TPU_SHARD_TABLE=1, `--mesh R -s 5m`) through the launcher, on the
   same reads: (a) device_count() NCCL ranks; (b) two gloo ranks sharing
   cuda:0, where each rank reads its peer's sub-table through a CUDA IPC
   mapping.  In every rank KA, KM, KB, KJ, KI, KK, KN, KC and KD must have
   launched and KL, KE and KF not; the report must say "sharded", and
   each output must hash as phase 2's.  Each rank's sub-table bytes are
   printed beside the replicated table's.
13. KN against its plain version: the main fold's kept entries (which
   must be in order) split by owner at R = 2, 4 and 8, each rank's
   sub-table built by KN from its keys in order and shuffled and by the
   plain version, compared by lookups of every kept entry and 1,000,000
   seeded other keys with the replicated table (KL); timed at R = 2 as a
   call, as a call into a table made beforehand (the mesh's form) and as
   its device work; then KC and KD on the main path's correction
   batch over those R sub-tables, held in one process behind one address
   array, equal to KC and KD on the replicated table and to their plain
   versions (KD's on its first 512 reads).
14. -r: the reads corrected from phase 2's dump on the card (KC and KD
   must launch, KA not), then over two gloo ranks with the sharded table
   (KN in every rank); both outputs must hash as phase 2's.
15. The probe path (chip_probe.run): every pl.pallas_call site of the TPU
   probe scripts at its own shapes, and KO and KR over 256 MiB, through
   KO-KR in every mode and variant, launch counts zeroed just before and
   read just after (each of KO-KR must have launched, once a site); each
   output held exactly against its plain version, KP's route (shared or
   global, by the shapes and steps) and KR's (eager or lazy, by the
   queries) printed, then timed beside its plain version and the matching
   PyTorch library call.
16. -R, as `python -m bfc_tpu_torch -s 5m -R reads.fq corrected.fq` runs it
   with the device finalize: run_device counting the 3,000,000 reads and
   refining phase 2's output, launch counts zeroed just before and read
   just after: KA and KB must have launched and KE not.  Every record of
   that output has had ec_code 0 and max_heap below 50, so -R skips all
   of them and the output must equal its input (where one is not
   skipped, KC and KD must have launched instead).  Then the same over phase 2's
   output with its tags mangled (every third dropped, every seventh other
   one foreign, a '!' quality in every fourteenth: mangle_tags), where
   KA, KB, KC and KD must have launched and KE not.  Its output must hold
   one record per input record, 1,000 seeded records (half of them among
   those whose own comment is no skipped tag) must equal the scalar
   model's refine of the same input records byte for byte
   (pipeline.correct_read: refmodel.ec1 with the comment each record
   inherits and the stats carried to it, on the same table), and at most
   0.1% of the reads sent to KC and KD may fall back to the scalar model.
   Printed for both: the shares of reads skipped, refined, reverted and
   failed; the walls of counting, KC + KD, the host bookkeeping and the
   emit; the correction's peak.
17. --profile: the CLI on the card (`-s 5m --profile DIR`, in this
   process) over the first 80,000 reads.  The trace must exist and hold
   CUDA kernel events of KC and KD (they launch through ctypes), and the
   output must hash as the same run's without --profile.  Printed: the
   kernels the trace holds and the share of the traced wall in which the
   card ran one.
18. The counting spill, over the first 1,000,000 of phase 2's reads (a
   third, for the time limit), first run unspilled with the host
   finalize (with -d) and with the device finalize, which must hash
   equal; then each run through run_device with its launch counts zeroed
   just before and read just after, and every AggBuilder it makes
   collected: (a) -s 5m with
   BFC_TPU_MAX_MERGE_CAP=4194304 (bfc_tpu's default cap, set in this
   process), host finalize; (b) the same with the device finalize, where
   the verdict (KF, or KI from 2^32 arrivals), KK and KL must launch on
   the aggregate uploaded from the host and KJ must not (the spilled
   aggregate comes with ret); (c) no cap, with a torch.empty ballast on
   the card that leaves 2 GiB of device_free_bytes, so that the tree
   spills on the byte rule alone; (d) -1 -k51 with the cap of (a), in a
   process of its own (this script with --spill-trim, its launches
   counted there, after an unspilled -1 run there) beside (a) and (b),
   since at k = 51 the host merges take the lexsort and last minutes;
   (c) starts once (d) has ended, as
   its ballast needs the card alone.  In each the tree must spill at
   least once, KE must launch once for each spilled span (with a spill
   the last levels spill too, so there is no other pull), and the output
   must hash as the unspilled run's.  Printed for
   each: spills and rows spilled, KE's call on each spilled span (CUDA
   events) beside its bound, the pack seconds on the counting thread and
   the worker threads' copy and host-merge seconds (LsmTree.timings), the
   rows the host merges took in, the counting wall beside the unspilled
   run's, the device peak beside the ballast, the process's host peak
   RSS so far (VmHWM; also before (a)) and the launches; for (a) KA's
   and KB's launches beside the unspilled run's; for (c) the ballast and
   the free bytes it left.
19. The mesh's counting spill, beside phase 18 (d) once (a) and (b) have
   ended: phase 18's reads over two gloo ranks sharing cuda:0 through the
   launcher (`--mesh 2 -s 5m`) under BFC_TPU_MAX_MERGE_CAP=4194304, (a)
   with the replicated table and -d, (b) with the sharded table.  Every
   rank must spill at least once and rank 0 must finalize on the host;
   in every rank KA, KM, KB, KE, KC, KD and KL (a) or KN (b) must have
   launched and KJ, KF, KI and KK not; each output must hash as phase
   18's unspilled run, and (a)'s dump as its dump.  Printed for each:
   every rank's spills, rows spilled and KE launches, the counting wall
   beside the unspilled single-card run's, rank 0's gather, finalize and send
   seconds, and the peak resident set of the two ranks together (sampled
   from /proc every half second).
20. The human-scale rehearsal (bfc_tpu_torch/tools/human_scale.py) in a
   process of its own, BFC_TPU_MAX_MERGE_CAP unset: 2M reads of 100 bp
   from a 10 Mb genome at k = 27, a ballast leaving 4 GiB of the card
   free through the counting, both finalizes on the one aggregate.  The
   tree must spill on the byte rule alone, every check of the tool must
   pass (4,096 sampled keys tallied from KA's rows against the final
   aggregate, its key order, the two finalizes' entries, 1,000 records
   against refmodel.ec1), and KA, KB, KE, a verdict kernel, KK, KL, KC
   and KD must have launched.  Printed: the tool's report (spills, rows,
   walls, device peaks, host peak RSS, correction rate, fallback).
21. Reads over 504 bp: 200,000 reads of 300-590 bp (merged MiSeq 2x300
   pairs) and 1,000 of 1,000-3,000 bp, lengths drawn uniformly and the
   reads shuffled, from a seeded 5 Mb genome with 1% errors on low
   qualities.  `-s 5m` with each finalize (counts zeroed just before and
   read just after each; phase 2's or 7's kernels must launch): one
   record a read, the two outputs hashed equal; 1,000 seeded reads, half
   over 600 bp, byte-identical to refmodel.ec1 on the host finalize's
   table.  `-1 -k51`: 1,000 seeded reads trimmed as refmodel.trim_read
   over the card's Bloom words.  The scalar checks run in processes of
   their own while KC and KD run on each band's reads (KD timed, the
   median of 3 calls a batch) at STACK_CAP: the reads past KD's stack
   must be the run's scalar fallback,
   at most 0.1% of the reads of at most 590 bp (the longer band's share
   is printed).  Printed: the walls, KC's and KD's launches, KD's us a
   read by band, the reads past its stack, and the widest batch the
   reader made.

The tolerance is exact equality throughout: every output is an integer.
Kernel times ("ms") of KA-KN are CUDA-event means of repeated wrapper
calls from Python after a warm-up (KB and KD: the median of 7 calls, each
timed alone), the host's cost of a call included; KO-KR's, and KA's,
KC's, KH's, KL's, KM's and KN's "kernel_ms", are the median replay of a
CUDA graph of repeated calls (chip_probe.py; KM's of its launches alone,
KL's and KN's of their device work: the counters cleared and the five
kernels), the host's cost excluded.  Each row of the kernels line
says which ("timing", "kernel_timing").

The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or outside the
repository, the script exits non-zero before printing either.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import re
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from bfc_tpu_torch import cli, kernels
from bfc_tpu_torch.io import fast_reader as FR
from bfc_tpu_torch.io.fastq import Read, format_corrected, pack_stats
from bfc_tpu_torch.io.writer import OutputWriter
from bfc_tpu_torch.models import counter as C
from bfc_tpu_torch.models import device_pipeline as DP
from bfc_tpu_torch.models import refmodel as M
from bfc_tpu_torch.models import trimmer as TT
from bfc_tpu_torch.ops import annotate as ann
from bfc_tpu_torch.ops import kmer as kops
from bfc_tpu_torch.ops import route
from bfc_tpu_torch.ops import search as srch
from bfc_tpu_torch.ops import spectrum as spec
from bfc_tpu_torch.ops import spectrum_dense as sdn
from bfc_tpu_torch.ops import spectrum_host as sph
from bfc_tpu_torch.ops.spectrum import IntProbe
from bfc_tpu_torch.opts import Opts
from bfc_tpu_torch.parallel import multihost

import chip_probe
from chip_probe import SECTOR, bound, card_line, compare, graph_ms

# A u64 add, shift or logic op counts as two 32-bit integer ops (the peak
# rates and bound are chip_probe.py's).
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
OPS_KM_ROW = 2 * 12   # the destination rule, twice, and a rank

COUNT_B, COUNT_L = 16384, 128   # run_device's counting batch (padded to 32)
LONG_B, LONG_L = 4096, 600      # KA and KC on rows of 600 slots
# the probe path's saturated random-sector sites (4,194,304 queries over
# 256 MiB), whose rate is KC's ceiling
SATURATED_SITES = ("hbm_KO_q4194304", "hbm_KR_q4194304")
CORR_B_PR6 = 8192               # the correction batch before KD's redesign
MEDIAN_REPS = 7                 # timed calls of KB and KD, each on its own
KD_PLAIN_READS = 512
SAMPLE_READS = 1000
HEAD_READS = 80_000             # ~9 counting batches for the plain count
TRIM_K = 51                     # README's trim command: -1 -k51 (-b33)
TRIM_B, TRIM_L = 8192, 128      # Trimmer.trim_file's batch (L padded to 32)
ABSENT_KEYS = 1_000_000         # seeded keys probed in both tables
FAR = 1 << 33                   # arrivals from here take the KI verdict
WIDE_B = 35                     # -b35: KF from arrival 0, KI from 2^33
HOT_B = 24                      # the main fold at -b24: ~1,500 rows a block


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


# --------------------------------------------------------------------------
# Seeded synthetic reads (bench.py's genome recipe), written with numpy
# --------------------------------------------------------------------------

def make_genome(glen: int, rng) -> np.ndarray:
    """A genome of glen random bases with 10% of it in repeats of 2 kb."""
    g = rng.integers(0, 4, glen).astype(np.uint8)
    seg = 2000
    for _ in range(int(glen * 0.1) // seg):
        src = int(rng.integers(0, glen - seg))
        dst = int(rng.integers(0, glen - seg))
        g[dst:dst + seg] = g[src:src + seg]
    return g


def make_reads(glen: int, seed: int, cov: int = 60, rlen: int = 100):
    """Seeded genome with 10% repeats and its reads: (bases u8 codes
    [n, rlen], quals u8 ASCII [n, rlen])."""
    rng = np.random.default_rng(seed)
    g = make_genome(glen, rng)
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

def cuda_median_ms(fn, reps: int = MEDIAN_REPS) -> float:
    """Median milliseconds of fn() on the card over reps runs, each timed
    by its own pair of CUDA events, after one."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


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


def call_peak(fn) -> int:
    """Device bytes that one call of fn allocates above what was held."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def cuckoo_bound(n: int, table_bits: int):
    """KL's and KN's bound for n keys into 2^table_bits slots: what any
    build must move, 20 bytes read a key (shard, keybody, payload) and
    the table written once; and the first design's, which also counted
    a random 32-byte sector written a key (its atomic exchange)."""
    table = 8 << table_bits
    return (bound(n * 20 + table, n * OPS_PROBE),
            bound(n * (20 + SECTOR) + table, n * OPS_PROBE))


def verdict_bound(rows: int, kernel: str):
    """KF's and KI's bound: each row's inputs read once and its outputs
    written once (KF ret 8, arr 4, n 4, fp 1, keep 1 = 18 bytes; KI ret
    8, arr 8, fp 1 = 17), and one row's Bloom addressing."""
    return bound(rows * (18 if kernel == "KF" else 17), rows * OPS_BLOOM)


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


def corr_batch(bases, quals, opt, dev, first: int, n: int):
    """n reads as Corrector.device_step hands them to KC and KD."""
    b = bases[first:first + n]
    q = (quals[first:first + n].astype(np.int32) - 33 >= opt.q) & (b <= 3)
    lens = np.full((len(b),), b.shape[1], np.int32)
    return (torch.from_numpy(np.ascontiguousarray(b)).to(dev),
            torch.from_numpy(q).to(dev), torch.from_numpy(lens).to(dev))


def long_batch(bases, quals, opt, dev):
    """LONG_B rows of LONG_L slots: six reads after the counting batch end
    to end, lengths from LONG_L - 50 to LONG_L (most ending mid-chunk),
    as KA and KC would take reads of up to LONG_L bases."""
    rng = np.random.default_rng(LONG_L)
    n = LONG_L // bases.shape[1]
    first = COUNT_B
    b = bases[first:first + LONG_B * n].reshape(LONG_B, -1)
    q = quals[first:first + LONG_B * n].reshape(LONG_B, -1)
    q = (q.astype(np.int32) - 33 >= opt.q) & (b <= 3)
    lens = rng.integers(LONG_L - 50, LONG_L + 1, LONG_B).astype(np.int32)
    return (torch.from_numpy(np.ascontiguousarray(b)).to(dev),
            torch.from_numpy(q).to(dev), torch.from_numpy(lens).to(dev))


def kc_sectors(t, b, q, lens, k: int, l_pre: int):
    """(probes, sectors) of KC on these reads: one probe at every slot
    where a full ACGT k-mer ends, of one sector, and one more where the
    first nest misses (KC loads the second only then)."""
    shard, keybody, _, _ = kops.kmer_stream_plain(b, q, lens, k, l_pre)
    valid = shard != kops.INVALID_SHARD
    shard, keybody = shard[valid], keybody[valid]
    _, s1, _, qlow = spec.subtable_slots(shard, keybody, t.l_pre, t.kb_bits,
                                         t.c_bits, 0)
    e1 = t.table[s1]
    hit = ((e1 & 0x3FFF) != 0) & (((e1 >> 14) & 1) == 0) & \
        (kops.srl(e1, 15) == qlow)
    probes = int(valid.sum())
    return probes, probes + int((~hit).sum())


def tally(r, got, want) -> None:
    """Add a comparison to a kernel's max_abs_err and mismatches."""
    err, bad = compare(got, want)
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["mismatches"] += bad if bad >= 0 else 1


# --------------------------------------------------------------------------
# Kernel checks
# --------------------------------------------------------------------------

def check_kernels(opt, ds, bases, quals, dev, timed: bool, corr_reads: int):
    """Each kernel against its plain version at the main path's shapes
    (corr_reads: the main path's correction batch).  Returns {name:
    {max_abs_err, and when timed: ms, plain_ms, bound}}."""
    k, l_pre = opt.k, opt.effective_l_pre()
    carry = not sdn.ret_derivable(k, l_pre)
    res = {}

    # KA: one counting batch; ret checked too, timed as the main path runs
    cb, cq, cl = count_batch(bases, quals, opt, dev)
    ka = kops.kmer_stream(cb, cq, cl, k, l_pre, 0, with_ret=True)
    ka_p = kops.kmer_stream_plain(cb, cq, cl, k, l_pre, 0, True)
    r = dict(zip(("max_abs_err", "mismatches"), compare(ka, ka_p)))
    # and LONG_L slots
    lb, lq, ll = long_batch(bases, quals, opt, dev)
    tally(r, kops.kmer_stream(lb, lq, ll, k, l_pre, 0, with_ret=True),
          kops.kmer_stream_plain(lb, lq, ll, k, l_pre, 0, True))
    if timed:
        slots = COUNT_B * COUNT_L
        valid = int((ka[0] != kops.INVALID_SHARD).sum())
        call = lambda: kops.kmer_stream(cb, cq, cl, k, l_pre, 0,
                                        with_ret=carry)
        r["ms"] = cuda_ms(call, 20)
        r["kernel_ms"] = graph_ms([call], chip_probe.REPS)
        r["kernel_ms_long"] = graph_ms([lambda: kops.kmer_stream(
            lb, lq, ll, k, l_pre, 0, with_ret=carry)], chip_probe.REPS)
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
        r["ms"] = cuda_median_ms(lambda: sdn.run_combine(srt))
        r["plain_ms"] = cuda_ms(lambda: sdn.run_combine_plain(srt), 3)
        r["bound"] = bound((N + Cn) * row, N * OPS_KB_ROW)
        r["rows"] = N
    res["run_combine"] = r

    # KC and KD: the main path's correction batch of the reads after the
    # counting batch; KD also on its first 8,192 reads (the batch before
    # PR 7) and, timed, on CORRECT_BATCH reads (the batch's cap)
    t = ds.table
    cap = max(srch.CORRECT_BATCH, corr_reads)
    bc, qc, lc = corr_batch(bases, quals, opt, dev, COUNT_B, cap)
    b, q, lens = (x[:corr_reads] for x in (bc, qc, lc))
    kc = ann.kcov_island(t, b, lens, opt.min_cov)
    kc_p = ann.kcov_island_plain(t, b, lens, opt.min_cov)
    r = dict(zip(("max_abs_err", "mismatches"), compare(kc, kc_p)))
    # and LONG_L slots
    tally(r, ann.kcov_island(t, lb, ll, opt.min_cov),
          ann.kcov_island_plain(t, lb, ll, opt.min_cov))
    B, L = b.shape
    if timed:
        probes, sectors = kc_sectors(t, b, q, lens, k, l_pre)
        call = lambda: ann.kcov_island(t, b, lens, opt.min_cov)
        r["ms"] = cuda_ms(call, 20)
        r["kernel_ms"] = graph_ms([call], chip_probe.REPS)
        r["sectors"] = sectors
        r["sectors_per_s"] = sectors / (r["kernel_ms"] * 1e-3)
        r["kernel_ms_long"] = graph_ms([lambda: ann.kcov_island(
            t, lb, ll, opt.min_cov)], chip_probe.REPS)
        m = min(CORR_B_PR6, B)
        r["ms_8192"] = cuda_ms(
            lambda: ann.kcov_island(t, b[:m], lens[:m], opt.min_cov), 20)
        r["plain_ms"] = cuda_ms(
            lambda: ann.kcov_island_plain(t, b, lens, opt.min_cov), 2)
        r["probes"] = probes
        # the sectors the function needs: a probe's second nest only where
        # the first misses (bound_ms_two_sectors counts two a probe)
        r["bound"] = bound(B * L * 7 + B * 16 + sectors * SECTOR,
                           probes * OPS_PROBE)
        r["bound_ms_two_sectors"] = bound(
            B * L * 7 + B * 16 + probes * 2 * SECTOR, probes * OPS_PROBE)[0]
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
    # the PR 6 batch and the cap: the same reads give the same results and
    # overflow set
    m = min(CORR_B_PR6, B)
    small = tuple(x[:m] for x in (b, q, lens, lcov, hcov, isl))
    kd8 = srch.ec1_search(t, opt, ds.mode, *small)
    _, n8 = compare(kd8, [x[:m] for x in kd])
    r["mismatches"] += n8 if n8 >= 0 else m
    kc_cap = ann.kcov_island(t, bc, lc, opt.min_cov)
    big = (bc, qc, lc, *kc_cap[1:])
    kd_cap = srch.ec1_search(t, opt, ds.mode, *big)
    _, nc = compare([x[:B] for x in kd_cap], kd)
    r["mismatches"] += nc if nc >= 0 else B
    r["reads"], r["cap_reads"] = B, cap
    if timed:
        probes = int(kd[1][:, srch.PROBES].sum())
        probes8 = int(kd[1][:m, srch.PROBES].sum())
        r["ms"] = cuda_median_ms(lambda: srch.ec1_search(
            t, opt, ds.mode, b, q, lens, lcov, hcov, isl))
        r["ms_8192"] = cuda_median_ms(lambda: srch.ec1_search(
            t, opt, ds.mode, *small))
        r["ms_cap"] = cuda_median_ms(lambda: srch.ec1_search(
            t, opt, ds.mode, *big))
        probes_cap = int(kd_cap[1][:, srch.PROBES].sum())
        r["us_per_read"] = r["ms"] * 1e3 / B
        r["us_per_read_8192"] = r["ms_8192"] * 1e3 / m
        r["us_per_read_cap"] = r["ms_cap"] * 1e3 / cap
        r["sectors_per_s_cap"] = probes_cap * 2 / (r["ms_cap"] * 1e-3)
        r["spec_probes"] = probes
        r["sectors_per_s"] = probes * 2 / (r["ms"] * 1e-3)
        r["sectors_per_s_8192"] = probes8 * 2 / (r["ms_8192"] * 1e-3)
        plan = srch.kd_plan()
        r.update(registers=plan.registers, local_bytes=plan.local_bytes,
                 blocks_per_sm=plan.blocks_per_sm,
                 resident_threads=plan.blocks * plan.threads)
        # one batch's KC + KD above what is allocated before it
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kc2 = ann.kcov_island(t, b, lens, opt.min_cov)
        srch.ec1_search(t, opt, ds.mode, b, q, lens, *kc2[1:])
        torch.cuda.synchronize()
        r["batch_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        del kc2
        r["plain_ms"] = plain_s * 1e3
        r["plain_reads"] = n
        r["bound"] = bound(B * L * 5 + B * (16 + 4 * srch.N_OUT)
                           + probes * 2 * SECTOR, probes * OPS_PROBE)
        r["bound_ms_8192"] = bound(m * L * 5 + m * (16 + 4 * srch.N_OUT)
                                   + probes8 * 2 * SECTOR,
                                   probes8 * OPS_PROBE)[0]
        r["bound_ms_cap"] = bound(cap * L * 5 + cap * (16 + 4 * srch.N_OUT)
                                  + probes_cap * 2 * SECTOR,
                                  probes_cap * OPS_PROBE)[0]
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
        self.top = None  # the sorted input of the last (top) merge

    def _merge(self, a, b):
        srt = sdn.concat_sorted(a, b)
        got = sdn.run_combine(srt)
        err, n_diff = compare(got, sdn.run_combine_plain(srt))
        self.merges += 1
        self.max_rows = max(self.max_rows, len(srt))
        self.top = srt
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
    top = agg.top
    agg.top = None
    n_top, c_top = len(top), len(agg.folded)
    row = 8 * (6 if top.ret is not None else 5) + 1
    agg.top_kb = {"rows": n_top, "ms": cuda_median_ms(
        lambda: sdn.run_combine(top)), "bound": bound(
        (n_top + c_top) * row, n_top * OPS_KB_ROW)[0]}
    del top
    torch.cuda.empty_cache()
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


def drive(opt, fq: Path, out: Path, device_finalize: bool = False, **kw):
    """One run of run_device over fq into out (kw: its in_hash, out_hash),
    with every launch count zeroed just before and read just after.
    Returns (report, launches, device memory peak in bytes)."""
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    report = {}
    with open(out, "wb") as sink:
        DP.run_device(opt, str(fq), sink=sink, device="cuda", report=report,
                      device_finalize=device_finalize, **kw)
    launches = {k.name: k.launches for k in kernels.KERNELS.values()}
    # run_device resets the peak where the correction starts
    return report, launches, max(report.get("count_peak_bytes", 0),
                                 torch.cuda.max_memory_allocated())


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
    r["kernel_ms"] = graph_ms([lambda: sdn.pack_pull(run)], chip_probe.REPS)
    # a spilled span's size: the fold's first SPAN_ROWS rows, a sorted run
    span = sdn.Run(*(None if c is None else c[:SPAN_ROWS] for c in run))
    r["span_rows"] = len(span)
    r["kernel_ms_span"] = graph_ms([lambda: sdn.pack_pull(span)],
                                   chip_probe.REPS)
    r["bound_ms_span"] = bound(len(span) * (3 * 8 + 1 + 2 * 4),
                               len(span) * OPS_KE_ROW)[0]
    del span
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


def check_trim_kernels(agg, keep_path, bloom, opt, bases, quals, dev):
    """KF, KG and KH against their plain versions on the card at the trim
    path's shapes (KH also on LONG_B rows of LONG_L slots), and KF's
    verdicts against the host's exact replay.
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
    r["peak_bytes"] = call_peak(lambda: spec.adjudicate_sketch(ret, arr, n,
                                                               b, H))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.time()
    want = spec.adjudicate_sketch_plain(ret, arr, n, b, H)
    torch.cuda.synchronize()
    r["plain_ms"] = (time.time() - t0) * 1e3
    r.update(zip(("max_abs_err", "mismatches"), compare((fp, keep), want)))
    del want
    torch.cuda.empty_cache()
    r["bound"] = verdict_bound(rows, "KF")
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
    # and LONG_L slots
    lb, _, ll = long_batch(bases, quals, opt, dev)
    long_args = (bloom.words, lb, ll, opt.k, b, H)
    tally(r, (TT.max_streak_batch(*long_args),),
          (TT.max_streak_plain(*long_args),))
    probes = TRIM_B * max(bases.shape[1] - opt.k + 1, 0)
    r["ms"] = cuda_ms(lambda: TT.max_streak_batch(*args), 20)
    r["kernel_ms"] = graph_ms([lambda: TT.max_streak_batch(*args)],
                              chip_probe.REPS)
    r["kernel_ms_long"] = graph_ms([lambda: TT.max_streak_batch(*long_args)],
                                   chip_probe.REPS)
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


def check_trim_wide(fq: Path, tmp: Path):
    """`-1 -k51 -b35` on fq, on the card from arrival 0 (the verdict must
    be KF's, KI silent) and from 2^33 (KI's, KF silent), and on the CPU:
    both card outputs must hash as the CPU's.  Returns {verdict: (the
    card's report without its device tensors, launches)}: the -b35 Bloom
    filter alone is 4 GiB, which later phases' peaks would count."""
    o = Opts()
    o.k = TRIM_K
    o.filter_mode = True
    o.bf_shift = WIDE_B
    cpu_out = tmp / "trimmed_b35_cpu.fq"
    with open(cpu_out, "wb") as sink:
        DP.run_device(o, str(fq), sink=sink, device="cpu")
    want = file_hash(cpu_out)
    cpu_out.unlink()
    runs = {}
    for base, by, other in ((0, "KF", "first_occurrence"),
                            (FAR, "KI", "bloom_adjudicate")):
        out = tmp / "trimmed_b35.fq"
        with arrivals_from(base):
            rep, launches, _ = drive(o, fq, out)
        path = f"-1 -b{WIDE_B} from arrival {base}"
        if rep["verdict"] != by:
            fail(f"{path} took the {rep['verdict']} verdict, not {by}")
        need_launched(launches, ("bloom_build", "max_streak",
                                 "bloom_adjudicate" if by == "KF"
                                 else "first_occurrence"), path)
        need_silent(launches, (other,), path)
        if file_hash(out) != want:
            fail(f"{path}: the card's output differs from the CPU's")
        out.unlink()
        runs[by] = {k: v for k, v in rep.items()
                    if k not in ("bloom", "aggregate", "keep")}, launches
        del rep
        torch.cuda.empty_cache()
    return runs


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


def keys_in_order(shard, keybody) -> bool:
    """Whether int64 (shard, keybody) keys rise strictly, keybody compared
    as the u64 it holds: the order KL's and KN's callers promise, in which
    their scatter has nothing to do."""
    if shard.shape[0] < 2:
        return True
    ukb = keybody ^ (-(1 << 63))
    up = (shard[1:] > shard[:-1]) | ((shard[1:] == shard[:-1])
                                     & (ukb[1:] > ukb[:-1]))
    return bool(up.all())


def cuckoo_graph_ms(kern, geom, keys, table_bits: int) -> float:
    """KL's or KN's device work alone, as graph_ms times it: the
    counters cleared and the five kernels, on a table and scratch made
    beforehand, with no wait on the failure count."""
    table = torch.empty((1 << table_bits,), dtype=torch.int64,
                        device=keys[0].device)
    rec, meta = spec.cuckoo_scratch(keys[0].shape[0], table_bits,
                                    table.device)
    ms = graph_ms([lambda: spec.cuckoo_enqueue(kern, geom, *keys, table, rec,
                                               meta)], chip_probe.REPS)
    del table, rec, meta
    torch.cuda.empty_cache()
    return ms


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


def check_verdicts(ret, arr, n, b: int, H: int):
    """KF (arrivals from 0) and KI (from 0 and from 2^33) on one fold at
    -b, each against its plain version and the host's exact replay, timed
    (3 calls) with the plain version (one call) and a call's peak bytes.
    ret, arr, n int64 [C] on the card.  Returns {"KF": {...}, "KI": {...},
    "block_rows": the most rows of one Bloom block}."""
    rows = ret.shape[0]
    replay = sph.adjudicate_replay_np(
        ret.cpu().numpy().view(np.uint64), arr.cpu().numpy().view(np.uint64),
        np.ones(rows, bool), b, H)
    if replay is None:
        fail("the native replay library did not load")
    out = {"block_rows": int(torch.bincount(
        ret & ((1 << (b - spec.BLK_SHIFT)) - 1)).max())}
    n32 = n.clamp(max=0x7FFFFFFF).to(torch.int32)

    def kf(a32):
        return spec.adjudicate_sketch(ret, a32, n32, b, H)

    def kf_plain(a32):
        return spec.adjudicate_sketch_plain(ret, a32, n32, b, H)

    def ki(a):
        return (spec.adjudicate_first_occurrence(ret, a, b, H),)

    def ki_plain(a):
        return (spec.adjudicate_first_occurrence_plain(ret, a, b, H),)

    for name, shift, fn, plain in (("KF", 0, kf, kf_plain),
                                   ("KI", 0, ki, ki_plain),
                                   ("KI", FAR, ki, ki_plain)):
        a = sdn.as_i32(arr) if name == "KF" else arr + shift
        got = fn(a)
        r = out.setdefault(name, {"mismatches": 0, "max_abs_err": 0.0,
                                  "replay_mismatches": 0})
        n_replay = int((got[0].cpu().numpy() != replay).sum())
        torch.cuda.synchronize()
        t0 = time.time()
        want = plain(a)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        err, n_diff = compare(got, want)
        del want
        r["replay_mismatches"] += n_replay
        r["mismatches"] += n_diff + n_replay
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if shift == 0:
            r["fp"] = int(got[0].sum())
            r["plain_ms"] = plain_ms
            r["ms"] = cuda_ms(lambda: fn(a), 3)
            r["peak_bytes"] = call_peak(lambda: fn(a))
        del got
        torch.cuda.empty_cache()
    return out


def check_finalize_kernels(main_fold, trim_fold, opt, topt, dev, kf):
    """KF and KI against their plain versions and the host replay on the
    folds (check_verdicts; KF's results join phase 6's, kf), then KJ,
    KK and KL against their plain versions at the folds' shapes.  Returns
    {name: result}."""
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

    # KF and KI on the main fold, the trim fold and the hot-block fold
    ki = {"mismatches": 0, "max_abs_err": 0.0, "replay_mismatches": 0}
    for tag, fold, fret, b in (("b30", main_fold, ret, opt.bf_shift),
                               ("b33", trim_fold, trim_fold.ret,
                                topt.bf_shift),
                               ("hot", main_fold, ret, HOT_B)):
        v = check_verdicts(fret, fold.arr, fold.n, b, H)
        for r, name in ((kf, "KF"), (ki, "KI")):
            r["mismatches"] += v[name]["mismatches"]
            r["replay_mismatches"] += v[name]["replay_mismatches"]
            r["max_abs_err"] = max(r["max_abs_err"], v[name]["max_abs_err"])
            r[f"ms_{tag}"] = v[name]["ms"]
            r[f"rows_{tag}"] = len(fold)
            if tag == "b33":
                r["plain_ms_b33"] = v[name]["plain_ms"]
        ki[f"fp_{tag}"] = v["KI"]["fp"]
        if tag == "hot":
            kf["hot_block_rows"] = ki["hot_block_rows"] = v["block_rows"]
        else:
            kf[f"bound_ms_{tag}"] = verdict_bound(len(fold), "KF")[0]
            ki[f"bound_ms_{tag}"] = verdict_bound(len(fold), "KI")[0]
            ki[f"peak_bytes_{tag}"] = v["KI"]["peak_bytes"]
            kf[f"peak_bytes_{tag}"] = v["KF"]["peak_bytes"]
        torch.cuda.empty_cache()
    ki["ms"], ki["plain_ms"] = ki["ms_b33"], ki["plain_ms_b33"]
    ki["bound"] = verdict_bound(len(trim_fold), "KI")
    res["first_occurrence"] = ki

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

    # KL on the kept entries, which must be in (shard, keybody) order as
    # every caller passes them, from them and from a seeded shuffle of
    # them, compared by lookups of every fold row
    payload, keep = kk[:2]
    ks, kkb, kp = s[keep], kb[keep], payload[keep]
    n = ks.shape[0]
    if not keys_in_order(ks, kkb):
        fail("the main fold's kept keys are not in (shard, keybody) order")
    kb_bits = kops.keybody_bits(k, l_pre)
    c_bits = C.table_c_bits(n, k, l_pre, opt.predicted_c_bits())
    perm = torch.from_numpy(np.random.default_rng(5).permutation(n)).to(dev)
    keys = (ks, kkb, kp)
    shuffled = tuple(x[perm] for x in keys)
    built = {tag: spec.cuckoo_build(*x, k, l_pre, kb_bits, c_bits)
             for tag, x in (("KL", keys), ("KL shuffled", shuffled))}
    torch.cuda.synchronize()
    t0 = time.time()
    built["plain"] = spec.cuckoo_build_plain(*keys, k, l_pre, kb_bits,
                                             c_bits)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    want = torch.where(keep, payload, -1).to(torch.int64)
    r = {"max_abs_err": 0.0, "mismatches": 0}
    for tab, _ in built.values():
        tally(r, (lookup(spec.SpecTable(tab, k, l_pre, kb_bits, c_bits), s,
                         kb),), (want,))
    oks = {tag: ok for tag, (_, ok) in built.items()}
    if not all(oks.values()):
        fail(f"cuckoo placement failed at c_bits {c_bits}: {oks}")
    del built
    r["ms"] = cuda_ms(lambda: spec.cuckoo_build(*keys, k, l_pre, kb_bits,
                                                c_bits), 5)
    r["ms_shuffled"] = cuda_ms(lambda: spec.cuckoo_build(
        *shuffled, k, l_pre, kb_bits, c_bits), 5)
    r["kernel_ms"] = cuckoo_graph_ms(kernels.KL, (l_pre, kb_bits, c_bits),
                                     keys, c_bits)
    r["plain_ms"] = plain_ms
    r["bound"], old = cuckoo_bound(n, c_bits)
    r["bound_ms_first_design"] = old[0]
    r["rows"], r["c_bits"] = n, c_bits
    res["cuckoo_build"] = r
    return res


def drive_mesh(fq: Path, out: Path, n: int, backend: str, tmp: Path,
               shard_table: bool = False, flags=(), operands=None,
               stdin=None):
    """The main path over n ranks through the launcher (`--mesh n -s 5m`,
    then flags and operands, by default fq), rank 0's stdout into out;
    stdin feeds a `-` operand; shard_table sets BFC_TPU_SHARD_TABLE=1 for
    the ranks.  Returns rank 0's report, which holds every rank's launch
    counts (launches_by_rank) and the phase walls."""
    rep_path = tmp / f"mesh_{backend}_{n}.json"
    env = os.environ.copy()
    os.environ["BFC_TPU_SHARD_TABLE"] = "1" if shard_table else "0"
    try:
        with open(out, "wb") as sink:
            rc = multihost.launch(n, ["-s", "5m", *flags,
                                      *(operands or (str(fq),))],
                                  backend=backend, stdout=sink,
                                  report_path=str(rep_path), stdin=stdin)
    finally:
        os.environ.clear()
        os.environ.update(env)
    if rc != 0:
        fail(f"the mesh run over {n} {backend} ranks exited with {rc}")
    return json.loads(rep_path.read_text())


def check_mesh_run(mrep, n: int, backend: str, n_reads: int, launched,
                   silent, out: Path, main_hash: str, table: str) -> str:
    """A mesh run's report and output against what it must be: world
    size and backend, the reads counted (a counting run), every rank's
    launches, the table layout and the output's hash.  Returns its label."""
    label = f"{mrep['world_size']} {mrep['backend']} ranks"
    if (mrep["world_size"], mrep["backend"]) != (n, backend):
        fail(f"the mesh run reports {label}, not {n} {backend}")
    if n_reads and mrep["n_reads"] != n_reads:
        fail(f"the mesh run over {label} counted {mrep['n_reads']} reads of "
             f"{n_reads}")
    for i, ls in enumerate(mrep["launches_by_rank"]):
        need_launched(ls, launched, f"rank {i} of {label}")
        need_silent(ls, silent, f"rank {i} of {label}")
    if mrep["table"] != table:
        fail(f"the run over {label} has a {mrep['table']} table, not {table}")
    if file_hash(out) != main_hash:
        fail(f"the output over {label} differs from the main path's")
    return label


def check_sharded(fold, opt, bases, quals, dev, seed, corr_reads: int):
    """KN against its plain version and the sharded KC and KD against the
    replicated ones (phase 13).  The main fold's kept entries (KJ, KI, KK)
    split by owner at R = 2, 4, 8; KN's and the plain version's sub-tables
    probed with every kept entry and ABSENT_KEYS seeded keys against the
    replicated table (KL); KC and KD on the correction batch over KN's
    sub-tables against the replicated table's and their plain versions.
    Times and the bound are one rank's sub-table at R = 2; the sharded KC
    and KD times are at R = 2.  Returns (KN's result, KC's and KD's
    sharded results)."""
    k, l_pre = opt.k, opt.effective_l_pre()
    kb_bits = kops.keybody_bits(k, l_pre)
    ret = sdn.derive_ret(fold.shard, fold.keybody, k, l_pre)
    fp = spec.adjudicate_first_occurrence(ret, fold.arr, opt.bf_shift,
                                          opt.n_hashes)
    payload, keep, hist, _ = spec.finalize_counts(fold.n, fold.n_high,
                                                  fold.first_high, fp)
    del ret, fp
    mode = C._mode_from_hist(hist.cpu().numpy())
    ks, kkb, kp = fold.shard[keep], fold.keybody[keep], payload[keep]
    del payload, keep
    if not keys_in_order(ks, kkb):
        fail("the main fold's kept keys are not in (shard, keybody) order")
    n = ks.shape[0]
    c_bits = C.table_c_bits(n, k, l_pre, opt.predicted_c_bits())
    rep, ok = spec.cuckoo_build(ks, kkb, kp, k, l_pre, kb_bits, c_bits)
    if not ok:
        fail(f"KL failed at c_bits {c_bits}")
    replicated = spec.SpecTable(rep, k, l_pre, kb_bits, c_bits)
    rng = np.random.default_rng(seed + 4)
    qs = torch.from_numpy(rng.integers(0, 1 << l_pre, ABSENT_KEYS)).to(dev)
    qk = torch.from_numpy(rng.integers(0, 1 << kb_bits, ABSENT_KEYS)).to(dev)
    want_kept = kp.to(torch.int64)
    want_other = lookup(replicated, qs, qk)
    b, q, lens = corr_batch(bases, quals, opt, dev, COUNT_B, corr_reads)
    B, L = b.shape
    kc_rep = ann.kcov_island(replicated, b, lens, opt.min_cov)
    kd_rep = srch.ec1_search(replicated, opt, mode, b, q, lens, *kc_rep[1:])
    kn = {"mismatches": 0, "max_abs_err": 0.0, "rows_by_R": {},
          "cb_local_by_R": {}}
    kc = {"mismatches": 0, "max_abs_err": 0.0}
    kd = {"mismatches": 0, "max_abs_err": 0.0}

    for R in (2, 4, 8):
        db = R.bit_length() - 1
        owner = spec.subtable_owner(ks, kkb, l_pre, kb_bits, db)
        by_rank = torch.bincount(owner, minlength=R).tolist()
        cb_local = C.subtable_bits(max(by_rank), k, l_pre, db)
        kn["rows_by_R"][R], kn["cb_local_by_R"][R] = by_rank, cb_local
        built = {"KN": [], "KN shuffled": [], "plain": []}
        rng = np.random.default_rng(seed + R)
        for r in range(R):
            idx = torch.nonzero(owner == r).flatten()
            mix = idx[torch.from_numpy(rng.permutation(idx.shape[0])).to(dev)]
            geom = (l_pre, kb_bits, db + cb_local, db)
            args = (ks[idx], kkb[idx], kp[idx], *geom)
            t, ok = spec.cuckoo_build_local(*args)
            tm, okm = spec.cuckoo_build_local(ks[mix], kkb[mix], kp[mix],
                                              *geom)
            torch.cuda.synchronize()
            t0 = time.time()
            tp, okp = spec.cuckoo_build_local_plain(*args)
            torch.cuda.synchronize()
            plain_ms = (time.time() - t0) * 1e3
            if not (ok and okm and okp):
                fail(f"sub-table placement failed at R = {R}, cb_local "
                     f"{cb_local} (KN {ok}, shuffled {okm}, plain {okp})")
            built["KN"].append(t)
            built["KN shuffled"].append(tm)
            built["plain"].append(tp)
            if R == 2 and r == 0:
                m = idx.shape[0]
                new, old = cuckoo_bound(m, cb_local)
                out = torch.empty_like(t)
                kn.update(ms=cuda_ms(lambda: spec.cuckoo_build_local(*args),
                                     5),
                          ms_into=cuda_ms(lambda: spec.cuckoo_build_local(
                              *args, out=out), 5),
                          kernel_ms=cuckoo_graph_ms(
                              kernels.KN, (l_pre, kb_bits, db + cb_local,
                                           cb_local), args[:3], cb_local),
                          plain_ms=plain_ms, rows=m, cb_local=cb_local,
                          bound=new, bound_ms_first_design=old[0])
                del out
            del idx, mix, args
        for tabs in built.values():
            st = spec.sharded_table(tabs, k, l_pre, kb_bits, db)
            tally(kn, (lookup(st, ks, kkb), lookup(st, qs, qk)),
                  (want_kept, want_other))
        st = spec.sharded_table(built["KN"], k, l_pre, kb_bits, db)
        got_kc = ann.kcov_island(st, b, lens, opt.min_cov)
        tally(kc, got_kc, kc_rep)
        tally(kc, got_kc, ann.kcov_island_plain(st, b, lens, opt.min_cov))
        got_kd = srch.ec1_search(st, opt, mode, b, q, lens, *got_kc[1:])
        tally(kd, got_kd, kd_rep)
        m = KD_PLAIN_READS
        tally(kd, [x[:m] for x in got_kd], srch.ec1_search_plain(
            st, opt, mode, *(x[:m] for x in (b, q, lens, *got_kc[1:]))))
        if R == 2:
            kc["ms"] = cuda_ms(lambda: ann.kcov_island(st, b, lens,
                                                       opt.min_cov), 20)
            kd["ms"] = cuda_median_ms(lambda: srch.ec1_search(
                st, opt, mode, b, q, lens, *got_kc[1:]))
            kc["ms_replicated"] = cuda_ms(lambda: ann.kcov_island(
                replicated, b, lens, opt.min_cov), 20)
            kd["ms_replicated"] = cuda_median_ms(lambda: srch.ec1_search(
                replicated, opt, mode, b, q, lens, *kc_rep[1:]))
        del built, st, got_kc, got_kd
        torch.cuda.empty_cache()
    kn["keys"] = n
    return kn, kc, kd


def check_route(opt, fold, bases, quals, dev):
    """KM against its plain version on the card: the prefix rule on the
    counting batch's KA rows at R = 1, 2, 3, 4, 8 and 256, the Bloom-block
    rule on the main fold's (ret, arrival) rows at R = 1, 2, 8 and 256, and
    both rules (invalid shards dropped under each) on that batch's first
    row, on its first two tiles and 5 rows, and with its second tile's
    rows all invalid, at R = 3 and 256.  Times and bounds are those of the
    counting batch at R = 2 (the fold's beside them): the wrapper's whole
    call, its wait for the counts included, and the launches alone, a
    CUDA graph of route.enqueue on a buffer allocated beforehand."""
    k, l_pre = opt.k, opt.effective_l_pre()
    cb, cq, cl = count_batch(bases, quals, opt, dev)
    rows = sdn.chunk_rows(cb, cq, cl, 0, k, l_pre, False)
    ret = sdn.derive_ret(fold.shard, fold.keybody, k, l_pre)
    cases = [("prefix", R, list(rows), route.PREFIX, l_pre,
              dict(shard=rows.shard)) for R in (1, 2, 3, 4, 8, 256)]
    cases += [("bloom", R, [ret, fold.arr], route.BLOOM, opt.bf_shift,
               dict(ret=ret)) for R in (1, 2, 8, 256)]
    edge = [t.view(-1) for t in kops.kmer_stream(cb, cq, cl, k, l_pre, 0,
                                                 with_ret=True)]
    dropped = edge[0].clone()
    dropped[route.TILE:2 * route.TILE] = kops.INVALID_SHARD
    for cols in ([t[:1] for t in edge],
                 [t[:2 * route.TILE + 5] for t in edge],
                 [dropped] + edge[1:]):
        cases += [("edge", R, cols, rid, param,
                   dict(shard=cols[0], ret=cols[3]))
                  for R in (3, 256) for rid, param in (
                      (route.PREFIX, l_pre), (route.BLOOM, opt.bf_shift))]
    r = {"mismatches": 0, "max_abs_err": 0.0}
    for rule, R, cols, rid, param, kw in cases:
        got = route.route_rows(cols, R, rid, param, **kw)
        want = route.route_rows_plain(cols, R, rid, param, **kw)
        if got.counts != want.counts:
            r["mismatches"] += 1
        err, n_diff = compare(got.cols + [got.perm], want.cols + [want.perm])
        r["mismatches"] += n_diff
        r["max_abs_err"] = max(r["max_abs_err"], err)
        sent = sum(got.counts)
        del got, want
        if R != 2:
            continue
        N = cols[0].shape[0]
        n_cols = sum(c is not None for c in cols)
        ms = cuda_ms(lambda: route.route_rows(cols, R, rid, param, **kw), 10)
        buf = route.buffer(N, R, n_cols, dev)
        kernel_ms = graph_ms([lambda: route.enqueue(
            cols, R, rid, param, kw.get("shard"), kw.get("ret"), buf)],
            chip_probe.REPS)
        del buf
        plain_ms = cuda_ms(
            lambda: route.route_rows_plain(cols, R, rid, param, **kw), 3)
        bnd = bound(N * 8 * n_cols + sent * 8 * (n_cols + 1),
                    N * OPS_KM_ROW)
        if rule == "prefix":
            r.update(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                     bound=bnd, rows=N, rows_sent=sent)
        else:
            r.update(ms_fold=ms, kernel_ms_fold=kernel_ms,
                     plain_ms_fold=plain_ms, bound_ms_fold=bnd[0],
                     rows_fold=N)
        torch.cuda.empty_cache()
    return r


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
    "route_rows": ("KM", "bfc_tpu_torch/csrc/route_rows.cu",
                   "bfc_tpu/parallel/mesh.py:120"),
    "cuckoo_build_local": ("KN", "bfc_tpu_torch/csrc/cuckoo_build_local.cu",
                           "bfc_tpu/ops/spectrum.py:467"),
}
MAIN_KERNELS = ("kmer_stream", "run_combine", "pack_pull", "kcov_island",
                "ec1_search")
TRIM_KERNELS = ("kmer_stream", "run_combine", "pack_pull",
                "bloom_adjudicate", "bloom_build", "max_streak")
MAIN_DEVICE_KERNELS = ("kmer_stream", "run_combine", "derive_ret",
                       "bloom_adjudicate", "finalize_counts", "cuckoo_build",
                       "kcov_island", "ec1_search")
TIMING_EVENTS = ("events: mean of wrapper calls from Python, host cost "
                 "included")
TIMING_MEDIAN = (f"events: median of {MEDIAN_REPS} wrapper calls from "
                 "Python, each timed alone, host cost included")
TIMING_GRAPH = (f"graph: median of {chip_probe.REPLAYS} replays of "
                f"{chip_probe.REPS} calls, host cost excluded")
TRIM_DEVICE_KERNELS = ("kmer_stream", "run_combine", "bloom_adjudicate",
                       "bloom_build", "max_streak")
MESH_KERNELS = ("kmer_stream", "route_rows", "run_combine", "derive_ret",
                "first_occurrence", "finalize_counts", "cuckoo_build",
                "kcov_island", "ec1_search")
SHARDED_KERNELS = ("kmer_stream", "route_rows", "run_combine", "derive_ret",
                   "first_occurrence", "finalize_counts",
                   "cuckoo_build_local", "kcov_island", "ec1_search")


def probe_kernel_rows(probe_rows, launches):
    """The kernels line's rows of KO-KR: each at its representative site
    (chip_probe.REPRESENTATIVE), every site's numbers under "sites"."""
    rows = []
    for tag, name in chip_probe.KERNEL.items():
        mine = [r for r in probe_rows if r["kernel"] == tag]
        site, mode = chip_probe.REPRESENTATIVE[tag]
        r = next(x for x in mine if (x["site"], x["mode"]) == (site, mode))
        rows.append({
            "name": name, "route": "cuda", "source": chip_probe.SOURCE[tag],
            "replaces": r["replaces"].split(" ")[0],
            "launches": launches[name],
            "launches_by_path": {"probe": launches[name]},
            "max_abs_err": max(x["max_abs_err"] for x in mine),
            "mismatches": sum(x["mismatches"] for x in mine),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "bound_comparable": r["bound_comparable"],
            "library_ms": r["library_ms"], "library": r["library"],
            "timing": TIMING_GRAPH, "site": f"{site} {mode}".strip(),
            "sites": {f"{x['site']} {x['mode']}".strip(): {
                "walk": x["route"], **{k: x.get(k) for k in (
                    "replaces", "steps", "queries", "table_entries", "ms",
                    "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "bound_comparable", "ns_per_step", "ns_per_gather",
                    "sectors_per_s")}}
                for x in mine}})
    return rows


def mangle_tags(src: Path, dst: Path) -> None:
    """src's records with their tags mangled as tests/test_torch_refine.py
    does at small scale: every third record loses its comment (it
    inherits the one before and the stats carried), every seventh other
    one takes the foreign comment xx:Z:foo (refined against the stats
    carried), and every fourteenth of those a quality of '!' at a seeded
    place (base code 7 for KC and KD)."""
    lines = src.read_bytes().split(b"\n")
    for i in range(0, len(lines) - 3, 4):
        r = i // 4
        if r % 3 == 0:
            lines[i] = lines[i].split(b"\t")[0]
        elif r % 7 == 0:
            lines[i] = lines[i].split(b"\t")[0] + b"\txx:Z:foo"
            if r % 14 == 0:
                q = bytearray(lines[i + 3])
                q[(r * 37) % len(q)] = ord("!")
                lines[i + 3] = bytes(q)
    dst.write_bytes(b"\n".join(lines))


def refine_line(rep, launches, n_reads: int, opt, what: str) -> str:
    c = rep["refine"]
    book = c["tags_s"] + c["book_s"]
    return (f"-R (k={opt.k}, -b{opt.bf_shift}, device finalize) over {what}: "
            f"skipped {c['skipped'] / n_reads:.4%}, refined "
            f"{c['refined'] / n_reads:.4%}, reverted "
            f"{c['reverted'] / n_reads:.4%}, failed "
            f"{c['failed'] / n_reads:.4%} of {n_reads} reads; walls: "
            f"counting {rep['count_s']:.2f} s, correction "
            f"{rep['correct_s']:.2f} s = KC + KD {rep['device_s']:.2f} s (host "
            f"clock, copies included), host bookkeeping {book:.2f} s (tags "
            f"{c['tags_s']:.2f}, the rest {c['book_s']:.2f}), emit "
            f"{c['emit_s']:.2f} s, reader and the rest "
            f"{rep['correct_s'] - rep['device_s'] - book - c['emit_s']:.2f} s; "
            f"correction peak {rep['correct_peak_bytes'] / 2**30:.2f} GiB; "
            f"scalar fallback {rep['n_fallback']} reads; launches {launches}")


def check_refine_runs(opt, fq: Path, out_fq: Path, tmp: Path, n_reads: int,
                      seed: int):
    """Phase 16: -R over the main path's output as it is, then over it
    with its tags mangled.  Returns the second run's launch counts."""
    refined = tmp / "refined.fq"
    rep, launches, _ = drive(opt, fq, refined, device_finalize=True,
                             correct_fn=str(out_fq))
    need_launched(launches, ("kmer_stream", "run_combine"), "-R")
    need_silent(launches, ("pack_pull",), "-R")
    if rep["refine"]["skipped"] == n_reads:
        if file_hash(refined) != file_hash(out_fq):
            fail("-R skipped every record but changed one")
        how = "every record skipped and written as it came"
    else:
        need_launched(launches, ("kcov_island", "ec1_search"), "-R")
        how = "records not skipped went through KC and KD"
    print(refine_line(rep, launches, n_reads, opt, "the main path's output")
          + f"; {how}", flush=True)
    mangled = tmp / "corrected_mangled.fq"
    mangle_tags(out_fq, mangled)
    rep, launches, _ = drive(opt, fq, refined, device_finalize=True,
                             correct_fn=str(mangled))
    need_launched(launches, ("kmer_stream", "run_combine", "kcov_island",
                             "ec1_search"), "-R")
    need_silent(launches, ("pack_pull",), "-R")
    c = rep["refine"]
    sent = c["refined"] + c["reverted"] + c["failed"]
    if c["skipped"] + sent != n_reads:
        fail(f"-R accounted for {c['skipped'] + sent} of {n_reads} reads")
    if rep["n_fallback"] > sent * 0.001:
        fail(f"-R: {rep['n_fallback']} of the {sent} reads sent to KC and "
             "KD fell back to the scalar model, above 0.1%")
    t0 = time.time()
    n_sent = check_refine_output(refined, mangled, n_reads, opt,
                                 rep["spectrum"], seed)
    print(refine_line(rep, launches, n_reads, opt, "it with tags mangled")
          + f"; {SAMPLE_READS} sampled records byte-identical to the scalar "
          f"model's refine ({n_sent} of them sent to KC and KD; check "
          f"{time.time() - t0:.1f} s)", flush=True)
    refined.unlink()
    mangled.unlink()
    return launches


def check_refine_output(out_fq: Path, in_fq: Path, n_reads: int, opt, ds,
                        seed: int) -> int:
    """Record count, then SAMPLE_READS input records refined by the scalar
    model (pipeline.correct_read) on the same table, each with the comment
    it inherits and the stats carried to it, formatted as the emit formats
    them: half of them drawn from the records whose own comment is not a
    tag -R skips.  Returns how many of them were not skipped."""
    from bfc_tpu_torch.models import pipeline as P

    lines = out_fq.read_bytes().split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    if len(lines) != 4 * n_reads:
        fail(f"-R: {len(lines) // 4} records out for {n_reads} in")
    inp = in_fq.read_bytes().split(b"\n")
    heads = inp[0:4 * n_reads:4]

    def comment(j):  # kseq's stale comment: the last one at or before j
        while j >= 0:
            name, tab, c = heads[j].decode().partition("\t")
            if tab:
                return c
            j -= 1
        return None

    def carried(j):  # ori_st: the stats of the last tag at or before j
        while j >= 0:
            c = comment(j)
            if c is not None and c.startswith("ec:Z:"):
                return P.parse_stats(c[5:])
            j -= 1
        return M.EcStat(ec_code=0)

    skips = re.compile(rb"\tec:Z:0_\d+:(\d+)_")
    sent = [i for i, h in enumerate(heads)
            if not ((m := skips.search(h)) and int(m.group(1)) < 50)]
    rng = np.random.default_rng(seed + 16)
    half = min(SAMPLE_READS // 2, len(sent))
    idx = set(rng.choice(sent, half, replace=False).tolist()) if half else set()
    while len(idx) < SAMPLE_READS:
        idx.add(int(rng.integers(n_reads)))
    probe = IntProbe(ds.table)
    differ = n_sent = 0
    for i in sorted(idx):
        seq, qual = inp[4 * i + 1].decode(), inp[4 * i + 3].decode()
        r = Read(name=heads[i].decode()[1:].partition("\t")[0],
                 comment=comment(i), seq=seq, qual=qual)
        P.correct_read(opt, probe, ds.mode, r, carried(i))
        n_sent += r.comment is None
        w = OutputWriter()
        format_corrected(r, opt.no_qual, False, opt.discard, w)
        differ += w.getbytes().split(b"\n")[:4] != lines[4 * i:4 * i + 4]
    if differ:
        fail(f"-R: {differ} of {SAMPLE_READS} sampled records differ from "
             "the scalar model's refine")
    return n_sent


def run_cli(argv, out: Path) -> None:
    """cli.main in this process with its stdout in out."""
    import io

    saved = sys.stdout
    with open(out, "wb") as f:
        sys.stdout = io.TextIOWrapper(f, write_through=True)
        try:
            if cli.main(argv) != 0:
                fail(f"the CLI {argv} failed")
        finally:
            sys.stdout.flush()
            sys.stdout.detach()
            sys.stdout = saved


def busy_share(events) -> float:
    """The share of the traced span in which the card ran a kernel."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def check_profile(head: Path, tmp: Path) -> None:
    """Phase 17: `-s 5m --profile DIR` over the first HEAD_READS reads on
    the card; the trace holds KC's and KD's kernels, and the output
    hashes as the same run's without --profile."""
    pdir = tmp / "profile"
    plain, prof = tmp / "head_plain.fq", tmp / "head_profiled.fq"
    t0 = time.time()
    run_cli(["-s", "5m", str(head)], plain)
    t1 = time.time()
    kernels.reset_launches()
    run_cli(["-s", "5m", "--profile", str(pdir), str(head)], prof)
    t2 = time.time()
    launches = {k.name: k.launches for k in kernels.KERNELS.values()}
    need_launched(launches, ("kcov_island", "ec1_search"), "--profile")
    if file_hash(prof) != file_hash(plain):
        fail("the output under --profile differs from the run without it")
    trace_file = pdir / "trace.rank0.json"
    events = json.loads(trace_file.read_text())["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    by = {}
    for e in kern:
        nm = e["name"].split("(")[0].split("<")[0].split()[-1]
        by[nm] = by.get(nm, 0) + 1
    for name in ("kc_kernel", "kd_kernel"):
        if not by.get(name):
            fail(f"the --profile trace holds no {name} event (kernels "
                 f"seen: {by})")
    host = [e for e in events if e.get("ph") == "X" and "dur" in e]
    span = (max(e["ts"] + e["dur"] for e in host)
            - min(e["ts"] for e in host))
    print(f"--profile over {HEAD_READS} reads: trace "
          f"{trace_file.stat().st_size} bytes, {len(events)} events, "
          f"{len(kern)} kernel events {by}; the card ran a kernel in "
          f"{busy_share(kern) / span:.2%} of the traced span "
          f"({span / 1e6:.2f} s); walls {t1 - t0:.2f} s plain, "
          f"{t2 - t1:.2f} s profiled; output byte-identical to the run "
          f"without --profile; launches {launches}", flush=True)
    for f in (plain, prof, trace_file):
        f.unlink()


SPILL_CAP = 1 << 22    # bfc_tpu's default BFC_TPU_MAX_MERGE_CAP (rows)
SPILL_FREE = 2 << 30   # device_free_bytes that the ballast of (c) leaves
# the reads of phases 18 and 19, the first of phase 2's: a third of them
# keeps the script within its time limit beside phases 20 and 21 (at 3M
# reads (d)'s host merges took ~345 s on one H100 80GB HBM3 at 700 W)
SPILL_READS = 1_000_000
# the mean spilled span of phase 18 (a) on one H100 80GB HBM3 (700 W):
# 124,617,502 rows in 20 spills
SPAN_ROWS = 6_230_875
MESH_SPILL_KERNELS = ("kmer_stream", "route_rows", "run_combine",
                      "pack_pull", "cuckoo_build", "kcov_island",
                      "ec1_search")
# rank 0's host finalize of the gathered aggregate: no KJ (ret derived
# on the host), no verdict kernel, no KK
MESH_SPILL_SILENT = ("derive_ret", "bloom_adjudicate", "first_occurrence",
                     "finalize_counts")


def peak_rss_gib() -> float:
    """The process's peak resident set so far: VmHWM of /proc/self/status,
    which starts anew at exec, as getrusage's ru_maxrss does not (a
    process this script starts would report this one's peak), else
    ru_maxrss."""
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmHWM:"):
                    return int(ln.split()[1]) / 2**20
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


@contextlib.contextmanager
def merge_cap_env(cap):
    """BFC_TPU_MAX_MERGE_CAP set to cap (None: unset) inside the block,
    which gets the list of every AggBuilder made in it."""
    made = []
    init = C.AggBuilder.__init__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    old = os.environ.pop("BFC_TPU_MAX_MERGE_CAP", None)
    if cap is not None:
        os.environ["BFC_TPU_MAX_MERGE_CAP"] = str(cap)
    C.AggBuilder.__init__ = record
    try:
        yield made
    finally:
        C.AggBuilder.__init__ = init
        os.environ.pop("BFC_TPU_MAX_MERGE_CAP", None)
        if old is not None:
            os.environ["BFC_TPU_MAX_MERGE_CAP"] = old


@contextlib.contextmanager
def timed_packs():
    """sdn.pack_pull (KE's wrapper) timed with CUDA events inside the
    block, which gets the list of (rows, start, end) of every call."""
    calls = []
    pack = sdn.pack_pull

    def timed(run):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = pack(run)
        end.record()
        calls.append((len(run), start, end))
        return out

    sdn.pack_pull = timed
    try:
        yield calls
    finally:
        sdn.pack_pull = pack


def spill_run(tag: str, o, fq: Path, tmp: Path, cap, want_hash: str,
              unspilled_count_s: float, device_finalize: bool = False,
              free_left=None):
    """One run of phase 18: run_device over fq with the merge cap `cap`
    (None: none), and with free_left, a ballast on the card that leaves
    free_left bytes of device_free_bytes for the run.  The counting tree
    must spill, every spilled span must cross through KE (with a spill the
    last levels spill too: there is no other pull), and the output must
    hash as want_hash.  KE's call on each spilled span is timed with CUDA
    events.  Returns (report, launches, the builder)."""
    dev = torch.device("cuda")
    out = tmp / f"spill_{tag}.fq"
    ballast, left, size = None, None, 0
    with merge_cap_env(cap) as made, timed_packs() as packs:
        if free_left is not None:
            torch.cuda.empty_cache()
            size = kernels.device_free_bytes(dev) - free_left
            ballast = torch.empty((size,), dtype=torch.uint8, device=dev)
            left = kernels.device_free_bytes(dev)
        try:
            rep, launches, peak = drive(o, fq, out,
                                        device_finalize=device_finalize)
        finally:
            del ballast
            torch.cuda.empty_cache()
    if len(made) != 1:
        fail(f"spill {tag}: {len(made)} counting trees, not one")
    b = made[0]
    torch.cuda.synchronize()
    ke_ms = [start.elapsed_time(end) for _, start, end in packs]
    ke_rows = [rows for rows, _, _ in packs]
    ke_bound = bound(sum(ke_rows) * (3 * 8 + 1 + 2 * 4),
                     sum(ke_rows) * OPS_KE_ROW)[0]
    print(f"spill {tag} ({rep['finalize']} finalize, cap {b.cap}"
          + ("" if free_left is None else
             f", ballast {size} bytes leaving {left} free")
          + f"): {b.spills} spills of {b.spilled_rows} rows; KE on the "
          f"spilled spans {sum(ke_ms):.4f} ms for {sum(ke_rows)} rows (CUDA "
          f"events; per span {min(ke_ms, default=0):.4f}-"
          f"{max(ke_ms, default=0):.4f} ms for {min(ke_rows, default=0)}-"
          f"{max(ke_rows, default=0)} rows; bound {ke_bound:.4f} ms), pack "
          f"{b.tree.timings.get('stage', 0.0)} s (counting thread); copy "
          f"and unpack {b.tree.timings.get('pull', 0.0)} s, host merges of "
          f"{b.host_merge_rows} input rows "
          f"{b.tree.timings.get('host_merge', 0.0)} s (worker threads); "
          f"counting {rep['count_s']:.2f} s (unspilled {unspilled_count_s:.2f}"
          f"), {rep.get('trim_s', rep.get('correct_s', 0.0)):.2f} s after it; "
          f"device peak {(peak - size) / 2**30:.2f} GiB beside the ballast; "
          f"host peak RSS of the process so far "
          f"{peak_rss_gib():.2f} GiB; launches {launches}", flush=True)
    if b.spills < 1:
        fail(f"spill {tag}: the counting tree did not spill")
    if launches["pack_pull"] != b.spills:
        fail(f"spill {tag}: KE launched {launches['pack_pull']} times for "
             f"{b.spills} spilled spans")
    if file_hash(out) != want_hash:
        fail(f"spill {tag}: the output differs from the unspilled run's")
    out.unlink()
    return rep, launches, b


def spill_trim(fq: Path, result: Path) -> None:
    """Phase 18 (d), in a process of its own (this script with
    --spill-trim): -1 -k51 unspilled, then under the cap of (a), which
    must hash as the unspilled run; its launch counts written to result
    as JSON."""
    topt = Opts()
    topt.k = TRIM_K
    topt.filter_mode = True
    ref = result.parent / "spill_trim_ref.fq"
    with merge_cap_env(None):
        rep, _, _ = drive(topt, fq, ref)
    want = file_hash(ref)
    ref.unlink()
    _, launches, _ = spill_run("(d) trim, row cap", topt, fq, result.parent,
                               SPILL_CAP, want, rep["count_s"])
    result.write_text(json.dumps(launches))


@contextlib.contextmanager
def ranks_rss():
    """The peak, over samples every half second inside the block, of the
    summed resident set (/proc/<pid>/statm) of the mesh's ranks: this
    process's children that run bfc_tpu_torch.parallel.multihost (not
    phase 18 (d)'s process).  The block gets a dict whose "peak_gib" is
    None where nothing could be read."""
    got = {"peak_gib": None}
    stop = threading.Event()
    me = str(os.getpid())
    page = os.sysconf("SC_PAGE_SIZE")

    def sample():
        while not stop.wait(0.5):
            total, seen = 0, False
            for pid in os.listdir("/proc"):
                if not pid.isdigit():
                    continue
                try:
                    with open(f"/proc/{pid}/stat") as f:
                        ppid = f.read().rsplit(")", 1)[1].split()[1]
                    if ppid != me:
                        continue
                    with open(f"/proc/{pid}/cmdline", "rb") as f:
                        if b"parallel.multihost" not in f.read():
                            continue
                    with open(f"/proc/{pid}/statm") as f:
                        total += int(f.read().split()[1]) * page
                    seen = True
                except (OSError, IndexError, ValueError):
                    continue
            if seen:
                got["peak_gib"] = max(got["peak_gib"] or 0.0, total / 2**30)

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield got
    finally:
        stop.set()
        t.join()


def check_mesh_spill(fq: Path, tmp: Path, n_reads: int, main_hash: str,
                     dump: Path, unspilled):
    """Phase 19: the mesh's counting spill, two gloo ranks sharing cuda:0
    under BFC_TPU_MAX_MERGE_CAP=SPILL_CAP, (a) with the replicated table
    and -d, (b) with the sharded table.  unspilled is the unspilled
    single-card run's counting wall, main_hash and dump its output's hash
    and its -d dump.  Every rank must spill, rank 0 must finalize on the
    host, check_mesh_run's checks must pass (KE launched in every rank),
    and (a)'s dump must equal the single-card one.  Returns each run's
    launches summed over the ranks."""
    paths = {}
    for sharded in (False, True):
        tag = "(b) sharded" if sharded else "(a) replicated, -d"
        mout = tmp / "corrected_mesh_spill.fq"
        mdump = tmp / "mesh_spill.dump"
        with merge_cap_env(SPILL_CAP), ranks_rss() as rss:
            mrep = drive_mesh(fq, mout, 2, "gloo", tmp, shard_table=sharded,
                              flags=() if sharded else ("-d", str(mdump)))
        table = "sharded" if sharded else "replicated"
        launched = MESH_SPILL_KERNELS if not sharded else tuple(
            "cuckoo_build_local" if x == "cuckoo_build" else x
            for x in MESH_SPILL_KERNELS)
        silent = MESH_SPILL_SILENT + (
            ("cuckoo_build",) if sharded else ("cuckoo_build_local",))
        peak = rss["peak_gib"]
        print(f"mesh spill {tag}: 2 gloo ranks on cuda:0, cap {SPILL_CAP}; "
              f"spills by rank {mrep['spills_by_rank']} of "
              f"{mrep['spilled_rows_by_rank']} rows; KE by rank "
              f"{[ls['pack_pull'] for ls in mrep['launches_by_rank']]}; "
              f"counting {mrep['count_s']:.2f} s (one card, unspilled "
              f"{unspilled:.2f}), correction "
              f"{mrep['correct_s']:.2f} s; rank 0: gather "
              f"{mrep['gather_s']:.2f} s, {mrep['finalize']} finalize "
              f"{mrep['finalize_s']:.2f} s (verdict {mrep['verdict']}), "
              f"entries sent {mrep['send_s']:.2f} s; "
              f"{mrep['n_aggregated']} distinct k-mers, {mrep['n_kept']} "
              f"kept; peak RSS of the ranks together "
              + ("not measured" if peak is None else f"{peak:.2f} GiB")
              + f", of this process {peak_rss_gib():.2f} GiB; launches by "
              f"rank {mrep['launches_by_rank']}", flush=True)
        if min(mrep["spills_by_rank"]) < 1:
            fail(f"mesh spill {tag}: a rank did not spill")
        if mrep["finalize"] != "host":
            fail(f"mesh spill {tag}: rank 0 finalized on the "
                 f"{mrep['finalize']}, not the host")
        check_mesh_run(mrep, 2, "gloo", n_reads, launched, silent, mout,
                       main_hash, table)
        mout.unlink()
        if not sharded:
            if file_hash(mdump) != file_hash(dump):
                fail("mesh spill: the -d dump differs from the unspilled "
                     "run's")
            mdump.unlink()
        paths[f"mesh_spill_{table}_gloo_2"] = {
            name: sum(ls[name] for ls in mrep["launches_by_rank"])
            for name in SOURCES}
        print(f"mesh spill {tag}: output byte-identical to the unspilled "
              "run's" + ("" if sharded else "; -d dump byte-identical to "
                         "its dump"), flush=True)
    return paths


def check_spill(opt, fq: Path, tmp: Path, main, device, beside=None):
    """Phase 18: the counting spill over fq, the first SPILL_READS reads.
    main and device are (count_s, output hash, launches) of their
    unspilled runs with the host and the device finalize.  (d) runs in a
    process of its own beside (a) and (b), and beside(), where given
    (phase 19): at k = 51 its host merges take the lexsort and hold the
    card idle.  (c) starts once (d) has ended, as its ballast needs the
    card alone.  Returns each run's launches by path name and what
    beside() returned."""
    print(f"spill: host peak RSS of the process before phase 18 "
          f"{peak_rss_gib():.2f} GiB", flush=True)
    paths = {}
    result = tmp / "spill_trim.json"
    trim_proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--spill-trim",
         str(fq), str(result)], stdout=subprocess.PIPE, text=True)
    try:
        _, paths["spill_cap_host"], _ = spill_run(
            "(a) row cap, beside (d)", opt, fq, tmp, SPILL_CAP, main[1],
            main[0])
        a = paths["spill_cap_host"]
        print(f"spill (a): KA {a['kmer_stream']} launches, KB "
              f"{a['run_combine']} (unspilled: KA {main[2]['kmer_stream']}, "
              f"KB {main[2]['run_combine']}); output byte-identical to "
              "the unspilled run's", flush=True)
        rep, paths["spill_cap_device"], _ = spill_run(
            "(b) row cap, beside (d)", opt, fq, tmp, SPILL_CAP, main[1],
            device[0], device_finalize=True)
        other = beside() if beside is not None else None
        trim_out, _ = trim_proc.communicate()
    finally:
        if trim_proc.poll() is None:
            trim_proc.kill()
            trim_proc.wait()
    lb = paths["spill_cap_device"]
    need_launched(lb, ("finalize_counts", "cuckoo_build"),
                  "the device finalize of a spilled aggregate")
    need_launched(lb, ("bloom_adjudicate" if rep["verdict"] == "KF"
                       else "first_occurrence",), "the spilled verdict")
    # AggBuilder.finish hands over a spilled aggregate with ret filled in
    need_silent(lb, ("derive_ret",), "the device finalize of a spilled "
                "aggregate, which came with ret")
    print(f"spill (b): verdict {rep['verdict']} on the uploaded aggregate, "
          f"KK {lb['finalize_counts']}, KL {lb['cuckoo_build']} launches; "
          f"the aggregate came with ret, KJ {lb['derive_ret']} launches; "
          "output byte-identical to the unspilled run's", flush=True)
    sys.stdout.write(trim_out)
    if trim_proc.returncode != 0:
        fail(f"spill (d) exited with {trim_proc.returncode}")
    paths["spill_cap_trim"] = json.loads(result.read_text())
    print("spill (d): output byte-identical to the unspilled -1 run's",
          flush=True)
    _, paths["spill_bytes_host"], b = spill_run(
        "(c) bytes", opt, fq, tmp, None, main[1], main[0],
        free_left=SPILL_FREE)
    if b.cap is not None:
        fail("spill (c) ran with a row cap")
    print("spill (c): spilled on the byte rule alone; output byte-identical "
          "to the unspilled run's", flush=True)
    return paths, other


def check_spills(opt, bases, quals, tmp: Path):
    """Phases 18 and 19 over the first SPILL_READS reads: their unspilled
    runs with the host finalize (and -d) and with the device finalize,
    which must hash equal, then check_spill with check_mesh_spill beside
    its (d).  Returns the launches by path name."""
    t0 = time.time()
    fq = tmp / "reads_spill.fq"
    write_fastq(fq, bases[:SPILL_READS], quals[:SPILL_READS])
    out, dump = tmp / "spill_ref.fq", tmp / "spill_ref.dump"
    refs = []
    for fin in (False, True):
        rep, launches, _ = drive(opt, fq, out, device_finalize=fin,
                                 **({} if fin else {"out_hash": str(dump)}))
        refs.append((rep["count_s"], file_hash(out), launches))
    if refs[0][1] != refs[1][1]:
        fail("spill: the unspilled runs' outputs differ by finalize")
    out.unlink()
    print(f"spill: the first {SPILL_READS} reads unspilled: counting "
          f"{refs[0][0]:.2f} s (host finalize), {refs[1][0]:.2f} s (device "
          f"finalize), outputs hashed equal; {time.time() - t0:.1f} s",
          flush=True)

    def mesh_spill():
        t1 = time.time()
        got = check_mesh_spill(fq, tmp, SPILL_READS, refs[0][1], dump,
                               refs[0][0])
        print(f"mesh spill: both runs byte-identical to the unspilled run's; "
              f"{time.time() - t1:.1f} s", flush=True)
        return got

    paths, mesh_paths = check_spill(opt, fq, tmp, refs[0], refs[1],
                                    beside=mesh_spill)
    paths.update(mesh_paths)
    fq.unlink()
    dump.unlink()
    print(f"spill: four runs byte-identical to the unspilled ones, and "
          f"the mesh's two; {time.time() - t0:.1f} s", flush=True)
    return paths


# --------------------------------------------------------------------------
# Phase 20: the human-scale rehearsal tool, small
# --------------------------------------------------------------------------

# bfc_tpu_torch.tools.human_scale at a size that spills on the byte rule
# alone beside a ballast (a 10 Mb genome: ~4.5x10^7 rows against 4 GiB
# free; 3M reads over 15 Mb took 107.9-132.8 s on one H100 80GB HBM3 at
# 700 W, and 4M over 20 Mb beside 6 GiB 112-119 s)
HUMAN_ARGS = ("--reads", "2e6", "--genome", "10e6", "--k", "27",
              "--both-finalize", "--leave-free", "4")
# KA-KE counting and spilling, the device finalize of the uploaded
# aggregate (a verdict kernel, KK, KL), and the correction
HUMAN_KERNELS = ("kmer_stream", "run_combine", "pack_pull", "finalize_counts",
                 "cuckoo_build", "kcov_island", "ec1_search")


def check_human_scale():
    """Phase 20: the tool in a process of its own, BFC_TPU_MAX_MERGE_CAP
    unset.  Its checks must pass, the tree must have spilled, and its
    launches must include HUMAN_KERNELS and a verdict kernel.  Returns
    its report."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("BFC_TPU_MAX_MERGE_CAP", "BFC_TPU_DEVICE_FINALIZE")}
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "bfc_tpu_torch.tools.human_scale",
                        *HUMAN_ARGS], env=env, stdout=subprocess.PIPE,
                       stderr=subprocess.PIPE, text=True)
    wall = time.time() - t0
    for ln in r.stdout.splitlines()[:-1]:
        print(f"  {ln}", flush=True)
    if r.returncode != 0:
        sys.stdout.write(r.stderr[-4000:])
        fail(f"human_scale exited with {r.returncode}")
    rep = json.loads(r.stdout.splitlines()[-1])
    fin = rep["finalize_modes"]
    print(f"human scale ({' '.join(HUMAN_ARGS)}): {rep['reads']} reads "
          f"({rep['gbp']:.2f} Gbp, k {rep['k']}); {rep['rows_aggregated']} "
          f"rows aggregated, {rep['entries']} kept; {rep['spills']} spills "
          f"of {rep['spilled_rows']} rows on the byte rule (ballast "
          f"{rep['ballast_bytes']} bytes, {rep['free_beside_ballast']} "
          f"free), host merges of {rep['host_merge_rows']} rows, "
          f"{rep['lsm_timings']}; counting {rep['count_s']:.2f} s "
          f"({rep['count_reads_per_s']:.0f} reads/s); finalize host "
          f"{fin['host']['s']:.2f} s, device {fin['device']['s']:.2f} s "
          f"({fin['device']['verdict']}; c_bits {fin['host']['c_bits']}, "
          f"table {fin['host']['table_bytes']} bytes); device peaks "
          f"counting {rep['count_peak_bytes'] / 2**30:.2f} GiB beside the "
          f"ballast, device finalize {fin['device']['peak_bytes'] / 2**30:.2f}"
          f", correction {rep['correct_peak_bytes'] / 2**30:.2f}; host peak "
          f"RSS {rep['host_peak_rss_bytes'] / 2**30:.2f} GiB; correction "
          f"{rep['correct_reads_per_s']:.0f} reads/s, fallback share "
          f"{rep['fallback_share']}; checks {rep['checks']}; launches "
          f"{rep['launches']}; {wall:.1f} s", flush=True)
    if not rep["ok"]:
        fail("human_scale: a check failed")
    if rep["spills"] < 1 or rep["merge_cap"] is not None:
        fail("human_scale: the tree did not spill on the byte rule")
    need_launched(rep["launches"], HUMAN_KERNELS, "the human-scale tool")
    if not (rep["launches"]["bloom_adjudicate"]
            or rep["launches"]["first_occurrence"]):
        fail("human_scale: no verdict kernel launched")
    return rep


# --------------------------------------------------------------------------
# Phase 21: reads over 504 bp end to end
# --------------------------------------------------------------------------

LONG_BANDS = ((200_000, 300, 590), (1_000, 1_000, 3_000))  # reads, lengths
LONG_SAMPLE_AT = 600    # half the sampled reads are longer than this
LONG_FALLBACK = 0.001   # fallback share allowed up to LONG_SAMPLE_AT bp
POOL_WORKERS = 6        # host processes of the scalar checks
_pool = {}


def make_long_reads(glen: int, seed: int):
    """LONG_BANDS' reads of a seeded genome (make_genome), their lengths
    drawn uniformly in each band and the reads shuffled, half reverse
    complemented, 1% substitution errors on low qualities: (lens i64
    [n], offsets i64 [n], bases u8 codes and quals u8 ASCII, flat)."""
    rng = np.random.default_rng(seed)
    g = make_genome(glen, rng)
    lens = np.concatenate([rng.integers(lo, hi + 1, n)
                           for n, lo, hi in LONG_BANDS])
    lens = lens[rng.permutation(len(lens))]
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    total = int(lens.sum())
    start = np.repeat(rng.integers(0, glen - lens), lens)
    rc = np.repeat(rng.random(len(lens)) < 0.5, lens)
    j = np.arange(total) - np.repeat(offs, lens)
    flat = g[np.where(rc, start + np.repeat(lens, lens) - 1 - j, start + j)]
    flat = np.where(rc, 3 - flat, flat)
    err = rng.random(total) < 0.01
    bases = np.where(err, (flat + rng.integers(1, 4, total)) % 4,
                     flat).astype(np.uint8)
    quals = np.where(err, 35 + rng.integers(0, 13, total),
                     63 + rng.integers(0, 10, total)).astype(np.uint8)
    return lens, offs, bases, quals


def write_fastq_varlen(path: Path, lens, offs, bases, quals) -> None:
    """Records @r%08d / seq / + / qual of the given lengths, built as one
    byte array."""
    n = len(lens)
    size = 15 + 2 * lens
    at = np.concatenate([[0], np.cumsum(size)[:-1]])
    out = np.empty(int(size.sum()), np.uint8)
    digits = (np.arange(n)[:, None] // 10 ** np.arange(7, -1, -1)) % 10
    head = np.concatenate([np.full((n, 2), [ord("@"), ord("r")], np.uint8),
                           (48 + digits).astype(np.uint8),
                           np.full((n, 1), 10, np.uint8)], axis=1)
    out[at[:, None] + np.arange(11)] = head
    j = np.arange(len(bases)) - np.repeat(offs, lens)
    seq_at = np.repeat(at + 11, lens) + j
    out[seq_at] = np.frombuffer(b"ACGT", np.uint8)[bases]
    out[(at + 11 + lens)[:, None] + np.arange(3)] = [10, ord("+"), 10]
    out[seq_at + np.repeat(lens, lens) + 3] = quals
    out[at + size - 1] = 10
    out.tofile(path)


def read_text(lens, offs, bases, quals, i: int):
    acgt = np.frombuffer(b"ACGT", np.uint8)
    a, n = int(offs[i]), int(lens[i])
    return (acgt[bases[a:a + n]].tobytes().decode(),
            quals[a:a + n].tobytes().decode())


def _pool_init(table, tmeta, words, bmeta, opt, topt, mode) -> None:
    """A checking process: the host copies of the card's table and Bloom
    words, memory-mapped from the files the parent wrote."""
    t = spec.SpecTable(torch.from_numpy(np.load(table)), *tmeta)
    _pool["probe"] = IntProbe(t)
    bloom = TT.DeviceBloom(torch.from_numpy(np.load(words)), *bmeta)
    _pool["bloom"] = TT.WordsProbe(bloom)
    _pool.update(opt=opt, topt=topt, mode=mode)


def _pool_correct(item):
    """One read corrected by refmodel.ec1 and formatted as the emit does."""
    i, seq, qual = item
    opt = _pool["opt"]
    st, s2, q2 = M.ec1(opt, _pool["probe"], _pool["mode"], seq, qual)
    r = Read(name=f"r{i:08d}", comment=None, seq=s2, qual=q2)
    r.aux, r.aux2 = pack_stats(st)
    w = OutputWriter()
    format_corrected(r, opt.no_qual, False, opt.discard, w)
    return i, w.getbytes().split(b"\n")[:4], st.n_ec > 0


def _pool_trim(item):
    i, seq, qual = item
    return (i,) + tuple(M.trim_read(_pool["topt"], _pool["bloom"], seq, qual))


def output_records(path: Path, n: int):
    lines = path.read_bytes().split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    if len(lines) % 4:
        fail(f"{path.name}: {len(lines)} lines, not whole records")
    if n is not None and len(lines) != 4 * n:
        fail(f"{path.name}: {len(lines) // 4} records for {n} reads")
    return lines


def kd_by_band(ds, opt, reads, dev):
    """KC, then KD (CUDA events, the median of 3 calls) on each band's
    reads in batches of at most srch.CORRECT_BATCH, padded to the band's
    longest read rounded to 32, as Corrector.device_step gives them: the
    reads, KD's ms, us a read, and the reads past KD's stack."""
    lens, offs, bases, quals = reads
    out = {}
    for _, lo, hi in LONG_BANDS:
        idx = np.nonzero((lens >= lo) & (lens <= hi))[0]
        L = (int(lens[idx].max()) + 31) // 32 * 32
        ms = 0.0
        ovf = 0
        for a in range(0, len(idx), srch.CORRECT_BATCH):
            part = idx[a:a + srch.CORRECT_BATCH]
            B = len(part)
            b = np.full((B, L), 4, np.uint8)
            q = np.zeros((B, L), bool)
            rows = np.repeat(np.arange(B), lens[part])
            cols = np.arange(len(rows)) - np.repeat(
                np.concatenate([[0], np.cumsum(lens[part])[:-1]]), lens[part])
            src = np.repeat(offs[part], lens[part]) + cols
            b[rows, cols] = bases[src]
            q[rows, cols] = quals[src].astype(np.int32) - 33 >= opt.q
            bt, qt = torch.from_numpy(b).to(dev), torch.from_numpy(q).to(dev)
            lt = torch.from_numpy(lens[part].astype(np.int32)).to(dev)
            _, lcov, hcov, isl = ann.kcov_island(ds.table, bt, lt,
                                                 opt.min_cov)

            def kd():
                return srch.ec1_search(ds.table, opt, ds.mode, bt, qt, lt,
                                       lcov, hcov, isl)
            ms += cuda_median_ms(kd, 3)
            ovf += int(kd()[1][:, srch.OVERFLOW].sum())
        out[(lo, hi)] = {"reads": len(idx), "slots": L, "kd_ms": ms,
                         "us_per_read": ms * 1e3 / len(idx), "overflow": ovf}
    return out


def check_long_reads(tmp: Path, seed: int, dev):
    """Phase 21.  Returns the launches of its three runs by path name."""
    import multiprocessing as mp

    t_phase = time.time()
    t0 = time.time()
    reads = make_long_reads(5_000_000, seed + 21)
    lens, offs, bases, quals = reads
    n = len(lens)
    fq = tmp / "long.fq"
    write_fastq_varlen(fq, *reads)
    widths = max(rb.bases.shape[1] for rb in FR.iter_batches(
        str(fq), srch.CORRECT_BATCH))
    print(f"long reads: {n} reads ({', '.join(f'{c} of {lo}-{hi} bp' for c, lo, hi in LONG_BANDS)}; "
          f"{int(lens.sum())} bases) from a 5 Mb genome, "
          f"{fq.stat().st_size} bytes of FASTQ; the reader's batches "
          f"widened to {widths} slots; {time.time() - t0:.1f} s", flush=True)
    opt = Opts()
    opt.apply_genome_size(cli.parse_size("5m"))
    paths, hashes = {}, {}
    for fin in (False, True):
        name = "long_reads_" + ("device" if fin else "host") + "_finalize"
        out = tmp / f"{name}.fq"
        rep, launches, peak = drive(opt, fq, out, device_finalize=fin)
        need_launched(launches, MAIN_DEVICE_KERNELS if fin else MAIN_KERNELS,
                      f"the long reads ({name})")
        output_records(out, n)
        hashes[fin] = file_hash(out)
        paths[name] = launches
        if fin:
            out.unlink()
        else:
            ds, fallback = rep["spectrum"], rep["n_fallback"]
        print(f"long reads, {rep['finalize']} finalize: counting "
              f"{rep['count_s']:.2f} s, correction {rep['correct_s']:.2f} s "
              f"({n / rep['correct_s']:.0f} reads/s); {rep['n_kept']} "
              f"entries kept, c_bits {rep['c_bits']}; scalar fallback "
              f"{rep['n_fallback']} reads; device peaks counting "
              f"{rep['count_peak_bytes'] / 2**30:.2f} GiB, correction "
              f"{rep['correct_peak_bytes'] / 2**30:.2f}; KC "
              f"{launches['kcov_island']}, KD {launches['ec1_search']} "
              f"launches", flush=True)
    if hashes[False] != hashes[True]:
        fail("long reads: the two finalizes' outputs differ")
    topt = Opts()
    topt.k = TRIM_K
    topt.filter_mode = True
    trim_fq = tmp / "long_trim.fq"
    trep, tlaunches, _ = drive(topt, fq, trim_fq)
    need_launched(tlaunches, TRIM_KERNELS, "the long reads' trim")
    paths["long_reads_trim"] = tlaunches
    print(f"long reads, -1 -k{TRIM_K}: counting {trep['count_s']:.2f} s, "
          f"trim {trep['trim_s']:.2f} s; KH {tlaunches['max_streak']} "
          f"launches", flush=True)

    # the scalar checks, in processes of their own, while KD is timed
    table = tmp / "long_table.npy"
    words = tmp / "long_words.npy"
    np.save(table, ds.table.table.cpu().numpy())
    bloom = trep["bloom"]
    np.save(words, bloom.words.cpu().numpy())
    rng = np.random.default_rng(seed + 22)
    long_idx = np.nonzero(lens > LONG_SAMPLE_AT)[0]
    short_idx = np.nonzero(lens <= LONG_SAMPLE_AT)[0]
    half = SAMPLE_READS // 2
    pick = np.sort(np.concatenate([rng.choice(long_idx, half, replace=False),
                                   rng.choice(short_idx, half,
                                              replace=False)]))
    tpick = np.sort(rng.choice(n, SAMPLE_READS, replace=False))
    t = ds.table
    ctx = mp.get_context("spawn")
    t0 = time.time()
    with ctx.Pool(POOL_WORKERS, _pool_init,
                  (str(table), (t.k, t.l_pre, t.kb_bits, t.c_bits),
                   str(words), (bloom.bf_shift, bloom.n_hashes), opt, topt,
                   ds.mode)) as pool:
        corr = pool.map_async(_pool_correct, [
            (int(i),) + read_text(*reads, int(i)) for i in pick], chunksize=4)
        trim = pool.map_async(_pool_trim, [
            (int(i),) + read_text(*reads, int(i)) for i in tpick],
            chunksize=16)
        bands = kd_by_band(ds, opt, reads, dev)
        corr, trim = corr.get(), trim.get()
    pool_s = time.time() - t0
    for (lo, hi), b in bands.items():
        print(f"long reads, KD on the {b['reads']} reads of {lo}-{hi} bp "
              f"({b['slots']} slots): {b['kd_ms']:.3f} ms, "
              f"{b['us_per_read']:.3f} us a read (median of 3 calls a "
              f"batch); {b['overflow']} reads past KD's stack", flush=True)
    short = bands[LONG_BANDS[0][1:]]["overflow"]
    longer = bands[LONG_BANDS[1][1:]]["overflow"]
    print(f"long reads: fallback share {short / LONG_BANDS[0][0]:.6f} up to "
          f"{LONG_BANDS[0][2]} bp, {longer / LONG_BANDS[1][0]:.6f} for "
          f"{LONG_BANDS[1][1]}-{LONG_BANDS[1][2]} bp; the run's scalar "
          f"fallback {fallback} reads", flush=True)
    if short + longer != fallback:
        fail(f"long reads: {short} + {longer} reads past KD's stack, but "
             f"{fallback} fell back in the run")
    if short > LONG_FALLBACK * LONG_BANDS[0][0]:
        fail(f"long reads: {short} reads of at most {LONG_BANDS[0][2]} bp "
             "fell back, above 0.1%")
    lines = output_records(tmp / "long_reads_host_finalize.fq", n)
    differ = sum(rec != lines[4 * i:4 * i + 4] for i, rec, _ in corr)
    fixed = sum(c for _, _, c in corr)
    if differ:
        fail(f"long reads: {differ} of {len(corr)} sampled records differ "
             "from refmodel.ec1")
    tlines = output_records(trim_fq, None)
    where = {tlines[j][1:]: j for j in range(0, len(tlines), 4)}
    tdiffer = kept = 0
    for i, keep, s2, q2 in trim:
        j = where.get(b"r%08d" % i)
        if keep:
            kept += 1
            want = [b"@r%08d" % i, s2.encode(), b"+", q2.encode()]
            tdiffer += j is None or tlines[j:j + 4] != want
        else:
            tdiffer += j is not None
    if tdiffer:
        fail(f"long reads: {tdiffer} of {len(trim)} sampled reads trim "
             "otherwise than refmodel.trim_read")
    print(f"long reads: both finalizes hash equal, one record a read; "
          f"{len(corr)} sampled reads ({half} over {LONG_SAMPLE_AT} bp, "
          f"{fixed} corrected) byte-identical to refmodel.ec1, "
          f"{len(trim)} trimmed as refmodel.trim_read ({kept} kept, "
          f"{len(tlines) // 4} records out); scalar checks {pool_s:.1f} s "
          f"in {POOL_WORKERS} processes beside KD's timing; phase "
          f"{time.time() - t_phase:.1f} s", flush=True)
    for f in (fq, trim_fq, table, words, tmp / "long_reads_host_finalize.fq"):
        f.unlink()
    return paths


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome", type=int, default=5_000_000,
                    help="synthetic genome length in bases [5,000,000]")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--spill-trim", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.spill_trim:
        spill_trim(*(Path(a) for a in args.spill_trim))
        return 0
    t_start = time.time()
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
        dump = tmp / "spectrum.dump"
        report, launches, peak = drive(opt, fq, out_fq, out_hash=str(dump))
        cs, es = report["count_s"], report["correct_s"]
        print(f"main path (k={opt.k}, -b{opt.bf_shift}): counting {cs:.2f} s "
              f"({n_reads / cs:.0f} reads/s), correction {es:.2f} s "
              f"({n_reads / es:.0f} reads/s), end to end "
              f"{n_reads / (cs + es):.0f} reads/s; "
              f"{report['n_aggregated']} distinct k-mers aggregated, "
              f"{report['n_kept']} kept, c_bits {report['c_bits']}; -d dump "
              f"{dump.stat().st_size} bytes in {report['dump_s']:.2f} s; "
              f"device memory peak "
              f"{peak / 2**30:.2f} GiB (counting "
              f"{report['count_peak_bytes'] / 2**30:.2f}, correction "
              f"{report['correct_peak_bytes'] / 2**30:.2f}); scalar fallback "
              f"{report['n_fallback']} reads; launches {launches}",
              flush=True)
        if report["n_reads"] != n_reads:
            fail(f"counted {report['n_reads']} reads of {n_reads}")
        if report["n_fallback"] > n_reads * 0.001:
            fail(f"{report['n_fallback']} reads fell back to the scalar model, "
                 "above 0.1%")
        correction_peak = report["correct_peak_bytes"]
        # the main path's correction batch, as the reader cuts it
        corr_reads = next(iter(FR.iter_batches(
            str(fq), srch.CORRECT_BATCH, max_bases=opt.chunk_size))).n
        need_launched(launches, MAIN_KERNELS, "the main path")
        ds = report["spectrum"]
        n_corr = check_output(out_fq, n_reads, bases, quals, opt, ds,
                              args.seed)
        print(f"output: {n_reads} records; {SAMPLE_READS} sampled records "
              f"byte-identical to refmodel.ec1 ({n_corr} of them corrected)",
              flush=True)
        main_hash = file_hash(out_fq)  # kept for -R (phase 16)

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
        r = res["pack_pull"]
        print(f"pull of the {r['rows']}-row fold: unpacked "
              f"{w['unpacked']} s, packed by KE {w['packed']} s; KE kernel "
              f"{r['kernel_ms']:.4f} ms on the fold, "
              f"{r['kernel_ms_span']:.4f} ms on a {r['span_rows']}-row "
              f"span (bound {r['bound_ms_span']:.4f})", flush=True)
        top_kb = merged.top_kb
        print(f"KB on the top merge ({top_kb['rows']} rows): "
              f"{top_kb['ms']:.3f} ms (median of {MEDIAN_REPS}), bound "
              f"{top_kb['bound']:.4f} ms", flush=True)
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
        res.update(check_kernels(opt, ds, bases, quals, dev, True,
                                 corr_reads))
        res["run_combine"]["top_merge"] = top_kb
        r = res["run_combine"]
        print(f"KB on a {r['rows']}-row counting batch: {r['ms']:.4f} ms "
              f"(median of {MEDIAN_REPS}), bound {r['bound'][0]:.4f} ms",
              flush=True)
        r = res["kmer_stream"]
        print(f"KA on a {COUNT_B} x {COUNT_L} counting batch: call "
              f"{r['ms']:.4f} ms, kernel {r['kernel_ms']:.4f} ms, bound "
              f"{r['bound'][0]:.4f} ms; {LONG_B} x {LONG_L} slots kernel "
              f"{r['kernel_ms_long']:.4f} ms", flush=True)
        r = res["kcov_island"]
        print(f"KC on the {corr_reads}-read correction batch: call "
              f"{r['ms']:.4f} ms, kernel {r['kernel_ms']:.4f} ms "
              f"({r['sectors_per_s'] / 1e9:.2f} G sectors/s of "
              f"{r['sectors']} for {r['probes']} probes), bound "
              f"{r['bound'][0]:.4f} ms "
              f"({r['bound_ms_two_sectors']:.4f} at two sectors a probe); "
              f"{LONG_B} x {LONG_L} slots kernel {r['kernel_ms_long']:.4f} ms",
              flush=True)
        r = res["ec1_search"]
        r["correction_peak_bytes"] = correction_peak
        print(f"KD: {r['ms']:.3f} ms on the main path's {r['reads']}-read "
              f"batch ({r['us_per_read']:.4f} us a read), {r['ms_8192']:.3f} "
              f"ms on {CORR_B_PR6} ({r['us_per_read_8192']:.4f} us a read), "
              f"{r['ms_cap']:.3f} ms on {r['cap_reads']} "
              f"({r['us_per_read_cap']:.4f} us a read), medians "
              f"of {MEDIAN_REPS}; {r['spec_probes']} spec probes, "
              f"{r['sectors_per_s'] / 1e9:.2f} G sectors/s "
              f"({r['sectors_per_s_8192'] / 1e9:.2f} at {CORR_B_PR6}); "
              f"{r['registers']} registers, {r['local_bytes']} local bytes a "
              f"thread, {r['blocks_per_sm']} blocks an SM "
              f"({r['resident_threads']} threads); a batch's KC + KD peak "
              f"{r['batch_peak_bytes'] / 2**30:.3f} GiB, the correction "
              f"pass's {correction_peak / 2**30:.3f} GiB; {r['overflow']} "
              f"overflows", flush=True)
        small = tmp / "reads_head.fq"
        write_fastq(small, bases[:200_000], quals[:200_000])
        opt33, ds33 = small_spectrum(small, 33, dev)
        res33 = check_kernels(opt33, ds33, bases, quals, dev, False,
                              corr_reads)
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
                                      topt, bases, quals, dev))
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
        t0 = time.time()
        wide = check_trim_wide(head, tmp)
        (wrep, wlaunches), (_, wflaunches) = wide["KF"], wide["KI"]
        need = spec.verdict_bytes(wrep["n_aggregated"], WIDE_B, "KF")
        print(f"trim -b{WIDE_B} on the first {HEAD_READS} reads: verdict KF "
              f"from arrival 0 (scratch {need} bytes), KI from 2^33; both "
              f"outputs byte-identical to the "
              f"--cpu run; {wrep['reads_kept']} reads kept; launches "
              f"{wlaunches}, from 2^33 {wflaunches}; "
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
              f"{dpeak / 2**30:.2f} GiB (counting "
              f"{drep['count_peak_bytes'] / 2**30:.2f}); launches "
              f"{dlaunches}", flush=True)
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
              f"device memory peak (counting and trim) "
              f"{dtpeak / 2**30:.2f} GiB; launches "
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
                                          dev, res["bloom_adjudicate"]))
        r, f = res["first_occurrence"], res["bloom_adjudicate"]
        print(f"KF (arrivals from 0) and KI (from 0 and from 2^33) verdicts: "
              f"equal to their plain versions and the host replay on the "
              f"{r['rows_b30']}-row main fold at -b{opt.bf_shift} "
              f"({r['fp_b30']} Bloom hits), the {r['rows_b33']}-row trim "
              f"fold at -b{topt.bf_shift} ({r['fp_b33']}) and the main fold "
              f"at -b{HOT_B} (up to {r['hot_block_rows']} rows a block, "
              f"{r['fp_hot']} hits); KF {f['ms_b30']:.3f} / "
              f"{f['ms_b33']:.3f} / {f['ms_hot']:.3f} ms, KI "
              f"{r['ms_b30']:.3f} / {r['ms_b33']:.3f} / {r['ms_hot']:.3f} "
              f"ms (bounds KF {f['bound_ms_b30']:.4f} / "
              f"{f['bound_ms_b33']:.4f}, KI {r['bound_ms_b30']:.4f} / "
              f"{r['bound_ms_b33']:.4f}); a call's peak KF "
              f"{f['peak_bytes_b30']} / {f['peak_bytes_b33']} bytes, KI "
              f"{r['peak_bytes_b30']} / {r['peak_bytes_b33']}; "
              f"{time.time() - t0:.1f} s", flush=True)
        r = res["cuckoo_build"]
        print(f"KL: the main fold's {r['rows']} kept keys in (shard, "
              f"keybody) order; built from them and from a shuffle of them "
              f"into 2^{r['c_bits']} slots, every fold row looked up as in "
              f"the plain build ({r['mismatches']} mismatches); "
              f"{r['ms']:.3f} ms ({r['ms_shuffled']:.3f} shuffled), device "
              f"work {r['kernel_ms']:.4f} ms, bound {r['bound'][0]:.4f} "
              f"(the first design's {r['bound_ms_first_design']:.4f})",
              flush=True)
        del trim_fold
        torch.cuda.empty_cache()

        # ---- KM against its plain version
        t0 = time.time()
        res["route_rows"] = check_route(opt, main_fold, bases, quals, dev)
        r = res["route_rows"]
        print(f"KM: equal to its plain version by the prefix rule on the "
              f"{r['rows']}-row counting batch (R = 1, 2, 3, 4, 8, 256), by "
              f"the Bloom-block rule on the {r['rows_fold']}-row main fold "
              f"(R = 1, 2, 8, 256) and by both on one row, a ragged tile and "
              f"a dropped tile (R = 3, 256); at R = 2 call "
              f"{r['ms']:.4f} ms, kernels {r['kernel_ms']:.4f} ms on the "
              f"batch, call {r['ms_fold']:.4f} ms, kernels "
              f"{r['kernel_ms_fold']:.4f} ms on the fold; "
              f"{time.time() - t0:.1f} s", flush=True)

        # ---- KN and the sharded KC and KD (phase 13, while the fold is
        # on the card)
        t0 = time.time()
        kn, kc_sh, kd_sh = check_sharded(main_fold, opt, bases, quals, dev,
                                         args.seed, corr_reads)
        res["cuckoo_build_local"] = kn
        res["kcov_island"]["sharded"] = kc_sh
        res["ec1_search"]["sharded"] = kd_sh
        print(f"KN: {kn['keys']} kept entries split by owner at R = 2, 4, 8 "
              f"(entries {kn['rows_by_R']}, cb_local {kn['cb_local_by_R']}); "
              f"KN's sub-tables from each rank's keys in order and "
              f"shuffled, and the plain version's, answer every kept "
              f"entry and {ABSENT_KEYS} other keys as the replicated table "
              f"does ({kn['mismatches']} mismatches); KC and KD over the "
              f"sub-tables equal the replicated table's and their plain "
              f"versions ({kc_sh['mismatches']}, {kd_sh['mismatches']} "
              f"mismatches); at R = 2 KN {kn['ms']:.3f} ms on "
              f"{kn['rows']} keys ({kn['ms_into']:.3f} into a table made "
              f"beforehand, device work {kn['kernel_ms']:.4f} ms, bound "
              f"{kn['bound'][0]:.4f}, the first design's "
              f"{kn['bound_ms_first_design']:.4f}; plain "
              f"{kn['plain_ms']:.1f} ms), KC "
              f"{kc_sh['ms']:.3f} ms (replicated {kc_sh['ms_replicated']:.3f})"
              f", KD {kd_sh['ms']:.3f} ms (replicated "
              f"{kd_sh['ms_replicated']:.3f}); {time.time() - t0:.1f} s",
              flush=True)
        del main_fold
        torch.cuda.empty_cache()

        # ---- the main path over the mesh, through the launcher
        mesh_launches = {}
        rep_bytes = {}
        for sharded in (False, True):
            for n, backend in ((torch.cuda.device_count(), "nccl"),
                               (2, "gloo")):
                mout = tmp / f"corrected_mesh_{backend}.fq"
                mrep = drive_mesh(fq, mout, n, backend, tmp,
                                  shard_table=sharded)
                cs, es = mrep["count_s"], mrep["correct_s"]
                tab_bytes = 8 << (mrep["c_bits"] - (n.bit_length() - 1)
                                  if sharded else mrep["c_bits"])
                if not sharded:
                    rep_bytes[n, backend] = tab_bytes
                print(f"main path over {n} {backend} ranks, {mrep['table']} "
                      f"table (verdict {mrep['verdict']}): counting "
                      f"{cs:.2f} s ({n_reads / cs:.0f} reads/s), correction "
                      f"{es:.2f} s ({n_reads / es:.0f} reads/s), end to end "
                      f"{n_reads / (cs + es):.0f} reads/s; "
                      f"{mrep['n_aggregated']} distinct k-mers aggregated, "
                      f"{mrep['n_kept']} kept; table bytes a rank "
                      f"{tab_bytes}"
                      + (f" (cb_local {mrep['cb_local']}, entries by rank "
                         f"{mrep['entries_by_rank']}; the replicated table "
                         f"{rep_bytes[n, backend]} bytes a rank)"
                         if sharded else "")
                      + f"; scalar fallback {mrep['n_fallback']} reads; "
                      f"launches by rank {mrep['launches_by_rank']}",
                      flush=True)
                check_mesh_run(
                    mrep, n, backend, n_reads,
                    SHARDED_KERNELS if sharded else MESH_KERNELS,
                    ("pack_pull", "bloom_adjudicate")
                    + (("cuckoo_build",) if sharded else ()),
                    mout, main_hash, "sharded" if sharded else "replicated")
                mout.unlink()
                tag = "mesh_sharded" if sharded else "mesh"
                mesh_launches[f"{tag}_{backend}_{n}"] = {
                    name: sum(ls[name] for ls in mrep["launches_by_rank"])
                    for name in SOURCES}
            print(f"mesh outputs ({'sharded' if sharded else 'replicated'} "
                  "table) byte-identical to the main path's", flush=True)
        mout = tmp / "corrected_mesh_stdin.fq"
        with open(fq, "rb") as f:
            mrep = drive_mesh(fq, mout, 1, "nccl", tmp,
                              operands=("-", str(fq)), stdin=f)
        check_mesh_run(mrep, 1, "nccl", n_reads, MESH_KERNELS,
                       ("pack_pull", "bloom_adjudicate"), mout, main_hash,
                       "replicated")
        mout.unlink()
        print(f"main path over 1 nccl rank counting from stdin (`- "
              f"reads.fq`): counting {mrep['count_s']:.2f} s, correction "
              f"{mrep['correct_s']:.2f} s; output byte-identical to the "
              "main path's", flush=True)

        # ---- -r: the reads corrected from phase 2's dump
        rout = tmp / "corrected_restored.fq"
        rrep, rlaunches, _ = drive(opt, fq, rout, in_hash=str(dump))
        print(f"-r on the card: restore and table {rrep['count_s']:.2f} s, "
              f"correction {rrep['correct_s']:.2f} s; {rrep['n_kept']} "
              f"entries, c_bits {rrep['c_bits']}; launches {rlaunches}",
              flush=True)
        need_launched(rlaunches, ("kcov_island", "ec1_search"), "-r")
        need_silent(rlaunches, ("kmer_stream", "run_combine"), "-r")
        if file_hash(rout) != main_hash:
            fail("the output of -r differs from the main path's")
        mrep = drive_mesh(fq, rout, 2, "gloo", tmp, shard_table=True,
                          flags=("-r", str(dump)))
        print(f"-r over 2 gloo ranks, {mrep['table']} table: restore and "
              f"sub-tables {mrep['count_s']:.2f} s, correction "
              f"{mrep['correct_s']:.2f} s; cb_local {mrep['cb_local']}, "
              f"entries by rank {mrep['entries_by_rank']}; launches by rank "
              f"{mrep['launches_by_rank']}", flush=True)
        check_mesh_run(mrep, 2, "gloo", 0, ("cuckoo_build_local",
                                             "kcov_island", "ec1_search"),
                       ("kmer_stream", "cuckoo_build"), rout, main_hash,
                       "sharded")
        rout.unlink()
        mesh_launches["restore"] = rlaunches
        mesh_launches["restore_mesh_sharded_gloo_2"] = {
            name: sum(ls[name] for ls in mrep["launches_by_rank"])
            for name in SOURCES}
        print("-r outputs byte-identical to the main path's", flush=True)

        # ---- the probe path (phase 15)
        t0 = time.time()
        probe_rows, probe_launches = chip_probe.run(dev)
        need_launched(probe_launches, tuple(chip_probe.KERNEL.values()),
                      "the probe path")
        for r in probe_rows:
            lib = r["library_ms"]
            walk = f" ({r['route']} route)" if r["route"] else ""
            print(f"probe {r['site']} {r['kernel']} {r['mode']}{walk}: "
                  f"{r['ms']:.4f} ms ({r['ns_per_step']:.1f} ns a step), "
                  f"plain {r['plain_ms']:.3f} ms, library "
                  f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}); mismatches "
                  f"{r['mismatches']}", flush=True)
        print(f"probe path: {len(probe_rows)} sites equal to their plain "
              f"versions; launches {probe_launches}; "
              f"{time.time() - t0:.1f} s", flush=True)

        # ---- -R over the main path's output (phase 16)
        ropt = Opts()
        ropt.apply_genome_size(cli.parse_size("5m"))
        ropt.refine_ec = True
        flaunches = check_refine_runs(ropt, fq, out_fq, tmp, n_reads,
                                      args.seed)
        out_fq.unlink()
        torch.cuda.empty_cache()

        # ---- --profile (phase 17)
        check_profile(head, tmp)

        # ---- the counting spill (phase 18), and beside its (d) the
        # mesh's spill (phase 19)
        spill_launches = check_spills(opt, bases, quals, tmp)

        # ---- the human-scale tool (phase 20), reads over 504 bp (21)
        human = check_human_scale()
        long_launches = check_long_reads(tmp, args.seed, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    paths = {"main": launches, "trim": tlaunches, "refine": flaunches,
             "main_device_finalize": dlaunches,
             "trim_device_finalize": dtlaunches,
             "trim_device_finalize_from_2^33": ftlaunches,
             "main_count_device_finalize_from_2^33": fclaunches,
             **mesh_launches, **spill_launches,
             "human_scale": human["launches"], **long_launches}
    rows = []
    for name, (tag, src, replaces) in SOURCES.items():
        r = res[name]
        errs = [r] + ([res33[name]] if name in res33 else [])
        mism = sum(x["mismatches"] for x in errs)
        by_path = {p: ls[name] for p, ls in paths.items()}
        kms = (f" (kernel {r['kernel_ms']:.4f} ms" if "kernel_ms" in r
               else "") + (f", at {LONG_L} slots {r['kernel_ms_long']:.4f}"
                           if "kernel_ms_long" in r else "") + (
            ")" if "kernel_ms" in r else "")
        print(f"{tag} {name}: mismatches {mism}; {r['ms']:.3f} ms{kms}, "
              f"plain {r['plain_ms']:.1f} ms, bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]}); launches {by_path}", flush=True)
        if mism != 0:
            fail(f"kernel {name} disagrees with its plain version")
        if "sharded" in r and r["sharded"]["mismatches"]:
            fail(f"kernel {name} over the sub-tables disagrees")
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces,
               "launches": sum(by_path.values()),
               "launches_by_path": by_path,
               "max_abs_err": max(x["max_abs_err"] for x in errs),
               "mismatches": mism,
               "ms": r["ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
               "library_ms": None,
               "timing": (TIMING_MEDIAN if name in ("run_combine",
                                                    "ec1_search")
                          else TIMING_EVENTS)}
        for extra in ("reads", "ms_8192", "us_per_read", "us_per_read_8192",
                      "bound_ms_8192", "cap_reads", "ms_cap",
                      "us_per_read_cap", "sectors_per_s_cap", "bound_ms_cap",
                      "spec_probes", "sectors_per_s", "sectors_per_s_8192", "registers", "local_bytes",
                      "blocks_per_sm", "resident_threads", "batch_peak_bytes",
                      "correction_peak_bytes", "overflow", "top_merge",
                      "plain_reads", "rows", "pull_s", "replay_mismatches",
                      "c_bits", "ms_b30", "ms_b33", "rows_b30", "rows_b33",
                      "ms_hot", "rows_hot", "hot_block_rows", "bound_ms_b30",
                      "bound_ms_b33", "peak_bytes", "peak_bytes_b30",
                      "peak_bytes_b33", "plain_ms_b33",
                      "rows_sent", "ms_fold", "plain_ms_fold",
                      "bound_ms_fold", "rows_fold", "cb_local", "keys",
                      "rows_by_R", "cb_local_by_R", "kernel_ms",
                      "kernel_ms_long", "kernel_ms_fold", "probes", "sectors",
                      "bound_ms_two_sectors", "ms_shuffled", "ms_into",
                      "bound_ms_first_design", "span_rows",
                      "kernel_ms_span", "bound_ms_span"):
            if extra in r:
                row[extra] = r[extra]
        if "kernel_ms" in r:
            row["kernel_timing"] = TIMING_GRAPH
        if "kernel_ms_long" in r:
            row["long_slots"] = LONG_L
        if name == "kcov_island":
            # the sectors KC loads, at the saturated random-sector rate
            # of this run's probe path (KO and KR over 256 MiB)
            rate = max(x["sectors_per_s"] for x in probe_rows
                       if x["site"] in SATURATED_SITES)
            row["sector_ceiling_per_s"] = rate
            row["sector_ceiling_ms"] = r["sectors"] / rate * 1e3
        if "sharded" in r:
            row["sharded_r2"] = {"ms": r["sharded"]["ms"],
                                 "ms_replicated": r["sharded"]["ms_replicated"],
                                 "mismatches": r["sharded"]["mismatches"]}
        if name == "run_combine":
            row["max_abs_err"] = max(row["max_abs_err"],
                                     res["run_combine_merges"][0])
            row["merges_checked"], row["max_merge_rows"] = \
                res["run_combine_merges"][1:]
        rows.append(row)
    rows += probe_kernel_rows(probe_rows, probe_launches)
    print(f"chip_smoke: {time.time() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
