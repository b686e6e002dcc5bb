"""A/B measurement of KA (kmer_stream), KB (run_combine), KC (kcov_island),
KD (ec1_search), KF (bloom_adjudicate), KI (first_occurrence), KM
(route_rows), KH (max_streak), KL (cuckoo_build), KN
(cuckoo_build_local), KK (finalize_counts), KO (probe_flat_gather), KP
(probe_tile_gather), KQ (probe_onehot_passes) and KR (probe_two_plane)
of one tree of bfc_tpu_torch on one CUDA card.

    python3 chip_ab.py [--tree DIR] [--genome BASES] [--seed N]
                       [--correct-batch N]
                       [--parts main,verdicts,km,kh,kl,kn,kk,ko,kp,kq,kr,paths,
                                alloc]
    python3 chip_ab.py --verdict-variants

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
that pass's batch instead.  Then the verdicts: the counting peaks
of the device finalize on the main path (-b30) and on the trim path
(`-1 -k51`, -b33), and KF (arrivals from 0) and KI (from 0 and from
2^33) on the main path's fold (-b30) and the trim path's fold (-b33),
each as the mean of 5 wrapper calls (host cost included), as a kernel
(the median replay of a CUDA graph of 5 launches of the tree's launcher
on inputs and scratch made beforehand, host cost excluded; "scope" says
what that launcher does; "breakdown_ms" its kernels' device ms from a
torch.profiler trace), with the sha256 of fp (and KF's keep) and the
device bytes a wrapper call allocates above what was held.  Then KM by
the prefix rule on the 2,097,152-row counting batch (KA's rows of the
first 16,384 reads) at R = 1, 2 and 8, and by the Bloom-block rule on the
main fold's (ret, arrival) rows at R = 2 and 8; and KH over the trim
path's Bloom filter (`-1 -k51`, -b33) on the 8,192-read trim batch of 128
slots and on 4,096 rows of 600 slots (chip_smoke.py's long rows).  Each
as the mean of 20 wrapper calls in a row and the median of 11 timed one
at a time (host cost included), and as kernels (the median replay of a
CUDA graph of 50 calls, host cost excluded: KH its wrapper, whose call
launches and returns; KM its launches alone, on inputs, scan scratch and
outputs allocated beforehand: the count, the scan and the scatter, with
no read of the counts; "breakdown_ms" their device ms from a
torch.profiler trace), with the sha256 of KM's columns, counts and perm
and of KH's output, KM's rows sent and a call's device bytes above what
was held, and each bound (chip_smoke.py's count); and the host side of
one trim batch without KH (trim_host_ms).
Then KL on the main fold's kept entries (KI's verdict at -b30, KK's
payloads; c_bits by table_c_bits) and KN on rank 0's of them at R = 2
(cb_local by subtable_bits, into a table allocated beforehand, as the
mesh passes its IPC buffer), each as the mean of 20 calls and the median
of 11 timed one at a time (host cost and the wait on the failure count
included), as its device work alone (the median replay of a CUDA graph
of 50 builds on buffers made beforehand: the table or scratch cleared
and the launches, no wait), split into kernels and memsets
("breakdown_ms", torch.profiler) and into the host's wait on the failure
count ("wait_ms": the CPU time of aten::_local_scalar_dense a call),
with a call's device bytes above what was held; lookups of every fold
row (KN: through both ranks' sub-tables) against the kept payloads
("mismatches") and their sha256, also from the keys in a seeded random
order (call ms "ms_shuffled"); the bound (table written once, 20 bytes
read a key) and the first design's (and a random 32-byte sector
written a key).
Then KK on the main fold (KI's verdict at -b30, as the device finalize
takes it): the call (the median of 11 timed one at a time, host cost
included, and the mean of 20), the kernel alone (the median replay of a
CUDA graph of 50 launches on outputs allocated beforehand), its
torch.profiler split, a call's device bytes above what was held, the
sha256 of payload, keep, hist and hist_high and their mismatches against
the plain version, and the bound (23 bytes a row); then the compaction
that follows KK on the device finalize and the mesh (torch.nonzero(keep)
and the gathers of shard, keybody and payload): call (median of 11),
split, peak and sha256.  And KP at each of its probe sites
(chip_probe.py: p2_sD1, p2_sD1_loop, p2_sD2, p2_sD2_loop, sg_sC and
sg_sD): the route the wrapper took where the tree's wrapper names one, the
kernel's, plain version's and library call's device ms (CUDA graphs, as
chip_probe.py times them), the bound and the sha256 of the output; in a
tree with KP's routes, column mode's two routes forced on the same
inputs over an 8,192-row table, by steps, at 32, 2,048 and 8,192
queries, each output held against the plain version.  KQ and KR the same
at theirs (KQ: r2_s4a, p2_sE and sg_sF in both variants; KR: sg_sG and
the four hbm_KR sites over 256 MiB), with the route each KR site takes;
in a tree with KR's routes, both routes forced on sG's planes and on the
256 MiB cuckoo planes at 8,192 to 4,194,304 queries (kr_routes), with
the sectors each needs and issues a second and the global loads of KR's
kernels (cuobjdump -sass).  KO the same at its eleven sites, and the
order of its loads (ko_order: 4,194,304 start indices over the 256 MiB
table as drawn, sorted and by regions, at 1 and 4 steps).  The probe
parts (ko, kp, kq, kr) make no reads.
Then (paths) the walls of the paths that run KH and KM, as their reports
give them, with the outputs' sha256: the trim path (`-1 -k51`, host
finalize) through run_device, and the main path over two gloo ranks
sharing the card (`--mesh 2 -s 5m`) through the launcher, with every
rank's KM launches.  And (alloc) the host passes that glibc's allocator
setting of bfc_tpu_torch/__init__.py is for, as the first part of its
process: the counting pass with the host finalize, then the same under
BFC_TPU_MAX_MERGE_CAP=4194304 (chip_smoke.py's phase 18 (a)), each with
its wall, spills, host-merge, pull and pack seconds and the process's
peak resident set after it, and whether the tree sets the allocator.
--parts picks the sections: main (the count and KA-KD, the correction
pass), verdicts, km, kh, kl, kn, kk, ko, kp, kq, kr, paths, alloc.

--verdict-variants measures designs of the KF/KI verdict instead: it
builds the verdict's two libraries as they stand and once for each of
VARIANTS (a copy of csrc/ with verdict.cuh edited) into
build/verdict_variants/, then on synthetic folds the size of the
3M-read runs' (63,109,113 rows at -b33 in random row order, as the trim
fold's; 49,804,406 at -b30 in random order and sorted by Bloom block, as
the main fold's rows lie) times each launcher (CUDA events, the mean of
3 launches; n_hashes 4, arrivals a permutation of the rows), breaks it
into kernels with torch.profiler and checks that every variant's fp
equals the first one's; "base_S<k>" runs with superblocks of 2^k blocks
in place of spectrum.verdict_shift's.  One JSON line a run.  Without a
CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
KD_READS = (8192, 65536, 131072)
TAIL_READS = 64
CALL_REPS = 20   # KA's and KC's wrapper calls a mean (chip_smoke.py's)
MEDIAN_REPS = 11  # KM's and KH's calls timed one at a time for a median
GRAPH_REPS = 50  # calls in a timed CUDA graph (chip_probe.py's REPS)
VERDICT_REPS = 5  # KF's and KI's calls a mean, and launches a graph
FAR = 1 << 33     # arrivals from here take KI
# the verdict's variants: name: [(text in verdict.cuh, its replacement)];
# "noagg" counts and takes slots with one atomic a row, not one a
# superblock a warp
VARIANTS = {
    "base": [],
    "pair4": [("#define VD_PAIR 8 ", "#define VD_PAIR 4 ")],
    "pair16": [("#define VD_PAIR 8 ", "#define VD_PAIR 16 ")],
    "g8": [("#define VD_GROUP 32 ", "#define VD_GROUP 8 ")],
    "noagg": [
        ("    unsigned peers = vd_peers(q, &rank);\n"
         "    if (i < C && rank == 0) atomicAdd(cnt + q, "
         "(uint32_t)__popc(peers));",
         "    if (i < C) atomicAdd(cnt + q, 1u);"),
        ("    unsigned peers = vd_peers(q, &rank);\n"
         "    uint32_t end = 0;\n"
         "    if (i < C && rank == 0) end = atomicSub(ends + q, "
         "(uint32_t)__popc(peers));\n"
         "    end = __shfl_sync(0xFFFFFFFFu, end, __ffs(peers) - 1);",
         "    uint32_t end = i < C ? atomicSub(ends + q, 1u) : 0u;\n"
         "    rank = 0;")],
}
# KM's cases: (rule, ranks); the prefix rule on the counting batch, the
# Bloom-block rule on the main fold
KM_CASES = (("prefix", 1), ("prefix", 2), ("prefix", 8), ("bloom", 2),
            ("bloom", 8))
PARTS = ("main", "verdicts", "km", "kh", "kl", "kn", "kk", "ko", "kp", "kq",
         "kr", "paths", "alloc")
PROBE_PARTS = {"ko": "KO", "kp": "KP", "kq": "KQ",
               "kr": "KR"}   # chip_probe.py's sites
# KP's column routes forced on one 8,192-row table: (queries, steps)
KP_ROUTE_ROWS = 8192
KP_ROUTE_CASES = tuple((q, k) for q in (32, 2048, 8192)
                       for k in (1, 2, 4, 6, 8, 16))
# KR's routes forced over the 256 MiB cuckoo planes: (queries, steps)
KR_ROUTE_CASES = ((8192, 4), (8192, 64), (32768, 4), (131072, 4),
                  (524288, 4), (1 << 20, 4), (1 << 22, 4))
# KO over the 256 MiB table: the order of 4,194,304 start indices (as
# drawn, sorted, and by regions of 2^shift entries, random within one) at
# 1 and 4 steps
KO_ORDER_STEPS = (1, 4)
KO_ORDER_SHIFTS = (10, 14, 18)
VARIANT_FOLDS = (("b33", 63_109_113, 33, "random"),
                 ("b30", 49_804_406, 30, "random"),
                 ("b30", 49_804_406, 30, "sorted"))
VARIANT_SHIFTS = {33: (6, 7), 30: (4, 6)}


def _load_smoke():
    """chip_smoke.py of this directory (data recipe, batches, timing),
    with chip_probe.py of this directory as the one it imports."""
    spec = importlib.util.spec_from_file_location("chip_probe",
                                                  HERE / "chip_probe.py")
    probe = importlib.util.module_from_spec(spec)
    sys.modules["chip_probe"] = probe
    spec.loader.exec_module(probe)
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


def _peak(torch, fn):
    """(fn(), device bytes it allocated above what was held)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _breakdown(torch, fn, reps: int) -> dict:
    """Device ms a call of each kernel (and memset) that fn launches, from
    a torch.profiler trace of reps calls; {} where it holds no device
    time, {"error": ...} where the profiler fails on this machine."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:
        return {"error": str(e)[:200]}
    out = {}
    for e in prof.key_averages():
        us = (getattr(e, "device_time_total", 0)
              or getattr(e, "cuda_time_total", 0))
        if us:
            out[e.key.split("(")[0].replace("void ", "")] = us / 1e3 / reps
    return out


def verdicts(torch, smoke, kernels, spec, sdn, run, b: int, H: int):
    """KF and KI of this tree on one fold (run, with ret) at -b: wrapper
    call ms, kernel ms, sha256, a call's peak bytes.  The kernel is the
    tree's launcher alone: this design's does the whole verdict; the
    first KF's too (its scratch cleared and two passes), the first KI's
    only the block replay, after the wrapper's sorts and nonzero."""
    ret, C, dev = run.ret, len(run), run.ret.device
    a32 = sdn.as_i32(run.arr)
    n32 = run.n.clamp(max=0x7FFFFFFF).to(torch.int32)
    fp = torch.empty((C,), dtype=torch.bool, device=dev)
    keep = torch.empty((C,), dtype=torch.bool, device=dev)
    new = hasattr(spec, "verdict_bytes")
    out = {"rows": C, "bf_shift": b}
    for name, shift in (("kf", 0), ("ki", 0), ("ki", FAR)):
        arr = run.arr + shift
        if name == "kf":
            call = lambda: spec.adjudicate_sketch(ret, a32, n32, b, H)
        else:
            call = lambda: (spec.adjudicate_first_occurrence(ret, arr, b, H),)
        got, peak = _peak(torch, call)
        r = {"sha256": _sha(*got), "peak_bytes": peak,
             "fp": int(got[0].sum()),
             "ms": smoke.cuda_ms(call, VERDICT_REPS)}
        del got
        if new:
            scratch, sb, *addrs = spec.verdict_scratch(C, b, dev,
                                                        name.upper())
            if name == "kf":
                args = ("kf_launch", C, ret.data_ptr(), a32.data_ptr(),
                        n32.data_ptr(), b, sb, H, *addrs, fp.data_ptr(),
                        keep.data_ptr())
            else:
                args = ("ki_launch", C, ret.data_ptr(), arr.data_ptr(), b, sb,
                        H, *addrs, fp.data_ptr())
            r["superblock_shift"] = sb
            r["scope"] = "the whole verdict"
        elif name == "kf":
            scratch = torch.empty((1 << b,), dtype=torch.int32, device=dev)
            args = ("kf_launch", C, ret.data_ptr(), a32.data_ptr(),
                    n32.data_ptr(), b, H, scratch.data_ptr(), fp.data_ptr(),
                    keep.data_ptr())
            r["scope"] = "the whole verdict (scratch cleared, two passes)"
        else:
            perm, starts = spec.block_order(ret, arr, b)
            scratch = (perm, starts)
            args = ("ki_launch", starts.shape[0] - 1, starts.data_ptr(),
                    perm.data_ptr(), ret.data_ptr(), arr.data_ptr(), b, H,
                    fp.data_ptr())
            r["scope"] = ("the block replay only, without the wrapper's two "
                          "torch.sort passes, gathers and nonzero")
        kern = kernels.KF if name == "kf" else kernels.KI
        r["kernel_ms"] = smoke.graph_ms([lambda: kern.launch(*args)],
                                        VERDICT_REPS)
        r["breakdown_ms"] = _breakdown(torch, lambda: kern.launch(*args),
                                       VERDICT_REPS)
        del scratch
        torch.cuda.empty_cache()
        out[name if shift == 0 else f"{name}_from_2^33"] = r
    return out


def km_launches(torch, kernels, route, cols, R, rule, param, shard, ret,
                got):
    """KM's launches alone for one case, on inputs, scan scratch and
    outputs allocated here (got: a wrapper call's result, which sizes the
    first design's outputs): a function that enqueues them."""
    N, dev = cols[0].shape[0], cols[0].device

    def p(t):
        return None if t is None else t.data_ptr()

    if hasattr(route, "enqueue"):  # one sync a call: count + scan, scatter
        buf = route.buffer(N, R, sum(c is not None for c in cols), dev)
        return lambda: route.enqueue(cols, R, rule, param, shard, ret, buf)
    # the first design: count, torch.cumsum, scatter into exact outputs
    n_tiles = (N + route.TILE - 1) // route.TILE
    cnt = torch.empty((R * n_tiles,), dtype=torch.int64, device=dev)
    off = torch.empty_like(cnt)
    n = sum(got.counts)
    outs = [None if c is None else torch.empty((n,), dtype=torch.int64,
                                               device=dev) for c in cols]
    perm = torch.empty((n,), dtype=torch.int64, device=dev)
    pad = [None] * (route.MAX_COLS - len(cols))

    def fn():
        kernels.KM.launch("km_count_launch", N, rule, p(shard), p(ret),
                          param, R, n_tiles, p(cnt))
        torch.cumsum(cnt, 0, out=off)
        off.sub_(cnt)
        kernels.KM.launch("km_scatter_launch", N, rule, p(shard), p(ret),
                          param, R, n_tiles, p(off), *(p(c) for c in cols),
                          *pad, *(p(o) for o in outs), *pad, p(perm))
    return fn


def route_cases(torch, smoke, kernels, route, sdn, opt, bases, quals, dev,
                fold) -> dict:
    """KM of this tree at KM_CASES: call ms, kernels ms, sha256, rows
    sent, a call's peak bytes, bound."""
    k, l_pre = opt.k, opt.effective_l_pre()
    carry = not sdn.ret_derivable(k, l_pre)
    cb, cq, cl = smoke.count_batch(bases, quals, opt, dev)
    rows = sdn.chunk_rows(cb, cq, cl, 0, k, l_pre, carry)
    ret = sdn.derive_ret(fold.shard, fold.keybody, k, l_pre)
    inputs = {"prefix": (list(rows), route.PREFIX, l_pre, rows.shard, None),
              "bloom": ([ret, fold.arr], route.BLOOM, opt.bf_shift, None,
                        ret)}
    out = {}
    for rule, R in KM_CASES:
        cols, rid, param, shard, key_ret = inputs[rule]
        call = lambda: route.route_rows(cols, R, rid, param, shard=shard,
                                        ret=key_ret)
        got, peak = _peak(torch, call)
        N = cols[0].shape[0]
        n_cols = sum(c is not None for c in cols)
        sent = sum(got.counts)
        r = {"rows": N, "columns": n_cols, "rows_sent": sent,
             "counts": got.counts, "peak_bytes": peak,
             "sha256": _sha(*(c for c in got.cols if c is not None),
                            torch.tensor(got.counts), got.perm),
             "bound_ms": smoke.bound(N * 8 * n_cols
                                     + sent * 8 * (n_cols + 1),
                                     N * smoke.OPS_KM_ROW)[0],
             "ms": smoke.cuda_ms(call, CALL_REPS),
             "ms_median": smoke.cuda_median_ms(call, MEDIAN_REPS)}
        fn = km_launches(torch, kernels, route, cols, R, rid, param, shard,
                         key_ret, got)
        del got
        r["kernel_ms"] = smoke.graph_ms([fn], GRAPH_REPS)
        r["breakdown_ms"] = _breakdown(torch, fn, 5)
        del fn
        torch.cuda.empty_cache()
        out[f"{rule}_R{R}"] = r
    return out


def streak_cases(torch, smoke, TT, bloom, topt, bases, quals, dev) -> dict:
    """KH of this tree over the trim Bloom filter on the trim batch and on
    rows of 600 slots: call ms, kernel ms, sha256, bound."""
    rlen = bases.shape[1]
    tb = torch.full((smoke.TRIM_B, smoke.TRIM_L), 4, dtype=torch.uint8)
    tb[:, :rlen] = torch.from_numpy(bases[:smoke.TRIM_B])
    tl = torch.full((smoke.TRIM_B,), rlen, dtype=torch.int32)
    lb, _, ll = smoke.long_batch(bases, quals, topt, dev)
    out = {"host_prep_ms": trim_host_ms(torch, smoke, bases, dev)}
    for name, (b, lens) in (("trim_batch", (tb.to(dev), tl.to(dev))),
                            ("slots_600", (lb, ll))):
        B, L = b.shape
        call = lambda: TT.max_streak_batch(bloom.words, b, lens, topt.k,
                                           bloom.bf_shift, bloom.n_hashes)
        got = call()
        probes = int((lens.to(torch.int64) - topt.k + 1).clamp(min=0).sum())
        out[name] = {
            "reads": B, "slots": L, "probes": probes, "sha256": _sha(got),
            "streak_reads": int((got >> 32 > 0).sum()),
            "bound_ms": smoke.bound(B * (L + 4 + 8) + probes * smoke.BLOCK,
                                    probes * (smoke.OPS_KMER
                                              + smoke.OPS_BLOOM))[0],
            "ms": smoke.cuda_ms(call, CALL_REPS),
            "ms_median": smoke.cuda_median_ms(call, MEDIAN_REPS),
            "kernel_ms": smoke.graph_ms([call], GRAPH_REPS)}
    return out


def _wait_ms(torch, fn, reps: int):
    """CPU ms a call of fn spends in aten::_local_scalar_dense (int() of a
    device tensor: the wait for the work queued before it), from a
    torch.profiler trace of reps calls; None where none ran."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(reps):
            fn()
    for e in prof.key_averages():
        if e.key == "aten::_local_scalar_dense":
            return e.cpu_time_total / 1e3 / reps
    return None


def cuckoo_work(torch, kernels, spec, kern, geom, keys, table):
    """The device work of one KL or KN build of keys into table, on
    scratch made here, with no wait: a function that enqueues it.  This
    design: its counters cleared and its launches; the first design: the
    table and the failure count cleared, one launch."""
    s, kb, p = keys
    if hasattr(spec, "cuckoo_enqueue"):
        rec, meta = spec.cuckoo_scratch(s.shape[0], geom[-1] if
                                        kern is kernels.KN else geom[2],
                                        s.device)
        return lambda: spec.cuckoo_enqueue(kern, geom, s, kb, p, table, rec,
                                           meta)
    fail = torch.zeros((1,), dtype=torch.int32, device=s.device)
    fn = "kl_launch" if kern is kernels.KL else "kn_launch"

    def work():
        table.zero_()
        fail.zero_()
        kern.launch(fn, s.shape[0], s.data_ptr(), kb.data_ptr(),
                    p.data_ptr(), *geom, table.data_ptr(), fail.data_ptr())
    return work


def cuckoo_cases(torch, smoke, kernels, spec, C, kops, opt, fold, which,
                 seed: int) -> dict:
    """KL on the main fold's kept entries and KN on rank 0's at R = 2 (as
    the module docstring says): call, device work, breakdown, wait, peak,
    lookups and bounds; which: the parts asked for, of kl and kn."""
    k, l_pre = opt.k, opt.effective_l_pre()
    kb_bits = kops.keybody_bits(k, l_pre)
    dev = fold.shard.device
    fp = spec.adjudicate_first_occurrence(fold.ret, fold.arr, opt.bf_shift,
                                          opt.n_hashes)
    payload, keep = spec.finalize_counts(fold.n, fold.n_high,
                                         fold.first_high, fp)[:2]
    idx = torch.nonzero(keep).flatten()
    ks, kkb, kp = fold.shard[idx], fold.keybody[idx], payload[idx]
    want = torch.where(keep, payload, -1).to(torch.int64)
    del fp, payload, keep, idx
    gen = torch.Generator().manual_seed(seed)
    cases = []
    if "kl" in which:
        c_bits = C.table_c_bits(ks.shape[0], k, l_pre,
                                opt.predicted_c_bits())

        def build_kl(s, kb, p):
            return spec.cuckoo_build(s, kb, p, k, l_pre, kb_bits, c_bits)

        def look_kl(s, kb, p):
            t, ok = build_kl(s, kb, p)
            return spec.cuckoo_lookup_plain(
                spec.SpecTable(t, k, l_pre, kb_bits, c_bits), fold.shard,
                fold.keybody), ok
        cases.append(("kl", kernels.KL, (l_pre, kb_bits, c_bits), c_bits,
                      (ks, kkb, kp), None, build_kl, look_kl))
    if "kn" in which:
        owner = spec.subtable_owner(ks, kkb, l_pre, kb_bits, 1)
        cb_local = C.subtable_bits(
            max(torch.bincount(owner, minlength=2).tolist()), k, l_pre, 1)
        mine = torch.nonzero(owner == 0).flatten()
        tab = torch.empty((1 << cb_local,), dtype=torch.int64, device=dev)

        def build_kn(s, kb, p, out=tab):
            return spec.cuckoo_build_local(s, kb, p, l_pre, kb_bits,
                                           1 + cb_local, 1, out=out)

        def look_kn(s, kb, p):
            # both ranks' sub-tables, each from its rows in this order
            rank = spec.subtable_owner(s, kb, l_pre, kb_bits, 1)
            subs = [build_kn(s[rank == r], kb[rank == r], p[rank == r],
                             out=None) for r in (0, 1)]
            st = spec.sharded_table([t for t, _ in subs], k, l_pre, kb_bits,
                                    1)
            return (spec.cuckoo_lookup_plain(st, fold.shard, fold.keybody),
                    all(ok for _, ok in subs))
        cases.append(("kn", kernels.KN,
                      (l_pre, kb_bits, 1 + cb_local, cb_local), cb_local,
                      (ks[mine], kkb[mine], kp[mine]), tab, build_kn,
                      look_kn))
        del owner, mine
    out = {}
    for name, kern, geom, tb, keys, tab, build, look in cases:
        m = keys[0].shape[0]
        call = lambda: build(*keys)
        _, peak = _peak(torch, call)
        kernels.reset_launches()
        call()
        r = {"rows": m, "table_bits": tb, "peak_bytes": peak,
             "launches_a_call": kern.launches,
             "ms": smoke.cuda_ms(call, CALL_REPS),
             "ms_median": smoke.cuda_median_ms(call, MEDIAN_REPS)}
        new, old = smoke.cuckoo_bound(m, tb)
        r["bound_ms"], r["bound_ms_first_design"] = new[0], old[0]
        table = (tab if tab is not None else
                 torch.empty((1 << tb,), dtype=torch.int64, device=dev))
        work = cuckoo_work(torch, kernels, spec, kern, geom, keys, table)
        r["kernel_ms"] = smoke.graph_ms([work], GRAPH_REPS)
        r["breakdown_ms"] = _breakdown(torch, call, 5)
        r["wait_ms"] = _wait_ms(torch, call, 5)
        del work, table
        shuffled = tuple(x[torch.randperm(m, generator=gen).to(dev)]
                         for x in keys)
        r["ms_shuffled"] = smoke.cuda_ms(lambda: build(*shuffled), CALL_REPS)
        del shuffled
        torch.cuda.empty_cache()
        # lookups of every fold row, from all kept keys in order and shuffled
        order = torch.randperm(ks.shape[0], generator=gen).to(dev)
        for tag, all_keys in (("sorted", (ks, kkb, kp)),
                              ("shuffled", (ks[order], kkb[order],
                                            kp[order]))):
            got, ok = look(*all_keys)
            r[f"mismatches_{tag}"] = int((got != want).sum()) + (not ok)
            r[f"sha256_{tag}"] = _sha(got)
            del got, all_keys
            torch.cuda.empty_cache()
        out[name] = r
    return out


def kk_cases(torch, smoke, kernels, spec, fold, opt) -> dict:
    """KK on the main fold with KI's verdict, and the compaction after it
    (as the module docstring says)."""
    fp = spec.adjudicate_first_occurrence(fold.ret, fold.arr, opt.bf_shift,
                                          opt.n_hashes)
    cols = (fold.n, fold.n_high, fold.first_high, fp)
    C, dev = fold.n.shape[0], fold.n.device
    call = lambda: spec.finalize_counts(*cols)
    got, peak = _peak(torch, call)
    want = spec.finalize_counts_plain(*cols)
    kernels.reset_launches()
    call()
    r = {"rows": C, "kept": int(got[1].sum()), "peak_bytes": peak,
         "launches_a_call": kernels.KK.launches, "sha256": _sha(*got),
         "mismatches": sum(int((g != w).sum()) for g, w in zip(got, want)),
         "ms_median": smoke.cuda_median_ms(call, MEDIAN_REPS),
         "ms": smoke.cuda_ms(call, CALL_REPS),
         "bound_ms": smoke.bound(C * 23, C * smoke.OPS_KK_ROW)[0]}
    del want
    payload = torch.empty((C,), dtype=torch.int32, device=dev)
    keep = torch.empty((C,), dtype=torch.bool, device=dev)
    hist = torch.zeros((256,), dtype=torch.int64, device=dev)
    hist_high = torch.zeros((64,), dtype=torch.int64, device=dev)
    args = (C, *(x.data_ptr() for x in (*cols, payload, keep, hist,
                                        hist_high)))
    r["kernel_ms"] = smoke.graph_ms(
        [lambda: kernels.KK.launch("kk_launch", *args)], GRAPH_REPS)
    r["breakdown_ms"] = _breakdown(torch, call, 5)
    del payload, keep, hist, hist_high
    payload, keep = got[:2]

    def compact():
        idx = torch.nonzero(keep).flatten()
        return fold.shard[idx], fold.keybody[idx], payload[idx]
    kept, cpeak = _peak(torch, compact)
    comp = {"rows": C, "kept": kept[0].shape[0], "peak_bytes": cpeak,
            "sha256": _sha(*kept),
            "ms_median": smoke.cuda_median_ms(compact, MEDIAN_REPS),
            "breakdown_ms": _breakdown(torch, compact, 5),
            # keep read once; each kept row's shard, keybody and payload
            # read and written once
            "bound_ms": smoke.bound(C + kept[0].shape[0] * 40, 0)[0]}
    del got, kept, fp
    torch.cuda.empty_cache()
    return {"kk": r, "compaction": comp}


def probe_cases(torch, probe_mod, kernels, dev, seed: int, tag: str) -> dict:
    """KP, KQ or KR (tag) at its probe sites: chip_probe.run's rows
    (check, times, bound), the route the tree's wrapper takes where it
    names one, and the sha256 of each site's output; where the tree has
    routes, KP's column routes (kp_routes) and KR's (kr_routes) forced on
    the same inputs."""
    from bfc_tpu_torch.ops import probe as P
    sites = [s for s in probe_mod.SITES if s.kernel == tag]
    rows, launches = probe_mod.run(dev, sites=sites)
    out = {"launches": launches[probe_mod.KERNEL[tag]]}
    for s, r in zip(sites, rows):
        inp = probe_mod.make_inputs(s, dev)
        r["sha256"] = _sha(*probe_mod.kernel_call(s, inp))
        r["route"] = probe_mod.route(s) or "the first design"
        out[probe_mod.label(s)] = r
        del inp
    if tag == "KO":
        out["order"] = ko_order(torch, probe_mod, P, dev)
    if tag == "KP" and hasattr(P, "tile_route"):
        out["routes"] = kp_routes(torch, probe_mod, kernels, P, dev, seed)
    if tag == "KR" and hasattr(P, "two_plane_route"):
        out["routes"] = kr_routes(torch, probe_mod, kernels, P, dev, seed)
    torch.cuda.empty_cache()
    return out


def ko_order(torch, probe_mod, P, dev) -> dict:
    """Does the order in which a step's loads are issued move the card's
    random-sector rate?  The tree's flat_gather over the 256 MiB table of
    the hbm_KO sites with the same 4,194,304 start indices as drawn
    ("random"), sorted ("sorted"), and by regions of 2^shift entries,
    random within a region ("region_<shift>"), at KO_ORDER_STEPS.  At
    one step the sorted call is the ceiling of any route that issues a
    step's loads in address order.  Fresh start indices a call
    (chip_probe.start_sets), each ordered the same way; device ms a call
    (CUDA graphs), sectors a second (one an access), each output held
    against the plain version; and the distinct 32-byte sectors and
    64-byte pairs of sectors the first step touches."""
    big = next(s for s in probe_mod.SITES if s.name == "hbm_KO_q4194304")
    inp = probe_mod.make_inputs(big, dev)
    tab = inp["tab"]
    out = {}
    for steps in KO_ORDER_STEPS:
        s = big._replace(steps=steps)
        sets = probe_mod.start_sets(s, inp, dev)
        orders = {"random": lambda i: i, "sorted": lambda i: i.sort()[0]}
        for shift in KO_ORDER_SHIFTS:
            orders[f"region_{shift}"] = lambda i, sh=shift: i[torch.sort(
                i >> sh, stable=True)[1]]
        r = {"queries": s.q, "steps": steps, "start_sets": len(sets)}
        for name, order in orders.items():
            idxs = [order(x["idx"]) for x in sets]
            got = P.flat_gather(tab, idxs[0], steps)
            want = P.flat_gather_plain(tab, idxs[0], steps)
            if any(bool((a != b).any()) for a, b in zip(got, want)):
                raise RuntimeError(f"chip_ab: KO {name} at {steps} steps "
                                   "differs from its plain version")
            ms = probe_mod.graph_ms(
                [lambda i=i: P.flat_gather(tab, i, steps) for i in idxs],
                GRAPH_REPS)
            r[name] = {"ms": ms,
                       "sectors_per_s": s.q * steps / (ms * 1e-3)}
        ix = sets[0]["idx"].long()
        r["distinct_sectors"] = int(torch.unique(ix >> 3).numel())
        r["distinct_64b"] = int(torch.unique(ix >> 4).numel())
        r["sorted_speedup"] = r["random"]["ms"] / r["sorted"]["ms"]
        out[f"steps_{steps}"] = r
        del sets
    del inp, tab
    torch.cuda.empty_cache()
    return out


def kp_routes(torch, probe_mod, kernels, P, dev, seed: int) -> dict:
    """KP's column mode on its shared and global routes, forced on the
    same inputs over an 8,192-row table, by steps, at 32 queries (nearly
    the stage alone), 2,048 and 8,192.  Device ms a call (CUDA graphs, as
    chip_probe.py times the sites), each output held against the plain
    version, and the route tile_route takes."""
    R = KP_ROUTE_ROWS
    gen = torch.Generator().manual_seed(seed)
    tab = torch.randint(0, 1 << 30, (R, P.W), generator=gen,
                        dtype=torch.int32).to(dev)
    out = {}
    for Q, steps in KP_ROUTE_CASES:
        idx = torch.randint(0, R, (Q, P.W), generator=gen,
                            dtype=torch.int32).to(dev)
        want = P.tile_gather_plain(tab, idx, steps, P.COLUMN)
        got = [torch.empty_like(w) for w in want]
        calls = {route: lambda staged=staged: kernels.KP.launch(
            "kp_column_launch", Q, tab.data_ptr(), R, idx.data_ptr(),
            steps, staged, got[0].data_ptr(), got[1].data_ptr())
            for route, staged in ((P.SHARED, 1), (P.GLOBAL, 0))}
        r = {"taken": P.tile_route(R, P.COLUMN, steps, Q)}
        for route, call in calls.items():
            call()
            torch.cuda.synchronize()
            if any(bool((g != w).any()) for g, w in zip(got, want)):
                raise RuntimeError(f"chip_ab: KP column {route} route at "
                                   f"{Q} queries x {steps} steps differs "
                                   "from its plain version")
            r[route] = probe_mod.graph_ms([call], GRAPH_REPS)
        out[f"column_q{Q}_s{steps}"] = r
    return out


def kr_routes(torch, probe_mod, kernels, P, dev, seed: int) -> dict:
    """KR's eager and lazy routes, forced on the same inputs: sG's planes (chip_probe's sg_sG site, in
    L2) and the 256 MiB cuckoo planes (the hbm_KR sites' recipe: every key
    in its second slot) at KR_ROUTE_CASES, fresh start indices a call
    where the planes exceed L2 (chip_probe.start_sets).  Device ms a call
    (CUDA graphs, as chip_probe.py times the sites), each output held
    against the plain version, the sectors a call needs (chip_probe's
    touched) and issues (eager, as nvcc builds kr_query: hi at both
    slots and lo at the second a step, lo at the first where it matched;
    lazy: hi at both slots, lo where a slot matched), each a second, and
    the route that two_plane_route takes; and the global loads of each
    KR kernel in the tree's library (kr_loads)."""
    import numpy as np
    kr = [s for s in probe_mod.SITES if s.kernel == "KR"]
    g = next(s for s in kr if s.recipe == "planes")
    big = next(s for s in kr if s.recipe == "cuckoo")
    planes = probe_mod.make_inputs(big, dev)
    cases = [(g, probe_mod.make_inputs(g, dev))]
    rng = np.random.default_rng(seed)
    for q, steps in KR_ROUTE_CASES:
        s = big._replace(name=f"hbm_KR_q{q}_s{steps}", q=q, steps=steps)
        cases.append((s, dict(planes, idx=torch.from_numpy(rng.integers(
            0, s.n, q).astype(np.int32)).to(dev))))
    out = {}
    for s, inp in cases:
        sets = probe_mod.start_sets(s, inp, dev)
        want = probe_mod.plain_call(s, inp)
        needed = probe_mod.work(s, sets)[1]
        hits1, hits = (sum(h) / len(sets) for h in zip(
            *(_kr_hits(torch, P, x, s.steps) for x in sets)))
        got = [torch.empty_like(inp["idx"]) for _ in range(2)]
        r = {"queries": s.q, "steps": s.steps, "table_entries": s.n,
             "recipe": s.recipe, "start_sets": len(sets),
             "taken": P.two_plane_route(s.q, s.steps),
             "sectors_needed": needed}
        for name in (P.EAGER, P.LAZY):
            def call(x, lazy=int(name == P.LAZY)):
                kernels.KR.launch("kr_launch", s.q, x["lo"].data_ptr(),
                                  x["hi"].data_ptr(), s.n,
                                  x["idx"].data_ptr(), s.steps, lazy,
                                  got[0].data_ptr(), got[1].data_ptr())
            call(inp)
            torch.cuda.synchronize()
            if any(bool((a != b).any()) for a, b in zip(got, want)):
                raise RuntimeError(f"chip_ab: KR {name} at {s.q} queries x "
                                   f"{s.steps} steps differs from its plain "
                                   "version")
            ms = probe_mod.graph_ms([lambda x=x: call(x) for x in sets],
                                    GRAPH_REPS)
            issued = (s.q * s.steps * 2 + hits if name == P.LAZY
                      else s.q * s.steps * 3 + hits1)
            r[name] = {"ms": ms, "sectors_issued": issued,
                       "issued_per_s": issued / (ms * 1e-3),
                       "needed_per_s": needed / (ms * 1e-3)}
        out[s.name] = r
        del sets, inp
    out["loads"] = kr_loads(kernels)
    torch.cuda.empty_cache()
    return out


def kr_loads(kernels) -> dict:
    """The global loads (LDG) of each kernel in KR's library, as
    cuobjdump -sass lists them: how many, and how many of them
    predicated (issued only where a condition holds, as the eager route's
    lo at the first slot is)."""
    cuobjdump = Path(kernels.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(kernels.KR.library)],
                          capture_output=True, text=True, check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            out[fn] = {"ldg": 0, "predicated": 0}
        elif fn and "LDG" in line:
            out[fn]["ldg"] += 1
            out[fn]["predicated"] += "@" in line.split("LDG")[0]
    return out


def _kr_hits(torch, P, inp, steps: int):
    """(steps whose first slot matched, steps that matched a slot) of a
    KR call: the eager route's second-round lo loads, the lazy
    route's."""
    lo, hi = inp["lo"], inp["hi"]
    N = lo.shape[0]
    ix = inp["idx"].long() & (N - 1)
    n1 = n = 0
    for _ in range(steps):
        s2 = (ix * P.GOLD) & (N - 1)
        m1 = (hi[ix].long() ^ ix) < P.HIT
        hit = m1 | ((hi[s2].long() ^ ix) < P.HIT)
        n1 += int(m1.sum())
        n += int(hit.sum())
        v = torch.where(hit, lo[torch.where(m1, ix, s2)].long(), -1)
        ix = (ix + v) & (N - 1)
    return n1, n


def path_walls(smoke, Opts, fq: Path, tmp: Path, tree: Path) -> dict:
    """The trim path through run_device and the main path over two gloo
    ranks sharing the card through the launcher: walls, launches of KH
    and KM, and the outputs' sha256.  The launcher runs from the tree, so
    that its ranks import the tree's package even where its launcher
    predates running them with `python -P`."""
    topt = Opts()
    topt.k = smoke.TRIM_K
    topt.filter_mode = True
    out_fq = tmp / "trimmed.fq"
    rep, launches, _ = smoke.drive(topt, fq, out_fq)
    rec = {"trim": {"count_s": rep["count_s"], "trim_s": rep["trim_s"],
                    "kh_launches": launches["max_streak"],
                    "sha256": smoke.file_hash(out_fq)}}
    out_fq.unlink()
    mesh_fq = tmp / "corrected_mesh.fq"
    cwd = os.getcwd()
    os.chdir(tree)
    try:
        mrep = smoke.drive_mesh(fq, mesh_fq, 2, "gloo", tmp)
    finally:
        os.chdir(cwd)
    rec["mesh_gloo_2"] = {
        "count_s": mrep["count_s"], "correct_s": mrep["correct_s"],
        "km_launches": [ls["route_rows"] for ls in mrep["launches_by_rank"]],
        "sha256": smoke.file_hash(mesh_fq)}
    mesh_fq.unlink()
    return rec


def alloc_walls(torch, smoke, C, opt, fq: Path, dev, tree: Path) -> dict:
    """The host passes that glibc's allocator setting (bfc_tpu_torch/
    __init__.py, where the tree has it) is for: the counting pass with the
    host finalize (pull, sketch, adjudicate, table), then the same under
    chip_smoke.py's SPILL_CAP with its spill's host merges (phase 18 (a)),
    each with its wall, the spill's seconds (LsmTree.timings) and the
    process's peak resident set after it (chip_smoke.peak_rss_gib)."""
    init = (tree / "bfc_tpu_torch" / "__init__.py").read_text()
    rec = {"allocator_set": "mallopt" in init}
    for tag, cap in (("host_finalize", None), ("spill_cap_host",
                                               smoke.SPILL_CAP)):
        with smoke.merge_cap_env(cap) as made:
            torch.cuda.synchronize()
            t0 = time.time()
            ds = C.count_file_device(str(fq), opt, dev, smoke.COUNT_B,
                                     device_finalize=False)
            torch.cuda.synchronize()
            wall = time.time() - t0
        b = made[0]
        rec[tag] = {"count_s": wall, "n_entries": ds.n_entries,
                    "spills": b.spills, "spilled_rows": b.spilled_rows,
                    "host_merge_rows": b.host_merge_rows,
                    "timings": dict(b.tree.timings),
                    "peak_rss_gib": smoke.peak_rss_gib()}
        del ds, made, b
        torch.cuda.empty_cache()
    return rec


def trim_host_ms(torch, smoke, bases, dev, reps: int = 20) -> float:
    """The host side of one trim batch as Trimmer.trim_file makes it,
    without KH: the bases padded into the 8,192 x 128 batch and the
    lengths in numpy, both uploaded, and an 8,192-row int64 output brought
    back; the mean wall ms of reps batches, each ending in a sync."""
    import numpy as np

    n, rlen = smoke.TRIM_B, bases.shape[1]
    out = torch.zeros((n,), dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        b = np.full((n, smoke.TRIM_L), 4, np.uint8)
        b[:, :rlen] = bases[i * n:(i + 1) * n]
        lens = np.zeros((n,), np.int32)
        lens[:] = rlen
        torch.from_numpy(b).to(dev), torch.from_numpy(lens).to(dev)
        out.cpu().numpy()
    return (time.perf_counter() - t0) * 1e3 / reps


def build_variants(kernels) -> dict:
    """{(variant, library): its launcher}; nvcc runs in parallel."""
    import ctypes

    csrc = HERE / "bfc_tpu_torch" / "csrc"
    out = HERE / "build" / "verdict_variants"
    procs = {}
    for name, subs in VARIANTS.items():
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        text = (d / "verdict.cuh").read_text()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not found")
            text = text.replace(old, new)
        (d / "verdict.cuh").write_text(text)
        for lib in ("bloom_adjudicate", "first_occurrence"):
            # -fno-gnu-unique: each library keeps its own launcher statics
            cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xcompiler",
                   "-fno-gnu-unique", "-I", str(d), "-o",
                   str(d / f"lib{lib}.so"), str(d / f"{lib}.cu")]
            procs[name, lib] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    fns = {}
    for (name, lib), p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name}/{lib}:\n{log}")
        kern = kernels.KF if lib == "bloom_adjudicate" else kernels.KI
        (entry, argtypes), = kern.signatures.items()
        fn = getattr(ctypes.CDLL(str(out / name / f"lib{lib}.so")), entry)
        fn.argtypes = argtypes
        fns[name, lib] = fn
    return fns


def verdict_variants(torch, kernels, spec, seed: int) -> int:
    """--verdict-variants: every variant's launcher on the synthetic
    folds, one JSON line a run."""
    fns = build_variants(kernels)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    st = torch.cuda.current_stream().cuda_stream
    card = _load_smoke().card_line()
    for tag, C, b, order in VARIANT_FOLDS:
        ret = torch.randint(-(1 << 62), 1 << 62, (C,), device=dev,
                            generator=gen, dtype=torch.int64)
        if order == "sorted":
            ret = ret[torch.argsort(ret & ((1 << (b - spec.BLK_SHIFT)) - 1))]
        arr = torch.randperm(C, device=dev, generator=gen)
        a32 = arr.to(torch.int32)
        n32 = torch.randint(0, 3, (C,), device=dev, generator=gen,
                            dtype=torch.int32)
        runs = [(name, lib, None) for name, lib in fns
                if lib == "bloom_adjudicate" or name == "base"]
        runs += [(f"base_S{k}", "bloom_adjudicate", k)
                 for k in VARIANT_SHIFTS[b]]
        first = None
        for name, lib, sb in runs:
            kernel = "KF" if lib == "bloom_adjudicate" else "KI"
            fn = fns[name.split("_S")[0], lib]
            sb = spec.verdict_shift(C, b) if sb is None else sb
            # verdict_scratch's layout at any shift
            ns = 1 << (b - spec.BLK_SHIFT - sb)
            rb, tiles = spec.RECORD_BYTES[kernel], -(-ns // spec.SCAN_TILE)
            buf = torch.empty(((rb + 5) * C + 4 * (ns + tiles),),
                              dtype=torch.uint8, device=dev)
            base = buf.data_ptr()
            cnt = base + (rb + 4) * C
            addrs = (base, base + rb * C, cnt + 4 * (ns + tiles), cnt,
                     cnt + 4 * ns)
            fp = torch.empty((C,), dtype=torch.bool, device=dev)
            keep = torch.empty((C,), dtype=torch.bool, device=dev)
            if kernel == "KF":
                call = lambda: fn(C, ret.data_ptr(), a32.data_ptr(),
                                  n32.data_ptr(), b, sb, 4, *addrs,
                                  fp.data_ptr(), keep.data_ptr(), st)
            else:
                call = lambda: fn(C, ret.data_ptr(), arr.data_ptr(), b, sb, 4,
                                  *addrs, fp.data_ptr(), st)
            if call() != 0:
                raise SystemExit(f"{name}/{lib} failed to launch")
            torch.cuda.synchronize()
            if first is None:
                first = fp.clone()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(3):
                call()
            ev[1].record()
            torch.cuda.synchronize()
            print(json.dumps({
                "card": card, "fold": tag, "rows": C, "bf_shift": b,
                "order": order, "variant": name, "kernel": kernel,
                "superblock_shift": sb,
                "ms": ev[0].elapsed_time(ev[1]) / 3,
                "fp_equal": bool(torch.equal(fp, first)),
                "breakdown_ms": _breakdown(torch, call, 3)}), flush=True)
            del buf
        del ret, arr, a32, n32, first
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(HERE),
                    help="directory holding the bfc_tpu_torch to measure")
    ap.add_argument("--genome", type=int, default=5_000_000)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--correct-batch", type=int, default=None,
                    help="reads a batch of the correction pass [the tree's "
                    "default]")
    ap.add_argument("--verdict-variants", action="store_true",
                    help="time the KF/KI verdict's design variants instead")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="sections to measure, of " + ",".join(PARTS)
                    + " [all]")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    if not parts <= set(PARTS):
        ap.error(f"--parts: unknown {sorted(parts - set(PARTS))}")
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.verdict_variants:
        from bfc_tpu_torch import kernels
        from bfc_tpu_torch.ops import spectrum as spec
        return verdict_variants(torch, kernels, spec, args.seed)
    from bfc_tpu_torch import cli, kernels
    from bfc_tpu_torch.io import fast_reader as FR
    from bfc_tpu_torch.io.writer import OutputWriter
    from bfc_tpu_torch.models import counter as C
    from bfc_tpu_torch.models import device_pipeline as DP
    from bfc_tpu_torch.models import trimmer as TT
    from bfc_tpu_torch.ops import annotate as ann
    from bfc_tpu_torch.ops import kmer as kops
    from bfc_tpu_torch.ops import route
    from bfc_tpu_torch.ops import search as srch
    from bfc_tpu_torch.ops import spectrum as spec
    from bfc_tpu_torch.ops import spectrum_dense as sdn
    from bfc_tpu_torch.opts import Opts

    smoke = _load_smoke()
    dev = torch.device("cuda")
    rec = {"tree": str(tree), "card": smoke.card_line(),
           "build_s": kernels.build_all()}
    tmp = Path(tempfile.mkdtemp(prefix="bfc_chip_ab_"))
    try:
        fq = tmp / "reads.fq"
        if parts - set(PROBE_PARTS):   # the probe parts read no reads
            bases, quals = smoke.make_reads(args.genome, args.seed)
            smoke.write_fastq(fq, bases, quals)
        opt = Opts()
        opt.apply_genome_size(cli.parse_size("5m"))
        k, l_pre = opt.k, opt.effective_l_pre()
        topt = Opts()
        topt.k = smoke.TRIM_K
        topt.filter_mode = True
        if "alloc" in parts:
            rec["alloc"] = alloc_walls(torch, smoke, C, opt, fq, dev, tree)
        if "main" in parts:
            main_part(rec, args, torch, smoke, kernels, FR, OutputWriter, C,
                      DP, ann, kops, srch, sdn, opt, fq, tmp, dev, bases,
                      quals)
        if parts & {"verdicts", "kh"}:
            # the trim count's peak, its fold and Bloom filter
            info = {}
            bloom, rec["trim_count_peak_bytes"] = _peak(
                torch, lambda: TT.count_file_filter_device(
                    str(fq), topt, dev, smoke.COUNT_B, info=info,
                    device_finalize=True))
            rec["trim_verdict"] = info["verdict"]
            trim_fold = sdn.run_to_aggregate(info.pop("aggregate"), topt.k,
                                             topt.effective_l_pre())
            del info
            if "kh" in parts:
                rec["kh"] = streak_cases(torch, smoke, TT, bloom, topt, bases,
                                         quals, dev)
            del bloom
            torch.cuda.empty_cache()
        if parts & {"verdicts", "km", "kl", "kn", "kk"}:
            agg = C.AggBuilder(opt, dev)
            for cbases, cqok, clens, _ in C.padded_batches(str(fq), opt,
                                                           smoke.COUNT_B):
                agg.add(cbases, cqok, clens)
            main_fold = sdn.run_to_aggregate(agg.fold(), k, l_pre)
            del agg
            torch.cuda.empty_cache()
            if "km" in parts:
                rec["km"] = route_cases(torch, smoke, kernels, route, sdn,
                                        opt, bases, quals, dev, main_fold)
            if parts & {"kl", "kn"}:
                rec.update(cuckoo_cases(torch, smoke, kernels, spec, C, kops,
                                        opt, main_fold, parts, args.seed))
            if "kk" in parts:
                rec.update(kk_cases(torch, smoke, kernels, spec, main_fold,
                                    opt))
        for part, tag in PROBE_PARTS.items():
            if part in parts:
                rec[part] = probe_cases(torch, sys.modules["chip_probe"],
                                        kernels, dev, args.seed, tag)
        if "paths" in parts:
            rec["paths"] = path_walls(smoke, Opts, fq, tmp, tree)
        if "verdicts" in parts:
            rec["verdicts"] = {
                f"b{o.bf_shift}": verdicts(torch, smoke, kernels, spec, sdn,
                                           run, o.bf_shift, o.n_hashes)
                for o, run in ((opt, main_fold), (topt, trim_fold))}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(rec), flush=True)
    return 0


def main_part(rec, args, torch, smoke, kernels, FR, OutputWriter, C, DP, ann,
              kops, srch, sdn, opt, fq, tmp, dev, bases, quals) -> None:
    """The count, KA-KD and the correction pass, into rec."""
    t0 = time.time()
    ds, rec["count_peak_bytes"] = _peak(torch, lambda: C.count_file_device(
        str(fq), opt, dev, batch_reads=smoke.COUNT_B,
        device_finalize=True))
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
    del ds, t
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
