"""The probe path on one CUDA card: the access patterns of the repo's TPU
probe scripts, as the hand-written kernels KO-KR.

    python3 chip_probe.py

The only pl.pallas_call sites of the repo are TPU probe scripts
(scripts/tpu_probe_r2.py, tpu_probe2.py, tpu_probe4.py,
tpu_session_gather.py) that timed the access patterns of the correction
search.  This script runs every one of those sites, at its own shapes and
data recipe, through its counterpart in bfc_tpu_torch/ops/probe.py: KO
(dependent flat gathers), KP (row, column and lane gathers), KQ (the 30
one-hot read-modify-write passes, with the row in registers and in shared
memory) and KR (the cuckoo table's two-probe, two-plane lookup).  It adds
one table size beyond the card's 50 MB L2: KO over a 256 MiB i32 table
and KR over two 128 MiB planes, the bytes of the main path's cuckoo table
(`-s 5m`, 2^25 slots of 8 bytes), at 8,192 queries (KD's correction
batch, one read a thread), 32,768 (the probes') and 4,194,304 (enough to
fill the card), 4 steps each, and 64 steps at 8,192 queries, where the
launch is a small part and the time a step is the latency of a dependent
load.  KR's planes are filled so that every step's second slot matches,
as a full cuckoo table's keys do, so each step walks to a random slot.

For each site the kernel runs once (the probe path: one launch a site),
then its output is held against its plain version on the same card
tensors (exact equality: every value is an integer; KP's and KR's rows
name the route their wrapper took), then the kernel,
the plain version and the matching PyTorch library call are timed on the
device: a CUDA graph of repeated calls (REPS, a tenth of that for the
plain version), captured after a warm-up and replayed REPLAYS times
between two CUDA events; the median replay over the calls in it is the
time.  Where the table exceeds L2 the calls take fresh start indices
(start_sets), so none finds another's sectors cached.  The host's cost of a call (the Python wrapper's checks and
allocations, ~25-45 us, which hides a small kernel) is not in it.  One
JSON line a site gives the times, ns per gather and per dependent step,
the bound max(bytes / 3.35 TB/s, integer ops / 16.7 T/s) and what bounds
it, the library time, the check and the card's name and power limit.

The bytes are what the function needs from this run's data (touched()):
indices and outputs once, and the 32-byte sectors of the table its
chains read (KP row: the first word of each row passed, the whole last
row; KR: hi at ix, hi at the second slot only where the first missed, lo
only at the slot that matched).  A table beyond L2 is charged a sector
an access, since a sector read again has mostly left the 50 MB L2; a
table that fits is charged each distinct sector once.  A site whose table
(KQ: whose rows) fits L2 keeps it there across the timed calls, and
NVIDIA publishes no L2 rate to price it at, so its bound, at the HBM
rate, is not a floor for those times: "bound_comparable" is false.

The last line is {"ok": true, "device": {...}}.  Without a CUDA device the
script exits non-zero before printing any result; a failed check raises.
chip_smoke.py phase 15 calls run() below.
"""

from __future__ import annotations

import json
import subprocess
import sys
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from bfc_tpu_torch import kernels
from bfc_tpu_torch.ops import probe as P

# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# HBM3 at 3.35 TB/s.  The 32-bit integer pipe has 64 lanes per SM, one op
# each a clock: 64 x 132 SMs x 1.98 GHz boost = 16.7e12 ops/s (half the
# 67 TFLOP/s fp32 figure, which counts an FMA as two flops on 128 lanes).
# chip_smoke.py takes them, and bound(), from here.  The L2 holds 50 MB.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
L2_BYTES = 50 * 2**20
SECTOR = 32  # bytes of one random device-memory access
# 32-bit integer ops a dependent step (address, add, mask, loop), counted
# from csrc/probe.cuh; a KQ pass is an index, a mask and an add a row.
OPS_STEP = 4
OPS_STEP_KR = 12
OPS_PASS = 4
REPS = 50       # calls in a timed CUDA graph (the plain version: REPS // 10)
REPLAYS = 7     # timed replays of it; the time is their median
KERNEL = {"KO": "probe_flat_gather", "KP": "probe_tile_gather",
          "KQ": "probe_onehot_passes", "KR": "probe_two_plane"}
SOURCE = {k: f"bfc_tpu_torch/csrc/{v}.cu" for k, v in KERNEL.items()}


class Site(NamedTuple):
    name: str
    replaces: str     # the pl.pallas_call site (file:line)
    kernel: str       # KO, KP, KQ or KR
    mode: str         # KP's mode, KQ's variant, else ""
    n: int            # table entries (KP: rows x 128; KQ: rows)
    q: int            # queries (KP column: of 128 elements; lane: rows)
    steps: int
    recipe: str       # the data recipe (make_inputs)
    seed: int


R2, P2, P4, SG = ("scripts/tpu_probe_r2.py", "scripts/tpu_probe2.py",
                  "scripts/tpu_probe4.py", "scripts/tpu_session_gather.py")
M20, M22 = 1 << 20, 1 << 22
HBM_N = {"KO": 1 << 26, "KR": 1 << 25}   # 256 MiB: i32, or two i32 planes
SITES: List[Site] = [
    Site("r2_s4a", f"{R2}:172", "KQ", P.REGISTERS, 2048, 2048, 1, "zeros", 0),
    Site("r2_s4a", f"{R2}:172", "KQ", P.SHARED, 2048, 2048, 1, "zeros", 0),
    Site("r2_s4b", f"{R2}:204", "KO", "", M20, 8192, 1, "u32", 3),
    Site("r2_s4c", f"{R2}:231", "KO", "", M20, 8192, 1, "u32", 4),
    Site("r2_s4d", f"{R2}:269", "KO", "", M20, 8192, 1, "u32", 5),
    Site("r2_s4e", f"{R2}:323", "KO", "", M22, 8192, 1, "u32", 6),
    Site("p2_sD1", f"{P2}:196", "KP", P.ROW, M20, 8192, 1, "i31", 5),
    Site("p2_sD1_loop", f"{P2}:213", "KP", P.ROW, M20, 8192, 16, "i31", 5),
    Site("p2_sD2", f"{P2}:233", "KP", P.COLUMN, M20, 8192, 1, "i31", 5),
    Site("p2_sD2_loop", f"{P2}:245", "KP", P.COLUMN, M20, 8192, 16, "i31",
         5),
    Site("p2_sE", f"{P2}:296", "KQ", P.REGISTERS, 2048, 2048, 32, "zeros",
         0),
    Site("p2_sE", f"{P2}:296", "KQ", P.SHARED, 2048, 2048, 32, "zeros", 0),
    Site("p4_sD", f"{P4}:189", "KO", "", M20, 8192, 1, "i30", 0),
    Site("p4_sD_loop", f"{P4}:206", "KO", "", M20, 8192, 8, "i30", 0),
    Site("sg_sC", f"{SG}:124 (sC, :135)", "KP", P.LANE, 2048 * 128, 2048,
         16, "i30", 0),
    Site("sg_sD", f"{SG}:124 (sD, :159)", "KP", P.COLUMN, M20, 2048, 16,
         "i30", 0),
    Site("sg_sE", f"{SG}:124 (sE, :180)", "KO", "", M20, 1 << 15, 4, "i30",
         0),
    Site("sg_sF", f"{SG}:124 (sF, :221)", "KQ", P.REGISTERS, 2048, 2048, 16,
         "zeros", 0),
    Site("sg_sF", f"{SG}:124 (sF, :221)", "KQ", P.SHARED, 2048, 2048, 16,
         "zeros", 0),
    Site("sg_sG", f"{SG}:124 (sG, :257)", "KR", "", M20, 1 << 15, 4,
         "planes", 0),
] + [
    Site(f"hbm_{k}_q{q}" + ("" if K == 4 else f"_k{K}"),
         f"{SG}:124 ({s}) at 256 MiB", k, "", HBM_N[k], q, K, r, 0)
    for k, s, r in (("KO", "sE", "i30"), ("KR", "sG", "cuckoo"))
    for q, K in ((8192, 4), (8192, 64), (1 << 15, 4), (1 << 22, 4))
]
# the rows of chip_smoke.py's kernels line: one site a kernel, KO and KR
# at the probes' 32,768 queries x 4 steps over 256 MiB, where the bound is
# a floor
REPRESENTATIVE = {"KO": ("hbm_KO_q32768", ""), "KP": ("sg_sD", P.COLUMN),
                  "KQ": ("sg_sF", P.REGISTERS), "KR": ("hbm_KR_q32768", "")}


def label(s: Site) -> str:
    return s.name + (f"/{s.mode}" if s.mode else "")


def route(s: Site) -> str:
    """The way a KP site's wrapper walks (ops/probe.py:tile_route, by the
    table's rows, the steps and the queries) or a KR site's
    (two_plane_route, by the queries), "" for the other kernels and for a
    package without routes (chip_ab.py runs this file against older
    trees too)."""
    if s.kernel == "KR":
        kr_route = getattr(P, "two_plane_route", None)
        return kr_route(s.q, s.steps) if kr_route else ""
    tile_route = getattr(P, "tile_route", None)
    if s.kernel != "KP" or tile_route is None:
        return ""
    rows = s.q if s.mode == P.LANE else s.n // P.W
    return tile_route(rows, s.mode, s.steps, s.q)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def graph_ms(fns: Sequence[Callable], reps: int,
             replays: int = REPLAYS) -> float:
    """Device milliseconds a call: max(reps, len(fns)) calls, cycling
    through fns, captured in one CUDA graph after a warm-up call, the
    graph replayed once to warm it, then replayed `replays` times, each
    between two CUDA events; the median replay over the calls in it."""
    reps = max(reps, len(fns))
    fns[0]()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(reps):
            fns[i % len(fns)]()
    g.replay()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(replays + 1)]
    ev[0].record()
    for e in ev[1:]:
        g.replay()
        e.record()
    torch.cuda.synchronize()
    ms = float(np.median([a.elapsed_time(b) for a, b in zip(ev, ev[1:])]))
    del g
    torch.cuda.empty_cache()
    return ms / reps


# --------------------------------------------------------------------------
# Inputs: the scripts' recipes, made with numpy from the site's seed
# --------------------------------------------------------------------------

def _table(rng, recipe: str, n: int) -> np.ndarray:
    if recipe == "u32":   # tpu_probe_r2.py: u32, full range, as i32 bits
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
            np.uint32).view(np.int32)
    if recipe == "i31":   # tpu_probe2.py sD
        return rng.integers(0, 1 << 31, n).astype(np.int32)
    return rng.integers(0, 1 << 30, n).astype(np.int32)  # TAB of the others


def make_inputs(s: Site, dev) -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng(s.seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if s.kernel == "KQ":   # x0 = zeros, pos = arange % 128
        return {"x": torch.zeros((s.n, P.W), dtype=torch.int32, device=dev),
                "pos": t(np.arange(s.n, dtype=np.int32) % P.W)}
    if s.kernel == "KR":
        lo = _table(rng, "i30", s.n)
        if s.recipe == "planes":   # sG: hi from [0, 2^30)
            hi = rng.integers(0, 1 << 30, s.n).astype(np.int32)
        else:   # every key j sits in its second slot: hi[s2(j)] = j ^ r
            j = np.arange(s.n, dtype=np.uint64)
            s2 = (j * np.uint64(P.GOLD)) & np.uint64(s.n - 1)
            hi = np.empty(s.n, np.int32)
            hi[s2] = (j ^ rng.integers(0, P.HIT, s.n).astype(
                np.uint64)).astype(np.int32)
        return {"lo": t(lo), "hi": t(hi),
                "idx": t(rng.integers(0, s.n, s.q).astype(np.int32))}
    tab = _table(rng, s.recipe, s.n)
    if s.kernel == "KO":
        return {"tab": t(tab),
                "idx": t(rng.integers(0, s.n, s.q).astype(np.int32))}
    R = s.n // P.W
    shape = {P.ROW: (s.q,), P.COLUMN: (s.q, P.W)}.get(s.mode)
    if s.mode == P.LANE:   # sC: the first 2048 rows, lanes in [0, 128)
        R = s.q
        tab = tab[:R * P.W]
        idx = rng.integers(0, P.W, (R, P.W))
    else:
        idx = rng.integers(0, R, shape)
    return {"tab": t(tab.reshape(R, P.W)), "idx": t(idx.astype(np.int32))}


def table_bytes(inp) -> int:
    return sum(inp[k].numel() * 4 for k in ("tab", "lo", "hi") if k in inp)


def start_sets(s: Site, inp, dev) -> List[Dict[str, torch.Tensor]]:
    """The inputs of the timed calls.  A site whose table exceeds L2 takes
    fresh start indices a call, from enough sets that one graph replay
    reads 4x the L2 in sectors (one a step), so that no call finds
    another's sectors cached, as KD's batches find the cuckoo table; the
    first set is the checked one.  Every other site repeats its inputs:
    the probes' tables sat in on-chip memory."""
    if table_bytes(inp) <= L2_BYTES:
        return [inp]
    n = max(1, -(-4 * L2_BYTES // (SECTOR * s.q * s.steps)))
    rng = np.random.default_rng(s.seed + 1)
    return [inp] + [dict(inp, idx=torch.from_numpy(
        rng.integers(0, s.n, s.q).astype(np.int32)).to(dev))
        for _ in range(n - 1)]


# --------------------------------------------------------------------------
# The kernel, its plain version and the library call of each site
# --------------------------------------------------------------------------

def kernel_call(s: Site, inp) -> Tuple[torch.Tensor, ...]:
    if s.kernel == "KO":
        return P.flat_gather(inp["tab"], inp["idx"], s.steps)
    if s.kernel == "KP":
        return P.tile_gather(inp["tab"], inp["idx"], s.steps, s.mode)
    if s.kernel == "KQ":
        return (P.onehot_passes(inp["x"], inp["pos"], s.steps, s.mode),)
    return P.two_plane(inp["lo"], inp["hi"], inp["idx"], s.steps)


def plain_call(s: Site, inp) -> Tuple[torch.Tensor, ...]:
    if s.kernel == "KO":
        return P.flat_gather_plain(inp["tab"], inp["idx"], s.steps)
    if s.kernel == "KP":
        return P.tile_gather_plain(inp["tab"], inp["idx"], s.steps, s.mode)
    if s.kernel == "KQ":
        return (P.onehot_passes_plain(inp["x"], inp["pos"], s.steps),)
    return P.two_plane_plain(inp["lo"], inp["hi"], inp["idx"], s.steps)


def library_call(s: Site, inp) -> Tuple[Optional[Callable], str]:
    """One PyTorch call a step that computes the site's gather, chained as
    the kernel chains it; None for KR, whose compare and select no single
    call does."""
    if s.kernel == "KR":
        return None, ("none: no single PyTorch call does the two-slot "
                      "compare and select")
    if s.kernel == "KQ":
        pos = inp["pos"].long()
        cols = (pos[:, None] + torch.arange(P.PASSES, device=pos.device)
                ) & (P.W - 1)
        ones = torch.ones(cols.shape, dtype=torch.int32, device=cols.device)

        def passes():
            x = inp["x"].clone()
            for _ in range(s.steps):
                x.scatter_add_(1, cols, ones)
            return x
        return passes, "Tensor.scatter_add_ over the 30 columns a step"
    tab = inp["tab"]
    idx = inp["idx"].long()
    if s.kernel == "KO":
        mask = tab.shape[0] - 1

        def take():
            ix = idx & mask
            for _ in range(s.steps):
                v = torch.take(tab, ix)
                ix = (ix + v) & mask
            return v
        return take, "torch.take a step"
    R = tab.shape[0]
    if s.mode == P.ROW:
        def rows():
            ix = idx & (R - 1)
            for _ in range(s.steps):
                out = tab.index_select(0, ix)
                ix = (ix + out[:, 0]) & (R - 1)
            return out
        return rows, "Tensor.index_select(0, .) a step"
    axis, mask = (0, R - 1) if s.mode == P.COLUMN else (1, P.W - 1)

    def gather():
        ix = idx & mask
        for _ in range(s.steps):
            v = torch.gather(tab, axis, ix)
            ix = (ix + v) & mask
        return v
    return gather, f"torch.gather(., {axis}, .) a step"


def touched(s: Site, inp) -> torch.Tensor:
    """The table sectors (32 bytes, 8 entries) that the site's function
    reads, one id an access, for this run's data: each chain re-walked as
    the plain version walks it.  KR's lo plane follows its hi plane in the
    id space."""
    per = SECTOR // 4
    idx = inp["idx"].long() if "idx" in inp else None
    ids = []
    if s.kernel == "KO":
        tab = inp["tab"]
        mask = tab.shape[0] - 1
        ix = idx & mask
        for _ in range(s.steps):
            ids.append(ix // per)
            ix = (ix + tab[ix]) & mask
    elif s.kernel == "KR":
        lo, hi = inp["lo"], inp["hi"]
        N = lo.shape[0]
        ix = idx & (N - 1)
        for _ in range(s.steps):
            s2 = (ix * P.GOLD) & (N - 1)
            hit1 = (hi[ix].long() ^ ix) < P.HIT
            hit = hit1 | ((hi[s2].long() ^ ix) < P.HIT)
            slot = torch.where(hit1, ix, s2)
            ids += [ix // per, s2[~hit1] // per, (N + slot[hit]) // per]
            v = torch.where(hit, lo[slot].long(), -1)
            ix = (ix + v) & (N - 1)
    elif s.mode == P.ROW:   # the first word of each row passed, the last whole
        tab = inp["tab"]
        R, row = tab.shape[0], P.W // per
        ix = idx & (R - 1)
        for _ in range(s.steps - 1):
            ids.append(ix * row)
            ix = (ix + tab[ix, 0]) & (R - 1)
        ids.append((ix[:, None] * row + torch.arange(
            row, device=ix.device)).flatten())
    else:   # COLUMN: tab[ix, l]; LANE: tab[r, ix]
        tab = inp["tab"]
        R = tab.shape[0]
        col = s.mode == P.COLUMN
        mask = R - 1 if col else P.W - 1
        fixed = torch.arange(P.W if col else R, device=tab.device)
        fixed = fixed if col else fixed[:, None]
        ix = idx & mask
        for _ in range(s.steps):
            flat = ix * P.W + fixed if col else fixed * P.W + ix
            ids.append((flat // per).flatten())
            v = tab[ix, fixed] if col else torch.gather(tab, 1, ix)
            ix = (ix + v) & mask
    return torch.cat(ids)


def work(s: Site, sets) -> Tuple[int, float, float, float, str, bool]:
    """(gathers, sector accesses, bytes, integer ops, what the bytes
    count, whether the bound is a floor for the timed calls) of one call,
    from this run's inputs: the mean over the timed calls' start sets
    where the table exceeds L2."""
    inp = sets[0]
    if s.kernel == "KQ":
        rows = 4 * s.n * P.W
        return (0, 0, 2 * rows + 4 * s.n, s.n * s.steps * P.PASSES * OPS_PASS,
                "the rows read and written once, pos read once",
                rows > L2_BYTES)
    elems = s.q * (P.W if s.mode in (P.COLUMN, P.LANE) else 1)
    gathers = elems * s.steps
    out = 4 * P.W * s.q + 4 * s.q if s.mode == P.ROW else 8 * elems
    io = 4 * elems + out
    ops = gathers * (OPS_STEP_KR if s.kernel == "KR" else OPS_STEP)
    table = table_bytes(inp)
    if table > L2_BYTES:
        n = float(np.mean([touched(s, x).numel() for x in sets]))
        return (gathers, n, n * SECTOR + io, ops,
                f"{n} sectors, one an access (table {table} bytes > L2, "
                f"fresh start indices a call from {len(sets)} sets), "
                "indices, outputs", True)
    ids = touched(s, inp)
    n = int(torch.unique(ids).numel())
    return (gathers, ids.numel(), n * SECTOR + io, ops,
            f"{n} distinct sectors of the {table}-byte table (it fits L2), "
            "indices, outputs", False)


def bound(bytes_moved: float, int_ops: float) -> Tuple[float, str]:
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_o = int_ops / INT32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


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


def run(dev, reps: int = REPS, sites: List[Site] = SITES,
        timed: bool = True) -> Tuple[List[dict], Dict[str, int]]:
    """The probe path: every site's kernel launched once, with every
    launch count zeroed just before and read just after (the returned
    dict), which on the card must be one a site; then each site's
    output held against its plain version on the same tensors and, if
    timed, the kernel, plain and library times.  Raises on any mismatch.
    Returns one result dict a site, with KP's and KR's route."""
    inputs = [make_inputs(s, dev) for s in sites]
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    sync()
    kernels.reset_launches()
    outs = [kernel_call(s, inp) for s, inp in zip(sites, inputs)]
    sync()
    launches = {k.name: k.launches for k in kernels.KERNELS.values()}
    want = {v: sum(KERNEL[s.kernel] == v for s in sites)
            for v in KERNEL.values()}
    if dev.type == "cuda" and any(launches[k] != n
                                  for k, n in want.items()):
        raise RuntimeError(f"chip_probe: launches {launches}, expected "
                           f"{want}")
    rows = []
    for s, inp, got in zip(sites, inputs, outs):
        err, bad = compare(got, plain_call(s, inp))
        if bad:
            raise RuntimeError(f"chip_probe: {label(s)}: the kernel differs "
                               f"from its plain version in {bad} values")
        sets = start_sets(s, inp, dev)
        gathers, sectors, nbytes, ops, counted, floor = work(s, sets)
        b_ms, b_by = bound(nbytes, ops)
        lib, lib_name = library_call(s, inp)
        r = {"site": s.name, "replaces": s.replaces, "kernel": s.kernel,
             "name": KERNEL[s.kernel], "mode": s.mode, "route": route(s),
             "table_entries": s.n,
             "queries": s.q, "steps": s.steps, "gathers": gathers,
             "max_abs_err": err, "mismatches": bad, "bound_ms": b_ms,
             "bound_by": b_by, "bound_comparable": floor, "bytes": nbytes,
             "bytes_counted": counted, "sector_accesses": sectors,
             "int_ops": ops, "library": lib_name, "start_sets": len(sets)}
        if timed:
            r["ms"] = graph_ms([lambda x=x: kernel_call(s, x) for x in sets],
                               reps)
            r["plain_ms"] = graph_ms(
                [lambda x=x: plain_call(s, x) for x in sets],
                max(reps // 10, 2))
            r["library_ms"] = graph_ms(
                [library_call(s, x)[0] for x in sets], reps) if lib else None
            r["ns_per_step"] = r["ms"] * 1e6 / s.steps
            if gathers:
                r["ns_per_gather"] = r["ms"] * 1e6 / gathers
                r["sectors_per_s"] = sectors / (r["ms"] * 1e-3)
        rows.append(r)
    return rows, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    print(f"kernel build: {kernels.build_all():.1f} s", flush=True)
    rows, launches = run(dev)
    for r in rows:
        print(json.dumps(dict(r, card=card)), flush=True)
    print(json.dumps({"launches": {KERNEL[k]: launches[KERNEL[k]]
                                   for k in KERNEL}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
