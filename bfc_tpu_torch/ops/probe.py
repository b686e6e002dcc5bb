"""The probe kernels KO-KR: the access patterns of the repo's TPU probes.

The only pl.pallas_call sites of the repo are TPU probe scripts
(scripts/tpu_probe_r2.py, tpu_probe2.py, tpu_probe4.py,
tpu_session_gather.py) that timed the access patterns the correction
search lives on.  These are their counterparts on the card, each the
function its Pallas kernels compute (csrc/probe.cuh):

  flat_gather     KO  v = tab[ix], ix = (ix + v) & (N - 1)
  tile_gather     KP  over a [rows, 128] table: ROW (out = tab[ix, :],
                      the chain on the row's first word), COLUMN
                      (v = tab[ix[q, l], l]) or LANE (v = tab[r, ix[r, l]]
                      within row r, the chain masked to 128)
  onehot_passes   KQ  x[b, (pos[b] + i) % 128] += 1 for i < 30, out of
                      place, a warp a row, the passes applied in
                      REGISTERS or in SHARED memory
  two_plane       KR  the cuckoo probe: lo of the first of slots ix and
                      ix * -1640531527 & (N - 1) whose hi ^ ix < 2^16,
                      else -1; ix = (ix + v) & (N - 1); on the EAGER
                      route (lo with the hi loads) or the LAZY one (hi at
                      both slots, then lo only where one matched)

Every gather is a dependent chain of `steps` steps, one kernel launch for
the whole chain, and returns (the last value read, the final index); at
one step that is the plain gather.  Tables are i32 tensors of a power-of-
two size; a u32 table rides as its i32 bit pattern (np.uint32 viewed as
np.int32), since the chain adds and masks bit patterns alike.  Start
indices are taken modulo the table.  The plain versions compute in int64
on the CPU, where torch has no uint32 arithmetic; KR's wrapping i32
multiply is an int64 product masked to its low bits.  On the CPU each
wrapper calls its plain version; on the card it launches its kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels

W = 128                 # csrc/probe.cuh:PROBE_W, lanes of a row
GOLD = 0x9E3779B9       # PROBE_GOLD: -1640531527 as u32
HIT = 1 << 16           # PROBE_HIT
PASSES = 30             # PROBE_PASSES: the probes' one-hot passes a step
ROW, COLUMN, LANE = "row", "column", "lane"
REGISTERS, SHARED = "registers", "shared"
GLOBAL = "global"       # KP's walk in device memory (SHARED: staged)
EAGER, LAZY = "eager", "lazy"   # KR's routes (two_plane_route)
KR_LAZY_QUERIES = 32768     # KR's lazy route from this many queries
KP_COLS = 4             # csrc/probe.cuh: lanes a column-mode thread walks
KP_STAGE_BYTES = 128 * 1024   # shared memory a KP block stages

Pair = Tuple[torch.Tensor, torch.Tensor]


def _pow2(n: int, what: str) -> None:
    if n < 1 or n & (n - 1) or n > 1 << 31:
        raise ValueError(f"{what} {n}: a power of two up to 2^31")


def _steps(steps: int) -> None:
    if steps < 1:
        raise ValueError(f"steps {steps}: at least 1")


def _i32(t) -> torch.Tensor:
    return t.to(torch.int32)


# ---------------------------------------------------------------------------
# KO: the flat gather
# ---------------------------------------------------------------------------

def flat_gather_plain(tab, idx, steps: int = 1) -> Pair:
    """Plain version of KO."""
    mask = tab.shape[0] - 1
    ix = idx.to(torch.int64) & mask
    for _ in range(steps):
        v = tab[ix]
        ix = (ix + v) & mask
    return v, _i32(ix)


def flat_gather(tab, idx, steps: int = 1) -> Pair:
    """The dependent flat gather (kernel KO).  tab int32 [N], N a power of
    two; idx int32 [Q].  Returns (v, ix), int32 [Q]: the last tab[ix] and
    the final index of each query's chain."""
    N, Q = tab.shape[0], idx.shape[0]
    dev = tab.device
    _pow2(N, "table size")
    _steps(steps)
    kernels.check(tab, "tab", torch.int32, (N,), dev)
    kernels.check(idx, "idx", torch.int32, (Q,), dev)
    if dev.type == "cpu":
        return flat_gather_plain(tab, idx, steps)
    v = torch.empty((Q,), dtype=torch.int32, device=dev)
    ix = torch.empty((Q,), dtype=torch.int32, device=dev)
    kernels.KO.launch("ko_launch", Q, tab.data_ptr(), N, idx.data_ptr(),
                      steps, v.data_ptr(), ix.data_ptr())
    return v, ix


# ---------------------------------------------------------------------------
# KP: row, column and lane gathers
# ---------------------------------------------------------------------------

def tile_gather_plain(tab, idx, steps: int = 1, mode: str = ROW) -> Pair:
    """Plain version of KP."""
    R = tab.shape[0]
    if mode == ROW:
        ix = idx.to(torch.int64) & (R - 1)
        for _ in range(steps):
            out = tab[ix]
            ix = (ix + out[:, 0]) & (R - 1)
        return out, _i32(ix)
    if mode == COLUMN:
        lanes = torch.arange(W, device=tab.device)
        ix = idx.to(torch.int64) & (R - 1)
        for _ in range(steps):
            v = tab[ix, lanes]
            ix = (ix + v) & (R - 1)
        return v, _i32(ix)
    ix = idx.to(torch.int64) & (W - 1)
    for _ in range(steps):
        v = torch.gather(tab, 1, ix)
        ix = (ix + v) & (W - 1)
    return v, _i32(ix)


def tile_route(rows: int, mode: str, steps: int, queries: int) -> str:
    """Where KP's chains walk over a table of `rows` rows: SHARED, staged
    in a block's shared memory (csrc/probe_tile_gather.cu), or GLOBAL, in
    the table.  COLUMN stages KP_COLS columns (rows * 16 bytes: up to
    8,192 rows) when a lane's chains take more steps in all than its
    column has entries (queries * steps > rows): a stage costs about what
    that many gathers from L2 do.  ROW walks the table (a stage of the
    first words did not repay itself at its sites' 1 and 16 steps); LANE
    always stages its rows."""
    if mode == COLUMN:
        return (SHARED if rows * KP_COLS * 4 <= KP_STAGE_BYTES
                and queries * steps > rows else GLOBAL)
    return GLOBAL if mode == ROW else SHARED


def tile_gather(tab, idx, steps: int = 1, mode: str = ROW) -> Pair:
    """Gathers over a [rows, 128] int32 table (kernel KP), a dependent
    chain of `steps` steps:
      ROW     idx int32 [Q] row numbers: out int32 [Q, 128], the last
              row read, and ix int32 [Q] after ix = (ix + row[0]) &
              (rows - 1); rows a power of two; tab on a 16-byte boundary
              on the card (its rows are copied 16 bytes a load);
      COLUMN  idx int32 [Q, 128]: v[q, l] = tab[ix[q, l], l], then
              ix = (ix + v) & (rows - 1); rows a power of two;
      LANE    idx int32 [rows, 128]: v[r, l] = tab[r, ix[r, l]], then
              ix = (ix + v) & 127; any number of rows.
    Returns (out or v, ix).  On the card one launch a call, on the route
    that tile_route gives (COLUMN's shared route reads tab and idx 16
    bytes a load, so inputs off that boundary take the global one)."""
    R = tab.shape[0]
    dev = tab.device
    _steps(steps)
    kernels.check(tab, "tab", torch.int32, (R, W), dev)
    if mode == ROW:
        shape = (idx.shape[0],)
    elif mode == COLUMN:
        shape = (idx.shape[0], W)
    elif mode == LANE:
        shape = (R, W)
    else:
        raise ValueError(f"mode {mode!r}: {ROW}, {COLUMN} or {LANE}")
    if mode != LANE:
        _pow2(R, "rows")
    kernels.check(idx, "idx", torch.int32, shape, dev)
    if dev.type == "cpu":
        return tile_gather_plain(tab, idx, steps, mode)
    return _tile_gather_card(tab, idx, steps, mode)


def _tile_gather_card(tab, idx, steps: int, mode: str) -> Pair:
    """tile_gather's launch, its inputs checked."""
    R, Q, dev = tab.shape[0], idx.shape[0], tab.device
    if mode == ROW:
        if tab.data_ptr() % 16:
            raise ValueError("tab: not on a 16-byte boundary (row mode "
                             "copies rows 16 bytes a load)")
        out = torch.empty((Q, W), dtype=torch.int32, device=dev)
        ix = torch.empty((Q,), dtype=torch.int32, device=dev)
        kernels.KP.launch("kp_row_launch", Q, tab.data_ptr(), R,
                          idx.data_ptr(), steps, out.data_ptr(),
                          ix.data_ptr())
        return out, ix
    v = torch.empty(idx.shape, dtype=torch.int32, device=dev)
    ix = torch.empty(idx.shape, dtype=torch.int32, device=dev)
    if mode == COLUMN:
        staged = (tile_route(R, mode, steps, Q) == SHARED
                  and tab.data_ptr() % 16 == 0 and idx.data_ptr() % 16 == 0)
        kernels.KP.launch("kp_column_launch", Q, tab.data_ptr(), R,
                          idx.data_ptr(), steps, int(staged), v.data_ptr(),
                          ix.data_ptr())
    else:
        kernels.KP.launch("kp_lane_launch", R, tab.data_ptr(),
                          idx.data_ptr(), steps, v.data_ptr(), ix.data_ptr())
    return v, ix


# ---------------------------------------------------------------------------
# KQ: the one-hot read-modify-write passes
# ---------------------------------------------------------------------------

def onehot_passes_plain(x, pos, steps: int = 1):
    """Plain version of KQ (either variant): each pass reads the selected
    element of every row and writes it back plus one."""
    x = x.clone()
    pos = pos.to(torch.int64)
    for _ in range(steps):
        for i in range(PASSES):
            c = ((pos + i) & (W - 1))[:, None]
            x.scatter_(1, c, torch.gather(x, 1, c) + 1)
    return x


def onehot_passes(x, pos, steps: int = 1, variant: str = REGISTERS):
    """30 one-hot passes a step, `steps` steps (kernel KQ): x[b, (pos[b]
    + i) % 128] += 1 for i < 30.  x int32 [B, 128], pos int32 [B];
    variant REGISTERS or SHARED (where a row's warp applies the passes on
    the card).  Returns the updated rows as a new tensor; x is not
    written.  On the card one launch, which reads x and writes the
    result once."""
    B = x.shape[0]
    dev = x.device
    _steps(steps)
    if variant not in (REGISTERS, SHARED):
        raise ValueError(f"variant {variant!r}: {REGISTERS} or {SHARED}")
    kernels.check(x, "x", torch.int32, (B, W), dev)
    kernels.check(pos, "pos", torch.int32, (B,), dev)
    if dev.type == "cpu":
        return onehot_passes_plain(x, pos, steps)
    return _onehot_passes_card(x, pos, steps, variant)


def _onehot_passes_card(x, pos, steps: int, variant: str):
    """onehot_passes' launch, its inputs checked (an x off a 16-byte
    boundary is read 4 bytes a load)."""
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    kernels.KQ.launch(f"kq_{variant}_launch", x.shape[0], x.data_ptr(),
                      pos.data_ptr(), steps, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# KR: the two-probe, two-plane lookup
# ---------------------------------------------------------------------------

def two_plane_plain(lo, hi, idx, steps: int = 4) -> Pair:
    """Plain version of KR."""
    mask = lo.shape[0] - 1
    ix = idx.to(torch.int64) & mask
    for _ in range(steps):
        s2 = (ix * GOLD) & mask
        h1, h2 = hi[ix].to(torch.int64), hi[s2].to(torch.int64)
        v = torch.where((h1 ^ ix) < HIT, lo[ix],
                        torch.where((h2 ^ ix) < HIT, lo[s2], -1))
        ix = (ix + v) & mask
    return v, _i32(ix)


def two_plane_route(queries: int, steps: int) -> str:
    """KR's route for `queries` chains of `steps` steps: LAZY from
    KR_LAZY_QUERIES queries, else EAGER; a thread a query on both.  The
    eager route (kr_query) loads hi at both slots and lo at the second in one
    round, and lo at the first in a second round where that slot matched
    (as nvcc builds it: cuobjdump -sass); the lazy route loads hi at both
    slots, then lo only at the slot that matched: on a miss at both, two
    sectors a step where the eager route reads three.  Measured with both
    routes forced (chip_ab.py --parts kr; NVIDIA H100 80GB HBM3, 700.00
    W): at 8,192 queries the eager route's one round wins (4 steps
    0.0063 ms against 0.0077, 64 steps 0.0595 against 0.0867); at 32,768
    queries over 256 MiB they tie (0.0147), and over sG's planes in L2,
    where nearly every step misses, the lazy route takes 0.0028 ms against
    0.0037; from 131,072 queries up to 4,194,304 both read three sectors
    a step on cuckoo planes and run at the card's ~34 G random sectors/s,
    the lazy route within 1% ahead.  The steps did not move the crossover
    (8,192 queries lose at 4 and at 64)."""
    return LAZY if queries >= KR_LAZY_QUERIES else EAGER


def two_plane(lo, hi, idx, steps: int = 4) -> Pair:
    """The cuckoo table's two-probe, two-plane lookup as a dependent chain
    (kernel KR).  lo, hi int32 [N], N a power of two; idx int32 [Q].
    Returns (v, ix), int32 [Q].  On the card one launch a call, on the
    route that two_plane_route gives."""
    N, Q = lo.shape[0], idx.shape[0]
    dev = lo.device
    _pow2(N, "table size")
    _steps(steps)
    kernels.check(lo, "lo", torch.int32, (N,), dev)
    kernels.check(hi, "hi", torch.int32, (N,), dev)
    kernels.check(idx, "idx", torch.int32, (Q,), dev)
    if dev.type == "cpu":
        return two_plane_plain(lo, hi, idx, steps)
    return _two_plane_card(lo, hi, idx, steps, two_plane_route(Q, steps))


def _two_plane_card(lo, hi, idx, steps: int, route: str) -> Pair:
    """two_plane's launch on `route`, its inputs checked."""
    N, Q, dev = lo.shape[0], idx.shape[0], lo.device
    v = torch.empty((Q,), dtype=torch.int32, device=dev)
    ix = torch.empty((Q,), dtype=torch.int32, device=dev)
    kernels.KR.launch("kr_launch", Q, lo.data_ptr(), hi.data_ptr(), N,
                      idx.data_ptr(), steps, int(route == LAZY), v.data_ptr(),
                      ix.data_ptr())
    return v, ix
