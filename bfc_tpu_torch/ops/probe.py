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
  onehot_passes   KQ  x[b, (pos[b] + i) % 128] += 1 for i < 30, in
                      REGISTERS (a warp a row) or SHARED memory (a thread
                      a row)
  two_plane       KR  the cuckoo probe: lo of the first of slots ix and
                      ix * -1640531527 & (N - 1) whose hi ^ ix < 2^16,
                      else -1; ix = (ix + v) & (N - 1)

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
    variant REGISTERS or SHARED (where the row lives on the card).
    Returns the updated rows (a new tensor)."""
    B = x.shape[0]
    dev = x.device
    _steps(steps)
    if variant not in (REGISTERS, SHARED):
        raise ValueError(f"variant {variant!r}: {REGISTERS} or {SHARED}")
    kernels.check(x, "x", torch.int32, (B, W), dev)
    kernels.check(pos, "pos", torch.int32, (B,), dev)
    if dev.type == "cpu":
        return onehot_passes_plain(x, pos, steps)
    out = x.clone()
    kernels.KQ.launch(f"kq_{variant}_launch", B, out.data_ptr(),
                      pos.data_ptr(), steps)
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


def two_plane(lo, hi, idx, steps: int = 4) -> Pair:
    """The cuckoo table's two-probe, two-plane lookup as a dependent chain
    (kernel KR).  lo, hi int32 [N], N a power of two; idx int32 [Q].
    Returns (v, ix), int32 [Q]."""
    N, Q = lo.shape[0], idx.shape[0]
    dev = lo.device
    _pow2(N, "table size")
    _steps(steps)
    kernels.check(lo, "lo", torch.int32, (N,), dev)
    kernels.check(hi, "hi", torch.int32, (N,), dev)
    kernels.check(idx, "idx", torch.int32, (Q,), dev)
    if dev.type == "cpu":
        return two_plane_plain(lo, hi, idx, steps)
    v = torch.empty((Q,), dtype=torch.int32, device=dev)
    ix = torch.empty((Q,), dtype=torch.int32, device=dev)
    kernels.KR.launch("kr_launch", Q, lo.data_ptr(), hi.data_ptr(), N,
                      idx.data_ptr(), steps, v.data_ptr(), ix.data_ptr())
    return v, ix
