"""Per-read error correction: greedy seed, two-direction search, merge (KD).

Counterpart of bfc_tpu/ops/search.py:ec1dir_batch (:436) together with
the greedy repair (annotate.py:greedy_k_batch, :170) and the rest of
bfc_tpu/models/corrector.py:correct_core (:67-379).  One CUDA thread
carries one read through bfc_ec1 (refmodel.ec1, :818).

The plain version is a loop over reads that runs the scalar model's own
ec_first_kmer / ec_greedy_k / ec1dir on each read, probing the same
cuckoo table: a best-first search with a heap per read has no vectorized
torch form short of rebuilding bfc_tpu's lockstep machinery, and the
scalar model is the semantic spec the kernel translates.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..models import refmodel as M
from ..opts import Opts
from .spectrum import IntProbe, SpecTable

HEAP_CAP = 128    # the heap holds at most max_heap + 4 = 104 entries
STACK_CAP = 4096  # search steps of one direction; beyond: scalar fallback

# columns of the int32 [B, 8] result (csrc/ec1_search.cuh KD_*); PROBES
# counts a read's table probes, zero when it overflowed
EC_CODE, BRUTE, N_EC, N_EC_HIGH, N_ABSENT, MAX_HEAP, OVERFLOW, PROBES = range(8)
N_OUT = 8


def _iparams(opt: Opts, mode: int, heap_cap: int, stack_cap: int):
    return np.array([opt.min_cov, opt.win_multi_ec, opt.max_end_ext,
                     opt.w_ec, opt.w_ec_high, opt.w_absent,
                     opt.w_absent_high, opt.max_path_diff, opt.max_heap,
                     mode, heap_cap, stack_cap], dtype=np.int32)


def ec1_read_plain(opt: Opts, probe, mode: int, s: List[M.EcBase],
                   isl: Tuple[int, int, int], heap_cap: int,
                   stack_cap: int) -> Tuple[List[int], Optional[List[int]]]:
    """One read as KD corrects it, given KC's annotation in s and isl.

    Returns the KD_* output columns and the final bases (None when the
    read keeps its input)."""
    out = [0] * N_OUT
    n = len(s)
    k = opt.k
    probe.n_probes = 0
    if sum(1 for c in s if c.ob > 3) > n * 0.05:
        out[EC_CODE] = M.ECCODE_MANY_N
        return out, None
    if isl[2]:
        start, end = isl[0], isl[1]
    else:
        ecv = -1
        start = 0
        while True:
            end, x = M.ec_first_kmer(k, s, start)
            if end >= n:
                break
            ecv = M.ec_greedy_k(k, mode, x, probe)
            if ecv >= 0:
                break
            if end + (k >> 1) >= n:
                break
            start = end - (k >> 1)
        if ecv < 0:
            out[EC_CODE] = M.ECCODE_NO_SOLID
            out[PROBES] = probe.n_probes
            return out, None
        s[end - (ecv >> 2)].b = ecv & 3
        end += 1
        start = end - k
        out[BRUTE] = 1

    def direction(ec, st):
        stats = M.SearchStats()
        rv, mh = M.ec1dir(opt, probe, s, ec, st, n, stats)
        return rv, mh, stats.max_stack > stack_cap or stats.max_heap > heap_cap

    ec0 = [M.EcBase() for _ in range(n)]
    ec1 = [M.EcBase() for _ in range(n)]
    rv0, mh0, ovf = direction(ec0, start)
    if not ovf and rv0 >= 0:
        M.seq_revcomp(s)
        rv1, mh1, ovf = direction(ec1, n - end)
        M.seq_revcomp(s)
    else:
        rv1 = mh1 = 0
    if ovf:
        return [0] * OVERFLOW + [1, 0], None
    out[PROBES] = probe.n_probes
    for rv in (rv0, rv1):
        if rv < 0:
            out[EC_CODE] = {-2: M.ECCODE_UNCORR_N,
                            -3: M.ECCODE_MANY_FAIL}.get(rv, M.ECCODE_MISC)
            return out, None
    M.seq_revcomp(ec1)
    final = []
    for i in range(n):
        e0, e1 = ec0[i].b, ec1[i].b
        if e0 == e1:
            fb = s[i].b if e0 > 3 else e0
        elif e1 > 3:
            fb = e0
        elif e0 > 3:
            fb = e1
        else:
            fb = s[i].ob
        final.append(fb)
        if fb != s[i].ob:
            out[N_EC] += 1
            out[N_EC_HIGH] += s[i].q
    out[N_ABSENT] = rv0 + rv1
    out[MAX_HEAP] = max(mh0, mh1)
    return out, final


def ec1_search_plain(t: SpecTable, opt: Opts, mode: int, bases, q, lens,
                     lcov, hcov, isl, heap_cap: int = HEAP_CAP,
                     stack_cap: int = STACK_CAP):
    """Plain version of KD: the scalar model read by read."""
    probe = IntProbe(t)
    dev = bases.device
    b, qq, ln, lc, hc, il = (a.cpu().numpy() for a in
                             (bases, q, lens, lcov, hcov, isl))
    b = b.astype(np.int64)
    qq = qq.astype(np.int64)
    packed = (b | qq << 4 | b << 5).astype(np.uint8)
    out = np.zeros((b.shape[0], N_OUT), np.int32)
    for r in range(b.shape[0]):
        n = int(ln[r])
        s = [M.EcBase(b=int(b[r, i]), q=int(qq[r, i]), ob=int(b[r, i]),
                      oq=int(qq[r, i]), lcov=int(lc[r, i]),
                      hcov=int(hc[r, i])) for i in range(n)]
        cols, final = ec1_read_plain(opt, probe, mode, s,
                                     tuple(int(v) for v in il[r]),
                                     heap_cap, stack_cap)
        out[r] = cols
        if final is not None:
            fb = np.array(final, np.int64)
            diff = (fb != b[r, :n]).astype(np.int64)
            packed[r, :n] = fb | diff << 3 | qq[r, :n] << 4 | b[r, :n] << 5
    return torch.from_numpy(packed).to(dev), torch.from_numpy(out).to(dev)


def ec1_search(t: SpecTable, opt: Opts, mode: int, bases, q, lens, lcov,
               hcov, isl, heap_cap: int = HEAP_CAP,
               stack_cap: int = STACK_CAP):
    """Correct a padded read batch (kernel KD).

    bases u8 [B, L] codes, q bool [B, L] quality flags (False on N), lens
    i32 [B], lcov/hcov u8 [B, L] and isl i32 [B, 3] from KC.  Returns
    packed u8 [B, L] (final base | is_diff << 3 | q << 4 | input base <<
    5; a read that is not corrected keeps its input) and out i32 [B, 7]
    with the columns EC_CODE .. OVERFLOW.  Overflowed reads carry zeros
    and their input; the caller corrects them with the scalar model."""
    B, L = bases.shape
    dev = bases.device
    kernels.check(bases, "bases", torch.uint8, (B, L), dev)
    kernels.check(q, "q", torch.bool, (B, L), dev)
    kernels.check(lens, "lens", torch.int32, (B,), dev)
    kernels.check(lcov, "lcov", torch.uint8, (B, L), dev)
    kernels.check(hcov, "hcov", torch.uint8, (B, L), dev)
    kernels.check(isl, "isl", torch.int32, (B, 3), dev)
    kernels.check(t.table, "table", torch.int64, (1 << t.c_bits,), dev)
    if dev.type == "cpu":
        return ec1_search_plain(t, opt, mode, bases, q, lens, lcov, hcov,
                                isl, heap_cap, stack_cap)
    import ctypes

    sizes = [ctypes.c_int(), ctypes.c_int(), ctypes.c_int()]
    kernels.KD.call("kd_sizes", *(ctypes.byref(v) for v in sizes))
    heap_ent, stack_ent, n_out = (v.value for v in sizes)
    if n_out != N_OUT:
        raise RuntimeError(f"KD writes {n_out} columns, expected {N_OUT}")
    ec0 = torch.empty((B, L), dtype=torch.uint8, device=dev)
    ec1 = torch.empty_like(ec0)
    heap = torch.empty((B * heap_cap * heap_ent,), dtype=torch.uint8,
                       device=dev)
    stack = torch.empty((B * stack_cap * stack_ent,), dtype=torch.uint8,
                        device=dev)
    packed = torch.empty((B, L), dtype=torch.uint8, device=dev)
    out = torch.empty((B, N_OUT), dtype=torch.int32, device=dev)
    ip = _iparams(opt, mode, heap_cap, stack_cap)
    kernels.KD.launch(
        "kd_launch", t.table.data_ptr(), t.k, t.l_pre, t.kb_bits, t.c_bits,
        ip.ctypes.data, B, L,
        *(a.data_ptr() for a in (bases, q, lens, lcov, hcov, isl, ec0, ec1,
                                 heap, stack, packed, out)))
    return packed, out
