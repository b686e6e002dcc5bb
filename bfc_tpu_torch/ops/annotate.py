"""Per-read coverage annotation and the best solid island (kernel KC).

Counterpart of bfc_tpu/ops/annotate.py:kcov_batch (:67) and
best_island_batch (:101): for each read, the payload of every k-mer
(occ), the 6-bit solid and solid-and-high coverage of each base (lcov,
hcov) and the longest run of solid k-mer ends (bfc_ec_kcov and
bfc_ec_best_island, correct.c:96-130).
"""

from __future__ import annotations

import torch

from .. import kernels
from .kmer import append_base
from .spectrum import SpecTable, kmer_occ_plain


def kcov_island_plain(t: SpecTable, bases, lens, min_cov: int):
    """Plain version of KC: all reads at once, one position a step."""
    B, L = bases.shape
    k = t.k
    dev = bases.device
    z = torch.zeros((B,), dtype=torch.int64, device=dev)
    x = (z, z, z, z)
    run = z
    lens64 = lens.to(torch.int64)
    occ = torch.empty((B, L), dtype=torch.int64, device=dev)
    for i in range(L):
        c = torch.where(lens64 > i, bases[:, i].to(torch.int64), 4)
        ok = c < 4
        x = tuple(torch.where(ok, a, 0)
                  for a in append_base(x, c.clamp(max=3), k))
        run = torch.where(ok, run + 1, 0)
        occ[:, i] = torch.where(run >= k, kmer_occ_plain(t, *x), -1)
    solid = (occ >= 0) & ((occ & 0xFF) >= min_cov)
    high = solid & (((occ >> 8) & 0x3F) >= min_cov + 1)

    def window(f):
        cs = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                        torch.cumsum(f.to(torch.int64), 1)], 1)
        hi = torch.clamp(torch.arange(L, device=dev) + k, max=L)
        return ((cs[:, hi] - cs[:, :L]) & 63).to(torch.uint8)

    maxv = torch.zeros((B,), dtype=torch.int64, device=dev)
    max_i = torch.full((B,), -1, dtype=torch.int64, device=dev)
    run = torch.zeros_like(maxv)
    for i in range(k - 1, L):
        inr = lens64 > i
        brk = inr & ~solid[:, i]
        upd = brk & (run > maxv)
        maxv = torch.where(upd, run, maxv)
        max_i = torch.where(upd, i, max_i)
        run = torch.where(brk, 0, torch.where(inr, run + 1, run))
    upd = run > maxv
    maxv = torch.where(upd, run, maxv)
    max_i = torch.where(upd, lens64, max_i)
    found = maxv > 0
    isl = torch.stack([torch.where(found, max_i - maxv - k + 1, 0),
                       torch.where(found, max_i, 0), found.to(torch.int64)], 1)
    return (occ.to(torch.int32), window(solid), window(high),
            isl.to(torch.int32))


def kcov_island(t: SpecTable, bases, lens, min_cov: int):
    """Coverage annotation of a padded read batch (kernel KC).

    bases u8 [B, L], lens i32 [B].  Returns occ i32 [B, L] (-1 where no
    k-mer ends or it is absent), lcov and hcov u8 [B, L], and the island
    i32 [B, 3] = (start, end, found)."""
    B, L = bases.shape
    dev = bases.device
    kernels.check(bases, "bases", torch.uint8, (B, L), dev)
    kernels.check(lens, "lens", torch.int32, (B,), dev)
    kernels.check(t.table, "table", torch.int64, (1 << t.c_bits,), dev)
    if dev.type == "cpu":
        return kcov_island_plain(t, bases, lens, min_cov)
    occ = torch.empty((B, L), dtype=torch.int32, device=dev)
    lcov = torch.empty((B, L), dtype=torch.uint8, device=dev)
    hcov = torch.empty_like(lcov)
    isl = torch.empty((B, 3), dtype=torch.int32, device=dev)
    kernels.KC.launch("kc_launch", t.table.data_ptr(), t.k, t.l_pre,
                      t.kb_bits, t.c_bits, min_cov, bases.data_ptr(),
                      lens.data_ptr(), B, L, occ.data_ptr(), lcov.data_ptr(),
                      hcov.data_ptr(), isl.data_ptr())
    return occ, lcov, hcov, isl
