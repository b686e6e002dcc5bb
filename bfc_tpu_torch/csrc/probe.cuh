// Per-query, per-element and per-row bodies of the probe kernels KO-KR.
//
// They replace the repo's pl.pallas_call sites, the TPU probe scripts
// scripts/tpu_probe_r2.py (s4a-s4e), scripts/tpu_probe2.py (sD, sE),
// scripts/tpu_probe4.py (sD) and scripts/tpu_session_gather.py (sC-sG),
// which measured the access patterns of the correction search: dependent
// random 4-byte gathers, row, column and lane gathers, lockstep one-hot
// read-modify-write passes and the cuckoo table's two-probe, two-plane
// lookup.  Each body computes the function those kernels compute; the
// TPU's means of reaching a gather (scalar loops, one-hot lane selects,
// DMA slots, VMEM chunks) are not carried over.
//
// Every gather runs a dependent chain of `steps` steps: the value read at
// one step moves the index of the next, ix = (ix + v) & mask, so step s+1
// cannot start before step s returns.  A table's size is a power of two
// and a start index is taken modulo it.  The bodies write the last value
// read and the final index; at one step that is the plain gather.  All
// arithmetic is on u32 bit patterns, so u32 and i32 tables chain alike.
//
// The bodies are __host__ __device__ so that csrc/host_shim.cpp can run
// them on the CPU and the tests can hold them against the plain versions
// (bfc_tpu_torch/ops/probe.py).
#pragma once
#include "kmer.cuh"

#define PROBE_W 128                 // lanes of a row (the TPU probes' width)
#define PROBE_GOLD 0x9E3779B9u      // -1640531527 as u32 (tpu_session_gather.py:269)
#define PROBE_HIT (1 << 16)         // (hi ^ ix) below this is a match
#define PROBE_PASSES 30             // KQ's one-hot passes a step
#define KQ_ROWS 8                   // rows a KQ block, a warp a row

BFC_HD uint32_t probe_next(uint32_t ix, int32_t v, uint32_t mask) {
    return (ix + (uint32_t)v) & mask;
}

// KO, one query: v = tab[ix], ix = (ix + v) & mask, `steps` times.
BFC_HD void ko_query(const int32_t* tab, uint32_t mask, int32_t ix0,
                     int steps, int32_t* v_out, int32_t* ix_out) {
    uint32_t ix = (uint32_t)ix0 & mask;
    int32_t v = 0;
    for (int s = 0; s < steps; s++) {
        v = tab[ix];
        ix = probe_next(ix, v, mask);
    }
    *v_out = v;
    *ix_out = (int32_t)ix;
}

// KP over a [rows, PROBE_W] table (mask = rows - 1).  Column mode stages
// in a block's shared memory what its chains read (the "shared" route:
// KP_COLS columns of rows entries, at most KP_STAGE_BYTES) where the
// chains are long enough to repay the stage, and otherwise walks the
// table in device memory (the "global" route); ops/probe.py:tile_route
// decides.  Row mode walks the table; lane mode stages its rows.
#define KP_COLS 4                   // lanes a column-mode thread walks
#define KP_STAGE_BYTES (128 * 1024)

// Four i32 from a 16-byte boundary of a table or index array that the
// kernel does not write (one read-only vector load on the card, which the
// compiler may move ahead of the kernel's stores).
BFC_HD void probe_load4(const int32_t* p, int32_t v[4]) {
#ifdef __CUDA_ARCH__
    int4 x = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
#else
    for (int c = 0; c < 4; c++) v[c] = p[c];
#endif
}

BFC_HD void probe_store4(int32_t* p, const int32_t v[4]) {
#ifdef __CUDA_ARCH__
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
#else
    for (int c = 0; c < 4; c++) p[c] = v[c];
#endif
}

// KP column mode, the shared route's staging, half h of a pair of groups
// (lanes p0 .. p0 + 2 KP_COLS - 1: one 32-byte sector of a row, whose
// two halves two neighbouring threads read): the rows r, r + stride, ...
// (KP_STAGE_UNROLL of them, those below end), every row's 16-byte load
// before the first store, into group p0 / KP_COLS + h's columns, one after
// another: col[c * rows + r] = tab[r, p0 + h KP_COLS + c].  On the card the
// pair is the two blocks of a cluster, and col the shared memory of block
// h, this block's or its peer's.
#define KP_STAGE_UNROLL 4
BFC_HD void kp_col_stage(const int32_t* tab, int p0, int h, uint32_t rows,
                         uint32_t r, uint32_t stride, uint32_t end,
                         int32_t* col) {
    int32_t x[KP_STAGE_UNROLL][KP_COLS];
#pragma unroll
    for (int j = 0; j < KP_STAGE_UNROLL; j++)
        if (r + j * stride < end)
            probe_load4(tab + (size_t)(r + j * stride) * PROBE_W + p0 +
                            h * KP_COLS,
                        x[j]);
#pragma unroll
    for (int j = 0; j < KP_STAGE_UNROLL; j++)
        if (r + j * stride < end)
            for (int c = 0; c < KP_COLS; c++)
                col[c * rows + r + j * stride] = x[j][c];
}

// KP column mode, the global route, one element of lane l (its index at
// idx[e]): v = tab[ix, l], the chain walked in the table.
BFC_HD void kp_col_elem(const int32_t* tab, uint32_t mask, int l,
                        const int32_t* idx, size_t e, int steps, int32_t* v,
                        int32_t* ix) {
    uint32_t x = (uint32_t)idx[e] & mask;
    int32_t y = 0;
    for (int s = 0; s < steps; s++) {
        y = tab[(size_t)x * PROBE_W + l];
        x = probe_next(x, y, mask);
    }
    v[e] = y;
    ix[e] = (int32_t)x;
}

// KP column mode, the shared route's walk of one query's lanes c0 ..
// c0 + KP_COLS - 1 (ix0, from its idx row) in their staged columns
// (col[c * rows + r] = tab[r, c0 + c]): the KP_COLS chains walked
// together, each step's loads independent of each other.
BFC_HD void kp_col_chains(const int32_t* col, uint32_t rows, uint32_t mask,
                          const int32_t ix0[KP_COLS], int steps,
                          int32_t v[KP_COLS], int32_t ix[KP_COLS]) {
    uint32_t x[KP_COLS];
    for (int c = 0; c < KP_COLS; c++) {
        x[c] = (uint32_t)ix0[c] & mask;
        v[c] = 0;
    }
    for (int s = 0; s < steps; s++) {
#pragma unroll
        for (int c = 0; c < KP_COLS; c++) {
            v[c] = col[c * rows + x[c]];
            x[c] = probe_next(x[c], v[c], mask);
        }
    }
    for (int c = 0; c < KP_COLS; c++) ix[c] = (int32_t)x[c];
}

// KP row mode, one query's chain on the rows' first words: the row
// reached after steps - 1 steps.
BFC_HD uint32_t kp_row_chain(const int32_t* tab, uint32_t mask, int32_t ix0,
                             int steps) {
    uint32_t ix = (uint32_t)ix0 & mask;
    for (int s = 1; s < steps; s++)
        ix = probe_next(ix, tab[(size_t)ix * PROBE_W], mask);
    return ix;
}

// KP row mode, lane `lane`'s quarter of the copy of final row ix (words
// 4 lane .. 4 lane + 3, a 16-byte load and store); lane 0 also writes the
// final index, which follows from the row's first word.
BFC_HD void kp_row_copy(const int32_t* tab, uint32_t mask, uint32_t ix,
                        int lane, int32_t* out, int32_t* ix_out) {
    int32_t x[4];
    probe_load4(tab + (size_t)ix * PROBE_W + 4 * lane, x);
    probe_store4(out + 4 * lane, x);
    if (lane == 0) *ix_out = (int32_t)probe_next(ix, x[0], mask);
}

// KP lane mode, one element: v = row[ix] within one row (mask =
// PROBE_W - 1); on the card the row sits in shared memory.
BFC_HD void kp_lane_elem(const int32_t* row, int32_t ix0, int steps,
                         int32_t* v_out, int32_t* ix_out) {
    const uint32_t mask = PROBE_W - 1;
    uint32_t ix = (uint32_t)ix0 & mask;
    int32_t v = 0;
    for (int s = 0; s < steps; s++) {
        v = row[ix];
        ix = probe_next(ix, v, mask);
    }
    *v_out = v;
    *ix_out = (int32_t)ix;
}

// KQ, the register variant: lane `lane` of a row's warp holds columns
// 4 lane .. 4 lane + 3.  Pass i of a step adds one to column (pos + i) %
// PROBE_W (tpu_probe_r2.py:158-163), so column c takes a pass a step
// where (c - pos) % PROBE_W < PROBE_PASSES.  The PROBE_PASSES passes of a
// step select distinct columns (PROBE_PASSES < PROBE_W), so they commute:
// each is applied by the lane that holds its column, and across steps a
// column's passes are a chain of adds in one place.
BFC_HD void kq_lane(int32_t r[4], int lane, int32_t pos, int steps) {
    uint32_t sel[4];
    for (int c = 0; c < 4; c++)
        sel[c] = (((uint32_t)(4 * lane + c) - (uint32_t)pos) &
                  (PROBE_W - 1)) < PROBE_PASSES;
    for (int s = 0; s < steps; s++)   // adds wrap, as the plain version's
        for (int c = 0; c < 4; c++) r[c] = (int32_t)((uint32_t)r[c] + sel[c]);
}

// KQ, the shared variant: lane `lane` < PROBE_PASSES of the row's warp
// applies pass `lane` to the row staged in shared memory, a read-modify-
// write of word (pos + lane) % PROBE_W, `steps` times.  The lanes' words
// are distinct and consecutive (mod PROBE_W), so no two share a bank.
BFC_HD void kq_pass(int32_t* row, int lane, int32_t pos, int steps) {
    if (lane >= PROBE_PASSES) return;
    int c = (int)(((uint32_t)pos + (uint32_t)lane) & (PROBE_W - 1));
    for (int s = 0; s < steps; s++)
        row[c] = (int32_t)((uint32_t)row[c] + 1);
}

// KR, the eager route, one query (tpu_session_gather.py:sG, :262-276):
// slot 1 is ix, slot 2 is s2 = ix * -1640531527 (wrapping) & mask; the
// value is lo of the first slot whose hi ^ ix, as signed i32, lies below
// 2^16, else -1; then ix = (ix + v) & mask, `steps` times.  All four
// loads are written up front; nvcc issues lo at the first slot only where
// that slot matched (probe_two_plane.cu).
BFC_HD void kr_query(const int32_t* lo, const int32_t* hi, uint32_t mask,
                     int32_t ix0, int steps, int32_t* v_out,
                     int32_t* ix_out) {
    uint32_t ix = (uint32_t)ix0 & mask;
    int32_t v = 0;
    for (int s = 0; s < steps; s++) {
        uint32_t s2 = (ix * PROBE_GOLD) & mask;
        int32_t key = (int32_t)ix;
        int32_t l1 = lo[ix], h1 = hi[ix], l2 = lo[s2], h2 = hi[s2];
        v = (h1 ^ key) < PROBE_HIT ? l1 : (h2 ^ key) < PROBE_HIT ? l2 : -1;
        ix = probe_next(ix, v, mask);
    }
    *v_out = v;
    *ix_out = (int32_t)ix;
}

// KR, the lazy route, one query: a step loads hi at both slots, then lo
// only at the slot that matched (none on a miss): the sectors the
// function needs, three a step where a key sits in a slot and two on a
// miss, in two dependent rounds.  The values are kr_query's.
BFC_HD void kr_lazy_query(const int32_t* lo, const int32_t* hi,
                          uint32_t mask, int32_t ix0, int steps,
                          int32_t* v_out, int32_t* ix_out) {
    uint32_t ix = (uint32_t)ix0 & mask;
    int32_t v = 0;
    for (int s = 0; s < steps; s++) {
        uint32_t s2 = (ix * PROBE_GOLD) & mask;
        int32_t key = (int32_t)ix;
        int32_t h1 = hi[ix], h2 = hi[s2];
        bool m1 = (h1 ^ key) < PROBE_HIT;
        v = m1 || (h2 ^ key) < PROBE_HIT ? lo[m1 ? ix : s2] : -1;
        ix = probe_next(ix, v, mask);
    }
    *v_out = v;
    *ix_out = (int32_t)ix;
}
