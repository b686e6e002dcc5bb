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

// KP row mode, one step of the chain: the next row from the first word of
// row ix of a [rows, PROBE_W] table (mask = rows - 1).  The rows between
// the first and the last are read only for that word: the function needs
// no more of them.
BFC_HD uint32_t kp_row_step(const int32_t* tab, uint32_t mask, uint32_t ix) {
    return probe_next(ix, tab[(size_t)ix * PROBE_W], mask);
}

// KP row mode, one query: the row reached after steps - 1 steps is copied
// whole to out_row, and the final index follows from its first word.
BFC_HD void kp_row_query(const int32_t* tab, uint32_t mask, int32_t ix0,
                         int steps, int32_t* out_row, int32_t* ix_out) {
    uint32_t ix = (uint32_t)ix0 & mask;
    for (int s = 1; s < steps; s++) ix = kp_row_step(tab, mask, ix);
    const int32_t* row = tab + (size_t)ix * PROBE_W;
    for (int l = 0; l < PROBE_W; l++) out_row[l] = row[l];
    *ix_out = (int32_t)probe_next(ix, row[0], mask);
}

// KP column mode, one element of lane l: v = tab[ix, l], each lane
// walking its own column of a [rows, PROBE_W] table.
BFC_HD void kp_col_elem(const int32_t* tab, uint32_t mask, int l, int32_t ix0,
                        int steps, int32_t* v_out, int32_t* ix_out) {
    uint32_t ix = (uint32_t)ix0 & mask;
    int32_t v = 0;
    for (int s = 0; s < steps; s++) {
        v = tab[(size_t)ix * PROBE_W + l];
        ix = probe_next(ix, v, mask);
    }
    *v_out = v;
    *ix_out = (int32_t)ix;
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

// KQ, one row held whole (shared-memory variant): PROBE_PASSES read-
// modify-write passes, x[(pos + i) % PROBE_W] += 1 for i < PROBE_PASSES,
// `steps` times (tpu_probe_r2.py:158-163).
BFC_HD void kq_row(int32_t* row, int32_t pos, int steps) {
    for (int s = 0; s < steps; s++)
        for (int i = 0; i < PROBE_PASSES; i++) {
            int c = (int)((uint32_t)(pos + i) & (PROBE_W - 1));
            row[c] = row[c] + 1;
        }
}

// KQ, one lane's 4 columns of a row (register variant): lane j holds
// columns 4j..4j+3, and the pass that selects one of them is applied by
// that lane alone.  The lanes of a row never exchange values: a pass
// touches one column.
BFC_HD void kq_lane(int32_t r[4], int lane, int32_t pos, int steps) {
    for (int s = 0; s < steps; s++)
        for (int i = 0; i < PROBE_PASSES; i++) {
            int c = (int)((uint32_t)(pos + i) & (PROBE_W - 1));
            bool mine = (c >> 2) == lane;
            int j = c & 3;
            r[0] += mine && j == 0;
            r[1] += mine && j == 1;
            r[2] += mine && j == 2;
            r[3] += mine && j == 3;
        }
}

// KR, one query (tpu_session_gather.py:sG, :262-276): slot 1 is ix, slot
// 2 is s2 = ix * -1640531527 (wrapping) & mask; the value is lo of the
// first slot whose hi ^ ix, as signed i32, lies below 2^16, else -1; then
// ix = (ix + v) & mask, `steps` times.
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
