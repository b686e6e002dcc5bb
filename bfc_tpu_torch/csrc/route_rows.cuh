// KM per-row and per-block bodies: the destination rules of the mesh
// exchanges and a stable partition of rows by destination rank.
//
// A row goes to one of R ranks by one of two rules:
//   KM_RULE_PREFIX  the owner of its table shard, bit for bit
//                   bfc_tpu/parallel/mesh.py:_dev_of_shard (:87-90): the top
//                   int(log2(R)) bits of the l_pre-bit prefix, as int32,
//                   floor-mod R;
//   KM_RULE_BLOOM   the owner of its Bloom block, block % R with the block
//                   the low bf_shift - 9 bits of ret, as bloom.cuh computes
//                   it (all n_hashes bits of a row lie in that block).
// Under either rule a row whose shard is BFC_INVALID_SHARD is dropped.
//
// The partition is stable: the rows sent to one rank keep their input
// order.  Rows are cut into tiles of KM_TILE; pass (i) counts each tile's
// rows by destination into cnt[d * n_tiles + tile]; an exclusive scan of
// that array (destination-major, then tile order) gives each (destination,
// tile) its first output slot; pass (ii) places each row at its slot plus
// the number of earlier rows of its tile with the same destination.  On
// the card a warp finds that rank with __match_any_sync and __popc;
// km_count_tile and km_scatter_tile below are the same passes one row
// after another, which csrc/host_shim.cpp runs tile by tile.
#pragma once
#include "bloom.cuh"

#define KM_RULE_PREFIX 0
#define KM_RULE_BLOOM 1
#define KM_MAX_RANKS 256
#define KM_COLS 4
#define KM_TILE 4096

// int(np.log2(R)) for R >= 1.
BFC_HD int km_log2_floor(int R) {
    int b = 0;
    while ((2 << b) <= R) b++;
    return b;
}

BFC_HD int km_dev_of_shard(int64_t shard, int l_pre, int R) {
    int shift = l_pre - km_log2_floor(R);
    if (shift < 0) shift = 0;
    int32_t v = shift < 32 ? (int32_t)((uint32_t)shard >> shift) : 0;
    int32_t m = v % R;
    return m < 0 ? m + R : m;
}

BFC_HD int km_dev_of_block(uint64_t ret, int bf_shift, int R) {
    return (int)((ret & bfc_mask(bf_shift - BFC_BLK_SHIFT)) % (uint64_t)R);
}

// Destination rank of row i, or R where the row is dropped.  shard may be
// null under the Bloom rule (no row is dropped then).
BFC_HD int km_dest(int rule, const int64_t* shard, const int64_t* ret,
                   int64_t i, int param, int R) {
    if (shard && shard[i] == BFC_INVALID_SHARD) return R;
    if (rule == KM_RULE_PREFIX) return km_dev_of_shard(shard[i], param, R);
    return km_dev_of_block((uint64_t)ret[i], param, R);
}

struct KmCols {
    const int64_t* in[KM_COLS];  // null where a column is absent
    int64_t* out[KM_COLS];
};

// Row i to output slot pos: every present column, and its source index.
BFC_HD void km_place(int64_t i, int64_t pos, const KmCols& c, int64_t* perm) {
    for (int j = 0; j < KM_COLS; j++)
        if (c.in[j]) c.out[j][pos] = c.in[j][i];
    perm[pos] = i;
}

// Pass (i) for tile t, one row after another.
BFC_HD void km_count_tile(int64_t t, int64_t N, int rule,
                          const int64_t* shard, const int64_t* ret,
                          int param, int R, int64_t n_tiles, int64_t* cnt) {
    int64_t lo = t * KM_TILE, hi = lo + KM_TILE < N ? lo + KM_TILE : N;
    for (int d = 0; d < R; d++) cnt[d * n_tiles + t] = 0;
    for (int64_t i = lo; i < hi; i++) {
        int d = km_dest(rule, shard, ret, i, param, R);
        if (d < R) cnt[d * n_tiles + t]++;
    }
}

// Pass (ii) for tile t, one row after another; next holds R scratch slots.
BFC_HD void km_scatter_tile(int64_t t, int64_t N, int rule,
                            const int64_t* shard, const int64_t* ret,
                            int param, int R, int64_t n_tiles,
                            const int64_t* off, const KmCols& c,
                            int64_t* perm, int64_t* next) {
    int64_t lo = t * KM_TILE, hi = lo + KM_TILE < N ? lo + KM_TILE : N;
    for (int d = 0; d < R; d++) next[d] = off[d * n_tiles + t];
    for (int64_t i = lo; i < hi; i++) {
        int d = km_dest(rule, shard, ret, i, param, R);
        if (d < R) km_place(i, next[d]++, c, perm);
    }
}
