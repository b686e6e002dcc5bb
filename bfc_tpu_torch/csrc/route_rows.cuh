// KM per-row, per-warp and per-tile bodies: the destination rules of the
// mesh exchanges and a stable partition of rows by destination rank.
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
// order.  Rows are cut into tiles of KM_TILE, and a tile into KM_WARPS
// contiguous shares of KM_WARP_ROWS, which one warp walks 32 rows (a
// chunk) at a time.  The count pass counts each tile's rows by
// destination into off[d * n_tiles + tile] and adds them to the
// destination's total; the scan pass turns each destination's counts in
// place into the output slot of its first row in each tile (the rows of
// the destinations before it plus its rows in the tiles before).  A row's
// output slot is that plus its rank in the tile.  The scatter pass ranks
// each row among the earlier rows of its tile with the same destination:
// in its chunk by __match_any_sync and __popc, across its warp's earlier
// chunks by a running count a warp and destination, across the earlier
// warps by a scan of those counts; it stages the tile's rows grouped by
// destination in shared memory and writes each destination's segment to
// consecutive output slots.  csrc/host_shim.cpp runs the same steps lane
// by lane and thread by thread.
#pragma once
#include "bloom.cuh"

#define KM_RULE_PREFIX 0
#define KM_RULE_BLOOM 1
#define KM_MAX_RANKS 256
#define KM_COLS 4
#define KM_TILE 4096
#define KM_THREADS 512
#define KM_WARPS (KM_THREADS / 32)
#define KM_WARP_ROWS (KM_TILE / KM_WARPS)
#define KM_CHUNKS (KM_WARP_ROWS / 32)

// int(np.log2(R)) for R >= 1.
BFC_HD int km_log2_floor(int R) {
    int b = 0;
    while ((2 << b) <= R) b++;
    return b;
}

// (A power of two R takes a mask: a division is a long instruction
// sequence on the card, and these run once a row in both passes.)
BFC_HD int km_dev_of_shard(int64_t shard, int l_pre, int R) {
    int shift = l_pre - km_log2_floor(R);
    if (shift < 0) shift = 0;
    int32_t v = shift < 32 ? (int32_t)((uint32_t)shard >> shift) : 0;
    if ((R & (R - 1)) == 0) return v & (R - 1);  // the floor mod of v
    int32_t m = v % R;
    return m < 0 ? m + R : m;
}

BFC_HD int km_dev_of_block(uint64_t ret, int bf_shift, int R) {
    uint64_t b = ret & bfc_mask(bf_shift - BFC_BLK_SHIFT);
    if ((R & (R - 1)) == 0) return (int)(b & (uint64_t)(R - 1));
    return b >> 32 ? (int)(b % (uint64_t)R) : (int)((uint32_t)b % (uint32_t)R);
}

// Destination rank of row i, or R where the row is dropped.  shard may be
// null under the Bloom rule (no row is dropped then).
BFC_HD int km_dest(int rule, const int64_t* shard, const int64_t* ret,
                   int64_t i, int param, int R) {
    if (shard && shard[i] == BFC_INVALID_SHARD) return R;
    if (rule == KM_RULE_PREFIX) return km_dev_of_shard(shard[i], param, R);
    return km_dev_of_block((uint64_t)ret[i], param, R);
}

// Row of lane `lane` in chunk c of warp w's share of tile t, and its
// index in the tile.
BFC_HD int km_tile_row(int w, int c, int lane) {
    return w * KM_WARP_ROWS + c * 32 + lane;
}

BFC_HD int64_t km_row(int64_t t, int w, int c, int lane) {
    return t * KM_TILE + km_tile_row(w, c, lane);
}

// The destination of row i, or R past the last row.
BFC_HD int km_dest_at(int rule, const int64_t* shard, const int64_t* ret,
                      int64_t i, int64_t N, int param, int R) {
    return i < N ? km_dest(rule, shard, ret, i, param, R) : R;
}

// --- The scan pass, a block a destination --------------------------------

// Thread tid's contiguous part [*lo, *hi) of a destination's n counts.
BFC_HD void km_scan_part(int64_t n, int tid, int64_t* lo, int64_t* hi) {
    int64_t per = (n + KM_THREADS - 1) / KM_THREADS;
    int64_t a = (int64_t)tid * per;
    *lo = a < n ? a : n;
    *hi = a + per < n ? a + per : n;
}

BFC_HD int64_t km_part_sum(const int64_t* cnt, int64_t lo, int64_t hi) {
    int64_t s = 0;
#pragma unroll 8
    for (int64_t i = lo; i < hi; i++) s += cnt[i];
    return s;
}

// The part's counts become exclusive offsets from base, its part's first
// slot, eight at a time: loaded, then written.
BFC_HD void km_part_write(int64_t* cnt, int64_t lo, int64_t hi,
                          int64_t base) {
    for (int64_t a = lo; a < hi; a += 8) {
        int64_t v[8];
        for (int u = 0; u < 8; u++) v[u] = a + u < hi ? cnt[a + u] : 0;
        for (int u = 0; u < 8 && a + u < hi; u++) {
            cnt[a + u] = base;
            base += v[u];
        }
    }
}

// --- The scatter pass, one tile ------------------------------------------

// A row's destination and its rank among its warp's earlier rows of that
// destination, in one word (rank < KM_WARP_ROWS).
BFC_HD int km_pack(int d, int rank) { return d << 16 | rank; }
BFC_HD int km_pack_dest(int v) { return v >> 16; }
BFC_HD int km_pack_rank(int v) { return v & 0xFFFF; }

// Destination d's column of the per-warp counts (wc[w * KM_MAX_RANKS +
// d]) becomes each warp's first rank in d's segment of the tile; returns
// the tile's rows for d.
BFC_HD int km_warp_bases(int* wc, int d) {
    int s = 0;
    for (int w = 0; w < KM_WARPS; w++) {
        int v = wc[w * KM_MAX_RANKS + d];
        wc[w * KM_MAX_RANKS + d] = s;
        s += v;
    }
    return s;
}

struct KmCols {
    const int64_t* in[KM_COLS];  // null where a column is absent
    int64_t* out[KM_COLS];
};

// Staged slot s of tile t: the row grouped there (its index in the tile,
// row[s]) and its output slot base[dst[s]] + s, where base[d] is the
// slot of d's first row in the tile less the start of d's segment there.
BFC_HD int64_t km_slot_row(int64_t t, int s, const uint16_t* row) {
    return t * KM_TILE + row[s];
}

BFC_HD int64_t km_slot_pos(int s, const uint8_t* dst, const int64_t* base) {
    return base[dst[s]] + s;
}
