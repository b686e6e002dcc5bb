// KB bodies: group heads, the fold of one group, and the tile status words
// of the single-pass decoupled look-back.
#pragma once
#include "kmer.cuh"

// Row i of a run sorted by (shard, keybody) opens a group when it is valid
// and its key differs from row i-1's.
BFC_HD int32_t kb_head(const int64_t* shard, const int64_t* keybody,
                       int64_t i) {
    if (shard[i] == BFC_INVALID_SHARD) return 0;
    return i == 0 || shard[i] != shard[i - 1] ||
           keybody[i] != keybody[i - 1];
}

// The sorted run's columns and the compacted output's (ret and o_ret null
// when the run does not carry ret).
struct KbCols {
    const int64_t* shard;
    const int64_t* keybody;
    const int64_t* arr;
    const int64_t* n;
    const int64_t* nh;
    const uint8_t* fh;
    const int64_t* ret;
    int64_t* o_shard;
    int64_t* o_keybody;
    int64_t* o_arr;
    int64_t* o_n;
    int64_t* o_nh;
    uint8_t* o_fh;
    int64_t* o_ret;
};

// Folds the group that head row i opens into compacted slot s: the
// occurrence counts add, and the head (the earliest arrival, since the
// sort is stable over stream order) keeps its arrival, first_high and
// ret.  The group is the rows after i with i's key; it may run on into
// the next tile.  Rows with INVALID_SHARD sort last and never match.
BFC_HD void kb_fold(const KbCols& c, int64_t N, int64_t i, int64_t s) {
    int64_t sh = c.shard[i], kb = c.keybody[i];
    int64_t sn = c.n[i], snh = c.nh[i];
    for (int64_t j = i + 1; j < N && c.shard[j] == sh && c.keybody[j] == kb;
         j++) {
        sn += c.n[j];
        snh += c.nh[j];
    }
    c.o_shard[s] = sh;
    c.o_keybody[s] = kb;
    c.o_arr[s] = c.arr[i];
    c.o_n[s] = sn;
    c.o_nh[s] = snh;
    c.o_fh[s] = c.fh[i];
    if (c.ret) c.o_ret[s] = c.ret[i];
}

// A tile's status word: 0 until published, then its head count with
// KB_AGG, or the heads of tiles 0..t with KB_PREFIX.
#define KB_AGG (1ull << 62)
#define KB_PREFIX (2ull << 62)
#define KB_VALUE ((1ull << 62) - 1)

BFC_HD uint64_t kb_status_load(const uint64_t* p) {
#ifdef __CUDA_ARCH__
    return *(const volatile uint64_t*)p;
#else
    return *p;
#endif
}

BFC_HD void kb_status_store(uint64_t* p, uint64_t v) {
#ifdef __CUDA_ARCH__
    __threadfence();
    *(volatile uint64_t*)p = v;
#else
    *p = v;
#endif
}

// The heads before tile t: walks back over tiles t-1, t-2, ..., waiting
// for each to publish, and adds aggregates until a prefix.
BFC_HD int64_t kb_lookback(const uint64_t* status, int64_t t) {
    int64_t sum = 0;
    for (int64_t j = t - 1; j >= 0; j--) {
        uint64_t w;
        do {
            w = kb_status_load(status + j);
        } while (!(w & (KB_AGG | KB_PREFIX)));
        sum += (int64_t)(w & KB_VALUE);
        if (w & KB_PREFIX) break;
    }
    return sum;
}

// Tile t publishes its aggregate, looks back and publishes its prefix
// (tile 0 its prefix at once); returns the heads before it.  lazy (the
// tests' host runs) leaves tiles past 0 at their aggregate, so every
// look-back walks to tile 0.
BFC_HD int64_t kb_publish(uint64_t* status, int64_t t, int64_t agg,
                          int lazy) {
    if (t == 0) {
        kb_status_store(status, KB_PREFIX | (uint64_t)agg);
        return 0;
    }
    kb_status_store(status + t, KB_AGG | (uint64_t)agg);
    int64_t excl = kb_lookback(status, t);
    if (!lazy) kb_status_store(status + t, KB_PREFIX | (uint64_t)(excl + agg));
    return excl;
}

// Tile t of `tile` rows as a block runs it, with the rows' head flags
// counted in order: publish, look back, fold the heads.  The last tile
// writes the number of groups to *count.
BFC_HD void kb_tile_serial(const KbCols& c, int64_t N, int64_t t,
                           int64_t tile, uint64_t* status, int lazy,
                           int64_t* count) {
    int64_t a = t * tile, b = a + tile < N ? a + tile : N;
    int64_t agg = 0;
    for (int64_t i = a; i < b; i++) agg += kb_head(c.shard, c.keybody, i);
    int64_t s = kb_publish(status, t, agg, lazy);
    if (b == N) *count = s + agg;
    for (int64_t i = a; i < b; i++)
        if (kb_head(c.shard, c.keybody, i)) kb_fold(c, N, i, s++);
}
