// Per-row bodies of the device finalize: KJ (derive_ret) and KK (payloads
// and histograms).  KI's verdict is csrc/verdict.cuh.
//
// The bodies are __host__ __device__ so that csrc/host_shim.cpp can run
// them on the CPU and the tests can hold them against the plain versions.
#pragma once
#include "bloom.cuh"

// KJ, one row: the Bloom-addressing hash recomputed from the table identity
// (spectrum_dense.py:derive_ret_device, :293): shard_keybody inverted back
// to (h0, h1), then kmer_hash's ret formula.  Only for configurations where
// the identity keeps all of h0 and h1 (k <= 32, or (k - l_pre) + k < 50).
BFC_HD void kj_row(int64_t i, const int64_t* shard, const int64_t* keybody,
                   int k, int l_pre, int64_t* ret) {
    uint64_t mask = bfc_mask(k);
    uint64_t s = (uint64_t)shard[i], kb = (uint64_t)keybody[i];
    uint64_t h0, h1;
    if (k <= 32) {
        uint64_t z = (s << (2 * k - l_pre)) | kb;
        h0 = z >> k;
        h1 = z & mask;
    } else {
        h0 = (s << (k - l_pre)) | (kb >> k);
        h1 = kb & mask;
    }
    uint64_t w0 = (h0 - h1) & mask;
    ret[i] = (int64_t)(((w0 ^ h1) << k) | h0);
}

// KK (spectrum.py:finalize_counts_fp, :868): m = n - 1 + fp occurrences
// were inserted into the table (the first one only if it was a Bloom
// hit), high = n_high - (1 - fp) * first_high of them were high quality;
// the row is kept when m >= 1, with payload min(m, 255) | min(high, 63)
// << 8, else payload 0.
BFC_HD int32_t kk_payload(int64_t n, int64_t n_high, uint8_t first_high,
                          uint8_t fp) {
    int64_t f = fp ? 1 : 0;
    int64_t m = n - 1 + f;
    int64_t high = n_high - (1 - f) * (int64_t)first_high;
    if (m < 1) return 0;
    return (int32_t)(m < 255 ? m : 255) |
           (int32_t)(high < 63 ? high : 63) << 8;
}

// KK, one row: its payload and keep byte written; returns the payload.
BFC_HD int32_t kk_row(int64_t i, const int64_t* n, const int64_t* n_high,
                      const uint8_t* first_high, const uint8_t* fp,
                      int32_t* payload, uint8_t* keep) {
    int32_t p = kk_payload(n[i], n_high[i], first_high[i], fp[i]);
    payload[i] = p;
    keep[i] = (uint8_t)(p != 0);
    return p;
}

// KK's kernel takes many rows a thread.  A warp takes tiles of KK_TILE
// rows that start on a 16-byte boundary of every column: fp and
// first_high are read sixteen rows a load into the warp's staging
// arrays, n and n_high two rows a load, and payload leaves four rows a
// store and keep sixteen, through the staging arrays.  The rows before
// the first tile (the unaligned head) and after the last (the tail) go
// one a thread.  Each warp counts its kept rows into its own
// sub-histogram of KK_BINS bins (the count bins, then the high bins) in
// shared memory, which the block sums and adds to the global histograms
// once, at its end.
#define KK_THREADS 256
#define KK_WARPS (KK_THREADS / 32)
#define KK_TILE 512                  // rows of a warp's tile: 16 a lane
#define KK_BINS (256 + 64)

// The tiles: rows [head, head + tiles * KK_TILE).  head is the first row
// at which fp lies on a 16-byte boundary; where another column is not on
// one at that row, or no tile fits, there are no tiles and every row goes
// one a thread (head = C).
struct KkPlan {
    long long head, tiles;
};

BFC_HD KkPlan kk_plan(long long C, const void* n, const void* n_high,
                      const void* first_high, const void* fp,
                      const void* payload, const void* keep) {
    long long h = (long long)((16 - ((uintptr_t)fp & 15)) & 15);
    bool ok = ((uintptr_t)first_high + h) % 16 == 0 &&
              ((uintptr_t)keep + h) % 16 == 0 &&
              ((uintptr_t)n + 8 * h) % 16 == 0 &&
              ((uintptr_t)n_high + 8 * h) % 16 == 0 &&
              ((uintptr_t)payload + 4 * h) % 16 == 0;
    KkPlan p;
    p.tiles = ok && h < C ? (C - h) / KK_TILE : 0;
    p.head = p.tiles ? h : C;
    return p;
}

// Row j of the C - tiles * KK_TILE rows outside the tiles.
BFC_HD long long kk_rest_row(KkPlan p, long long j) {
    return j < p.head ? j : j + p.tiles * KK_TILE;
}

// 16 bytes from src to dst, both on 16-byte boundaries: one vector load
// and one vector store on the card.
BFC_HD void kk_copy16(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
#else
    const uint8_t* s = (const uint8_t*)src;
    uint8_t* d = (uint8_t*)dst;
    for (int b = 0; b < 16; b++) d[b] = s[b];
#endif
}

// A kept row's two bins counted in a sub-histogram (shared memory on the
// card, where the warp's lanes count at once).
BFC_HD void kk_tally(uint32_t* h, int32_t p) {
    if (!p) return;
#ifdef __CUDA_ARCH__
    atomicAdd(h + (p & 255), 1u);
    atomicAdd(h + 256 + (p >> 8), 1u);
#else
    h[p & 255]++;
    h[256 + (p >> 8)]++;
#endif
}

// A tile from row t, lane `lane`'s part, in three steps with the warp
// synchronised between them.  1: its sixteen rows of fp and first_high
// into the staging arrays sfp, sfh.
BFC_HD void kk_tile_stage(long long t, int lane, const uint8_t* first_high,
                          const uint8_t* fp, uint8_t* sfh, uint8_t* sfp) {
    kk_copy16(sfp + 16 * lane, fp + t + 16 * lane);
    kk_copy16(sfh + 16 * lane, first_high + t + 16 * lane);
}

// 2: the rule on the tile's rows 2j and 2j + 1, j = lane + 32 k (k < 8),
// n and n_high two rows a load (all sixteen loads issued before the
// rule); payloads into spl, keep bytes into skp, kept rows tallied in h.
BFC_HD void kk_tile_rows(long long t, int lane, const int64_t* n,
                         const int64_t* n_high, const uint8_t* sfh,
                         const uint8_t* sfp, int32_t* spl, uint8_t* skp,
                         uint32_t* h) {
    alignas(16) int64_t a[16];
    alignas(16) int64_t b[16];
#pragma unroll
    for (int k = 0; k < 8; k++) {
        long long r = t + 2 * (lane + 32 * k);
        kk_copy16(a + 2 * k, n + r);
        kk_copy16(b + 2 * k, n_high + r);
    }
#pragma unroll
    for (int k = 0; k < 8; k++) {
        int r = 2 * (lane + 32 * k);
        int32_t p0 = kk_payload(a[2 * k], b[2 * k], sfh[r], sfp[r]);
        int32_t p1 = kk_payload(a[2 * k + 1], b[2 * k + 1], sfh[r + 1],
                                sfp[r + 1]);
        spl[r] = p0;
        spl[r + 1] = p1;
        skp[r] = (uint8_t)(p0 != 0);
        skp[r + 1] = (uint8_t)(p1 != 0);
        kk_tally(h, p0);
        kk_tally(h, p1);
    }
}

// 3: payload out four rows a store, keep sixteen.
BFC_HD void kk_tile_store(long long t, int lane, const int32_t* spl,
                          const uint8_t* skp, int32_t* payload,
                          uint8_t* keep) {
#pragma unroll
    for (int k = 0; k < 4; k++) {
        int r = 4 * (lane + 32 * k);
        kk_copy16(payload + t + r, spl + r);
    }
    kk_copy16(keep + t + 16 * lane, skp + 16 * lane);
}

// The block's flush of bin b: the sum of its warps' sub-histograms (each
// KK_BINS bins, one after another) added to the global bin, once a block
// and only where it is not 0.  Integer sums are order-free: the
// histograms are exact.
BFC_HD void kk_flush_bin(const uint32_t* sub, int warps, int b,
                         uint64_t* hist, uint64_t* hist_high) {
    uint64_t s = 0;
    for (int w = 0; w < warps; w++) s += sub[w * KK_BINS + b];
    if (!s) return;
    uint64_t* d = b < 256 ? hist + b : hist_high + (b - 256);
#ifdef __CUDA_ARCH__
    atomicAdd((unsigned long long*)d, (unsigned long long)s);
#else
    *d += s;
#endif
}
