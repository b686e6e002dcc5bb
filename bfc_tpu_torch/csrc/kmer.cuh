// k-mer codec, canonical hash and table identity, shared by every kernel.
//
// Per-thread scalar forms of bfc_tpu/ops/kmer.py (kmer_planes, wang_hash,
// canonical_hash, shard_and_keybody) and of the reference's kmer.h:10-95:
// KD rolls and edits one read's planes base by base, as the C reference
// does, so every plane and hash is a handful of u64 register ops.  KA and
// KC cut each slot's planes from a warp's ballot bit-planes instead
// (SlotWin below): a valid k-mer's planes depend on its k bases alone.
//
// The bodies are __host__ __device__ so that the CPU tests can compile
// them with g++ (-D__host__= -D__device__=) through csrc/host_shim.cpp
// and compare them with the plain PyTorch versions.
#pragma once
#include <stddef.h>
#include <stdint.h>

#define BFC_HD __host__ __device__ inline

#define BFC_INVALID_SHARD ((int64_t)0xFFFFFFFFll)

BFC_HD uint64_t bfc_mask(int bits) {
    return bits >= 64 ? ~0ull : ((1ull << bits) - 1);
}

// Roll base c (0..3) into the 4-plane state (kmer.h:10-17).
BFC_HD void kmer_append(uint64_t x[4], int c, int k) {
    uint64_t mask = bfc_mask(k);
    x[0] = ((x[0] << 1) | (uint64_t)(c & 1)) & mask;
    x[1] = ((x[1] << 1) | (uint64_t)(c >> 1)) & mask;
    x[2] = (x[2] >> 1) | ((uint64_t)(1 ^ (c & 1)) << (k - 1));
    x[3] = (x[3] >> 1) | ((uint64_t)(1 ^ (c >> 1)) << (k - 1));
}

// Substitute base c at d positions from the 3' end (kmer.h:19-27).
BFC_HD void kmer_change(uint64_t x[4], int d, int c, int k) {
    uint64_t t = ~(1ull << d);
    x[0] = ((uint64_t)(c & 1) << d) | (x[0] & t);
    x[1] = ((uint64_t)(c >> 1) << d) | (x[1] & t);
    int e = k - 1 - d;
    t = ~(1ull << e);
    x[2] = ((uint64_t)(1 ^ (c & 1)) << e) | (x[2] & t);
    x[3] = ((uint64_t)(1 ^ (c >> 1)) << e) | (x[3] & t);
}

BFC_HD void kmer_clear(uint64_t x[4]) {
    x[0] = x[1] = x[2] = x[3] = 0;
}

// Thomas Wang's invertible mix under a 2^k-1 mask (kmer.h:30-40).
BFC_HD uint64_t wang_hash(uint64_t key, uint64_t mask) {
    key = (~key + (key << 21)) & mask;
    key = key ^ (key >> 24);
    key = (key + (key << 3) + (key << 8)) & mask;
    key = key ^ (key >> 14);
    key = (key + (key << 2) + (key << 4)) & mask;
    key = key ^ (key >> 28);
    key = (key + (key << 31)) & mask;
    return key;
}

// Strand-canonical hash (kmer.h:79-88).  Returns the low 64 bits of the
// Bloom-addressing hash `ret`; h0/h1 key the count table.
BFC_HD uint64_t kmer_hash(const uint64_t x[4], int k, uint64_t* h0,
                          uint64_t* h1) {
    uint64_t mask = bfc_mask(k);
    int t = k >> 1;
    int u = ((x[1] >> t) & 1) > ((x[3] >> t) & 1);
    uint64_t a0 = u ? x[2] : x[0];
    uint64_t a1 = u ? x[3] : x[1];
    uint64_t w0 = wang_hash((a0 + a1) & mask, mask);
    uint64_t g1 = wang_hash(w0 ^ a1, mask);
    *h0 = (w0 + g1) & mask;
    *h1 = g1;
    return ((w0 ^ g1) << k) | *h0;
}

// (shard, in-shard identity) of a hash pair (htab.c:45-58).  l_pre is
// already clamped (Opts.effective_l_pre).
BFC_HD void shard_keybody(uint64_t h0, uint64_t h1, int k, int l_pre,
                          int64_t* shard, int64_t* keybody) {
    if (k <= 32) {
        int t = 2 * k - l_pre;
        uint64_t z = (h0 << k) | h1;
        *shard = (int64_t)(z >> t);
        *keybody = (int64_t)(z & bfc_mask(t));
    } else {
        int t = k - l_pre;
        int shift = (t + k < 50) ? k : 50 - t;
        *shard = (int64_t)(h0 >> t);
        *keybody = (int64_t)(((h0 & bfc_mask(t)) << shift) ^ h1);
    }
}

BFC_HD uint64_t bfc_brev64(uint64_t v) {
#ifdef __CUDA_ARCH__
    return __brevll(v);
#else
    uint64_t r = 0;
    for (int i = 0; i < 64; i++) r |= ((v >> i) & 1) << (63 - i);
    return r;
#endif
}

BFC_HD int bfc_popc64(uint64_t v) {
#ifdef __CUDA_ARCH__
    return __popcll(v);
#else
    return __builtin_popcountll(v);
#endif
}

BFC_HD int bfc_clz32(uint32_t v) {  // 32 for v == 0
#ifdef __CUDA_ARCH__
    return __clz(v);
#else
    return v ? __builtin_clz(v) : 32;
#endif
}

BFC_HD int bfc_ctz64(uint64_t v) {  // v != 0
#ifdef __CUDA_ARCH__
    return __ffsll((long long)v) - 1;
#else
    return __builtin_ctzll(v);
#endif
}

// A warp's window over one read, a 32-slot chunk at a time: for each of
// four per-slot bits, the ballot word of the chunk being cut (cur: bit j
// is slot 32c + j, lane j's) and the words of the two chunks before it
// (prev: bit p is slot 32(c-2) + p; zero before the row).  Word 0 is the
// base's low bit, 1 its high bit, 2 "ACGT inside the read", 3 (KA) that
// and the quality test.  96 bits cover a k-mer of up to 63 bases ending
// at any lane.
struct SlotWin {
    uint64_t prev[4];
    uint32_t cur[4];
};

BFC_HD void win_clear(SlotWin& w) {
    for (int i = 0; i < 4; i++) w.prev[i] = w.cur[i] = 0;
}

// Move to the next chunk: the current words become the newest of prev.
BFC_HD void win_next(SlotWin& w) {
    for (int i = 0; i < 4; i++)
        w.prev[i] = (w.prev[i] >> 32) | ((uint64_t)w.cur[i] << 32);
}

// The four bits a lane votes for its slot (bit i is word i's vote), from
// the slot's base code c (4: N, or no base inside the read) and quality
// flag q.
BFC_HD unsigned slot_votes(unsigned c, unsigned q) {
    return c < 4 ? c | 4 | (q ? 8 : 0) : 0;
}

// Slot s's base code and quality flag (qok may be null: KC) in a row of
// L slots holding a read of len bases; 4 and 0 outside the read.
BFC_HD void slot_load(const uint8_t* bases, const uint8_t* qok, int len,
                      int L, int s, unsigned* c, unsigned* q) {
    int in = s >= 0 && s < L && s < len;
    *c = in ? bases[s] : 4;
    *q = in && qok ? qok[s] : 0;
}

// The k bits of word i ending at lane j's slot, oldest slot at bit 0:
// bits 65 + j - k .. 64 + j of the 96-bit window cur:prev (a funnel
// shift; 65 + j - k >= 2 for k <= 63).
BFC_HD uint64_t win_cut(const SlotWin& w, int i, int j, int k) {
    int sh = 65 + j - k;
    uint64_t v = sh >= 64 ? (uint64_t)w.cur[i] >> (sh - 64)
                          : (w.prev[i] >> sh) | ((uint64_t)w.cur[i] << (64 - sh));
    return v & bfc_mask(k);
}

// The 4-plane state that kmer_append leaves after the k bases whose low
// and high bits are lo and hi (oldest at bit 0): x[0]/x[1] hold the newest
// base at bit 0, so they are the bits reversed; x[2]/x[3] the oldest at
// bit 0, so they are the bits complemented.
BFC_HD void kmer_from_bits(uint64_t x[4], uint64_t lo, uint64_t hi, int k) {
    uint64_t m = bfc_mask(k);
    x[0] = bfc_brev64(lo) >> (64 - k);
    x[1] = bfc_brev64(hi) >> (64 - k);
    x[2] = ~lo & m;
    x[3] = ~hi & m;
}

// The planes of the k-mer ending at lane j's slot; false (x untouched)
// unless its k slots are all ACGT inside the read.
BFC_HD bool win_kmer(const SlotWin& w, int j, int k, uint64_t x[4]) {
    if (win_cut(w, 2, j, k) != bfc_mask(k)) return false;
    kmer_from_bits(x, win_cut(w, 0, j, k), win_cut(w, 1, j, k), k);
    return true;
}
