// k-mer codec, canonical hash and table identity, shared by every kernel.
//
// Per-thread scalar forms of bfc_tpu/ops/kmer.py (kmer_planes, wang_hash,
// canonical_hash, shard_and_keybody) and of the reference's kmer.h:10-95:
// one thread rolls one read base by base, as the C reference does, so
// every plane and hash is a handful of u64 register ops.
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
