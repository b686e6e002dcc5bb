// Per-row bodies of the device finalize: KI (first-occurrence verdict by
// Bloom-block replay), KJ (derive_ret) and KK (payloads and histograms).
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

// KK, one row (spectrum.py:finalize_counts_fp, :868): m = n - 1 + fp
// occurrences were inserted into the table (the first one only if it was
// a Bloom hit), high = n_high - (1 - fp) * first_high of them were high
// quality; the row is kept when m >= 1, with payload min(m, 255) |
// min(high, 63) << 8.  Returns the payload, 0 for a dropped row.
BFC_HD int32_t kk_row(int64_t i, const int64_t* n, const int64_t* n_high,
                      const uint8_t* first_high, const uint8_t* fp,
                      int32_t* payload, uint8_t* keep) {
    int64_t f = fp[i] ? 1 : 0;
    int64_t m = n[i] - 1 + f;
    int64_t high = n_high[i] - (1 - f) * (int64_t)first_high[i];
    int32_t p = 0;
    if (m >= 1)
        p = (int32_t)(m < 255 ? m : 255) | (int32_t)(high < 63 ? high : 63) << 8;
    payload[i] = p;
    keep[i] = (uint8_t)(p != 0);
    return p;
}

// KI, one Bloom block: its rows in arrival order (rows perm[b..e), sorted
// by (block, arrival)) replay the reference's inserts (count.c:71-87) over
// the block's 512 bits in bm (16 words, zeroed here).  A row's verdict is
// whether all its bits were set before it; rows of equal arrival do not
// see each other, as in the sort formulation (spectrum.py:
// adjudicate_first_occurrence, :217).  All bits of a row lie in its own
// block (bloom.cuh), so blocks are independent and this is exact at any
// arrival width.
BFC_HD void ki_block(int64_t b, int64_t e, const int64_t* perm,
                     const int64_t* ret, const int64_t* arr, int bf_shift,
                     int n_hashes, uint32_t* bm, uint8_t* fp) {
    uint64_t bits[BFC_MAX_HASHES];
    for (int w = 0; w < 16; w++) bm[w] = 0;
    int64_t g = b;  // first row of the current arrival
    for (int64_t t = b; t < e; t++) {
        int64_t r = perm[t];
        bloom_probe_bits((uint64_t)ret[r], bf_shift, n_hashes, bits);
        int all = 1;
        for (int j = 0; j < n_hashes; j++) {
            uint32_t z = (uint32_t)bits[j] & BFC_BLK_MASK;
            all &= (int)(bm[z >> 5] >> (z & 31)) & 1;
        }
        fp[r] = (uint8_t)all;
        if (t + 1 < e && arr[perm[t + 1]] == arr[r]) continue;
        // the arrival's last row: set its bits, then those of its ties
        for (int64_t u = t; u >= g; u--) {
            if (u < t)
                bloom_probe_bits((uint64_t)ret[perm[u]], bf_shift, n_hashes,
                                 bits);
            for (int j = 0; j < n_hashes; j++) {
                uint32_t z = (uint32_t)bits[j] & BFC_BLK_MASK;
                bm[z >> 5] |= 1u << (z & 31);
            }
        }
        g = t + 1;
    }
}
