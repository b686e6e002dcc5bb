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
