// Blocked Bloom filter addressing and the per-row bodies of KE, KG, KH.
//
// bloom_probe_bits is the scalar form of bfc_tpu/ops/spectrum.py:
// bloom_probe_bits (:184) and of the reference's bbf.c:27-37: the low
// bf_shift-9 bits of ret pick a 512-bit block, h1 is the first offset and
// h2 the stride (bumped when h2 & 31 == 0), and offsets in byte 0 of the
// block (z < 8, the reference's spin-lock byte) are skipped.  Bit ids are
// 64-bit: at bf_shift >= 33 they reach past 2^32.  All n_hashes bits of
// one hash fall in one 64-byte block, so KF and KI judge a row from its
// block and its offsets alone (csrc/verdict.cuh).
//
// The bodies are __host__ __device__ so that csrc/host_shim.cpp can run
// them on the CPU; the atomics become plain read-modify-writes there.
#pragma once
#include "kmer.cuh"

#define BFC_BLK_SHIFT 9
#define BFC_BLK_MASK 511u
// A stride not divisible by 32 has a cycle of at least 32 offsets mod 512,
// at most 8 of them in byte 0: up to 24 hashes always find their bits.
#define BFC_MAX_HASHES 16

// The 512-bit block of ret.
BFC_HD uint64_t bloom_block(uint64_t ret, int bf_shift) {
    return ret & bfc_mask(bf_shift - BFC_BLK_SHIFT);
}

// z | h2 << 9: the first offset and the stride within the block.
BFC_HD uint32_t bloom_zh(uint64_t ret, int bf_shift) {
    uint32_t z = (uint32_t)(ret >> (bf_shift - BFC_BLK_SHIFT)) & BFC_BLK_MASK;
    uint32_t h2 = (uint32_t)(ret >> bf_shift) & BFC_BLK_MASK;
    if ((h2 & 31u) == 0) h2 = (h2 + 1) & BFC_BLK_MASK;
    return z | h2 << 9;
}

// Calls f(z) for each of the n_hashes probed offsets of zh, in order:
// n_hashes + 8 steps hold them all (as in the plain version) and bound
// the walk whatever zh holds.
template <typename F>
BFC_HD void bloom_offsets(uint32_t zh, int n_hashes, F f) {
    uint32_t z = zh & BFC_BLK_MASK, h2 = zh >> 9;
    for (int j = 0, t = 0; j < n_hashes && t < n_hashes + 8;
         t++, z = (z + h2) & BFC_BLK_MASK)
        if (z >= 8) {
            f(z);
            j++;
        }
}

BFC_HD void bloom_probe_bits(uint64_t ret, int bf_shift, int n_hashes,
                             uint64_t* out) {
    uint64_t base = bloom_block(ret, bf_shift) << BFC_BLK_SHIFT;
    int j = 0;
    bloom_offsets(bloom_zh(ret, bf_shift), n_hashes,
                  [&](uint32_t z) { out[j++] = base | z; });
}

// True where every probed bit of ret is set in the u32 words (bbf.c:47-63).
BFC_HD bool bloom_query(const uint32_t* words, uint64_t ret, int bf_shift,
                        int n_hashes) {
    uint64_t bits[BFC_MAX_HASHES];
    bloom_probe_bits(ret, bf_shift, n_hashes, bits);
    for (int j = 0; j < n_hashes; j++)
        if (!((words[bits[j] >> 5] >> (bits[j] & 31)) & 1u)) return false;
    return true;
}

#ifdef __CUDA_ARCH__
#define BFC_ATOMIC_OR_U32(p, v) atomicOr((p), (v))
#else
#define BFC_ATOMIC_OR_U32(p, v) (*(p) |= (v))
#endif

// KE, one row of a run: the packed pull plane
// nfh = min(n,511) | min(n_high,127) << 9 | first_high << 16 | arr_hi << 17
// and the low 32 bits of the arrival (spectrum_dense.py:pack_pull, :233).
BFC_HD void ke_row(int64_t i, const int64_t* arr, const int64_t* n,
                   const int64_t* nh, const uint8_t* fh, int32_t* a_lo,
                   int32_t* nfh) {
    uint64_t a = (uint64_t)arr[i];
    uint32_t cn = n[i] < 511 ? (uint32_t)n[i] : 511u;
    uint32_t ch = nh[i] < 127 ? (uint32_t)nh[i] : 127u;
    a_lo[i] = (int32_t)(uint32_t)a;
    nfh[i] = (int32_t)(cn | ch << 9 | (uint32_t)fh[i] << 16 |
                       (uint32_t)(a >> 32) << 17);
}

// KG, one row: OR the probed bits of a kept row into the u32 words
// (trimmer.py:_bloom_build, :49).  OR is order-free: the build is exact.
BFC_HD void kg_row(int64_t i, const int64_t* ret, const uint8_t* keep,
                   int bf_shift, int n_hashes, uint32_t* words) {
    if (!keep[i]) return;
    uint64_t bits[BFC_MAX_HASHES];
    bloom_probe_bits((uint64_t)ret[i], bf_shift, n_hashes, bits);
    for (int j = 0; j < n_hashes; j++)
        BFC_ATOMIC_OR_U32(words + (bits[j] >> 5), 1u << (bits[j] & 31));
}

// KH, one read: the longest run of k-mers whose bits are all set, packed
// len << 32 | end (refmodel.max_streak; reference correct.c:478-497).  t
// gains 1 << 32 at each hit and restarts at i + 1 elsewhere, so the
// numeric maximum resolves equal lengths to the later run.
BFC_HD int64_t kh_read(const uint8_t* bases, int len, int k,
                       const uint32_t* words, int bf_shift, int n_hashes) {
    uint64_t x[4] = {0, 0, 0, 0};
    uint64_t t = 0, best = 0, h0, h1;
    int run = 0;
    for (int i = 0; i < len; i++) {
        int c = bases[i];
        if (c < 4) {
            kmer_append(x, c, k);
            if (++run >= k &&
                bloom_query(words, kmer_hash(x, k, &h0, &h1), bf_shift,
                            n_hashes))
                t += 1ull << 32;
            else
                t = (uint64_t)(i + 1);
        } else {
            run = 0;
            kmer_clear(x);
            t = (uint64_t)(i + 1);
        }
        if (t > best) best = t;
    }
    return (int64_t)best;
}
