// Blocked Bloom filter addressing, the per-row bodies of KE and KG, and
// the per-chunk steps of KH.
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

// True where every probed bit of ret is set in the u32 words (bbf.c:47-63):
// the 16 words of its block, no word loaded after the first unset bit.
BFC_HD bool bloom_query(const uint32_t* words, uint64_t ret, int bf_shift,
                        int n_hashes) {
    const uint32_t* blk =
        words + (bloom_block(ret, bf_shift) << (BFC_BLK_SHIFT - 5));
    bool all = true;
    bloom_offsets(bloom_zh(ret, bf_shift), n_hashes, [&](uint32_t z) {
        all = all && ((blk[z >> 5] >> (z & 31)) & 1u);
    });
    return all;
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

// KH, one read a warp, a 32-slot chunk at a time: the longest run of
// k-mers whose bits are all set, packed len << 32 | end (refmodel.
// max_streak; reference correct.c:478-497).  The reference rolls t along
// the read: t gains 1 << 32 at a hit and restarts at i + 1 at any other
// slot (an N, a slot before k - 1, a k-mer not in the filter), and the
// answer is the largest t over i < len, so a read without a hit gives
// len, and equal runs resolve to the later one through the low word.
// The warp takes each chunk's hits as one ballot word, and lane j derives
// slot base + j's t from it and the hit run carried into the chunk.

// Lane j's slot holds a k-mer (all ACGT inside the read, ending at or
// after k - 1: win_kmer) whose probed bits are all set.
BFC_HD bool kh_hit(const SlotWin& w, int j, int k, const uint32_t* words,
                   int bf_shift, int n_hashes) {
    uint64_t x[4], h0, h1;
    return win_kmer(w, j, k, x) &&
           bloom_query(words, kmer_hash(x, k, &h0, &h1), bf_shift, n_hashes);
}

// The hit run reaching the current chunk: its length, and its first slot
// (where run is 0, the chunk's first slot).
struct KhRun {
    uint32_t run, start;
};

// The chunk's slots inside a read of len bases: bit j for slot base + j.
BFC_HD uint32_t kh_inside(int len, int base) {
    int n = len - base;
    return n >= 32 ? 0xFFFFFFFFu : n > 0 ? (1u << n) - 1u : 0u;
}

// t at lane j's slot base + j (inside the read) from the chunk's hits
// (masked to the read) and the run carried into the chunk.
BFC_HD uint64_t kh_lane_t(KhRun r, uint32_t hits, int j, int base) {
    int ones = bfc_clz32(~(hits << (31 - j)));  // hits ending at slot j
    if (ones == 0) return (uint64_t)(base + j + 1);
    if (ones == j + 1) return (uint64_t)(r.run + ones) << 32 | r.start;
    return (uint64_t)ones << 32 | (uint32_t)(base + j + 1 - ones);
}

// The run carried into the next chunk.
BFC_HD KhRun kh_carry(KhRun r, uint32_t hits, int base) {
    int top = bfc_clz32(~hits);  // hits ending at the chunk's last slot
    if (top == 32) return {r.run + 32, r.start};
    return {(uint32_t)top, (uint32_t)(base + 32 - top)};
}

// One chunk of lane j, whose best t so far is *best: hits are the chunk's
// hit ballot (bits past len are ignored).
BFC_HD void kh_step(KhRun& r, uint64_t* best, uint32_t hits, int j, int base,
                    int len) {
    uint32_t in = kh_inside(len, base);
    hits &= in;
    if ((in >> j) & 1) {
        uint64_t t = kh_lane_t(r, hits, j, base);
        if (t > *best) *best = t;
    }
    r = kh_carry(r, hits, base);
}
