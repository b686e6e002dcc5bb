// Two-slot cuckoo probe of the spectrum table, shared by KC and KD.
//
// Replaces bfc_tpu/ops/spectrum.py:cuckoo_lookup (:687) and
// cuckoo_lookup32 (:721).  The table is one u64 array of 1 << c_bits
// entries, entry = qlow << 15 | nest << 14 | payload(14); payload 0 is an
// empty slot.  Slot 1 is the top c_bits of the 64-bit position key, slot 2
// is slot 1 ^ alt(qlow); (slot, nest, qlow) reconstructs the identity, so
// a match is exact.  On the card a probe is two independent random 8-byte
// loads: each costs one 32-byte sector, and the probe is bound by their
// latency, which the many reads in flight hide.
#pragma once
#include "kmer.cuh"

struct SpecParams {
    const uint64_t* table;  // [1 << c_bits]
    int k;
    int l_pre;
    int kb_bits;
    int c_bits;
};

// Uniform 64-bit position key: shard then keybody, left-justified.
BFC_HD uint64_t posk64(int64_t shard, int64_t keybody, int l_pre,
                       int kb_bits) {
    uint64_t hi = (uint64_t)shard << (64 - l_pre);
    int rem = 64 - l_pre - kb_bits;
    uint64_t lo = rem >= 0 ? (uint64_t)keybody << rem
                           : (uint64_t)keybody >> (-rem);
    return hi | lo;
}

// Low identity_bits - c_bits bits of the (shard || keybody) string.
BFC_HD uint64_t id_low(int64_t shard, int64_t keybody, int l_pre,
                       int kb_bits, int c_bits) {
    int nbits = l_pre + kb_bits - c_bits;
    if (nbits <= 0) return 0;
    if (nbits <= kb_bits) return (uint64_t)keybody & bfc_mask(nbits);
    int extra = nbits - kb_bits;
    return (((uint64_t)shard & bfc_mask(extra)) << kb_bits) |
           (uint64_t)keybody;
}

// Alternate-slot offset (spectrum.py:cuckoo_alt_u64, :621).
BFC_HD uint64_t cuckoo_alt(uint64_t qlow, int c_bits) {
    if (c_bits > 32) return (qlow * 0x9E3779B97F4A7C15ull) >> (64 - c_bits);
    uint64_t h = (((qlow & 0xFFFFFFFFull) * 0x9E3779B9ull) ^
                  ((qlow >> 32) * 0x85EBCA6Bull)) & 0xFFFFFFFFull;
    return h >> (32 - c_bits);
}

BFC_HD int cuckoo_match(uint64_t e, int nest, uint64_t qlow) {
    return (e & 0x3FFF) != 0 && (int)((e >> 14) & 1) == nest &&
           (e >> 15) == qlow;
}

// 14-bit payload of (shard, keybody), or -1 when absent.
BFC_HD int cuckoo_probe(const SpecParams& sp, int64_t shard,
                        int64_t keybody) {
    uint64_t pk = posk64(shard, keybody, sp.l_pre, sp.kb_bits);
    uint64_t s1 = pk >> (64 - sp.c_bits);
    uint64_t qlow = id_low(shard, keybody, sp.l_pre, sp.kb_bits, sp.c_bits);
    uint64_t s2 = s1 ^ cuckoo_alt(qlow, sp.c_bits);
    uint64_t e1 = sp.table[s1];
    uint64_t e2 = sp.table[s2];
    if (cuckoo_match(e1, 0, qlow)) return (int)(e1 & 0x3FFF);
    if (cuckoo_match(e2, 1, qlow)) return (int)(e2 & 0x3FFF);
    return -1;
}

#ifdef __CUDA_ARCH__
#define BFC_ATOMIC_EXCH_U64(p, v) \
    atomicExch((unsigned long long*)(p), (unsigned long long)(v))
#else
#define BFC_ATOMIC_EXCH_U64(p, v) bfc_exch_u64((p), (v))
inline uint64_t bfc_exch_u64(uint64_t* p, uint64_t v) {
    uint64_t old = *p;
    *p = v;
    return old;
}
#endif

// The entry of a (shard, keybody, payload) key in its first slot (nest 0);
// *slot receives that slot.
BFC_HD uint64_t cuckoo_entry(int64_t shard, int64_t keybody, int payload,
                             int l_pre, int kb_bits, int c_bits,
                             uint64_t* slot) {
    *slot = posk64(shard, keybody, l_pre, kb_bits) >> (64 - c_bits);
    return id_low(shard, keybody, l_pre, kb_bits, c_bits) << 15 |
           (uint64_t)(payload & 0x3FFF);
}

// KL's insert (replaces cuckoo_build_device's placement rounds,
// spectrum.py:543): swap entry e into its slot; an evicted entry moves to
// its other slot, slot ^ cuckoo_alt(qlow), with its nest bit flipped, so
// the chain needs nothing but the entries.  Every exchange is atomic, so
// no entry is lost or doubled; returns false when the chain reaches
// max_steps and the entry in hand is dropped.
BFC_HD bool cuckoo_insert(uint64_t* table, uint64_t e, uint64_t slot,
                          int c_bits, int max_steps) {
    for (int step = 0; step < max_steps; step++) {
        uint64_t old = BFC_ATOMIC_EXCH_U64(table + slot, e);
        if ((old & 0x3FFF) == 0) return true;
        slot ^= cuckoo_alt(old >> 15, c_bits);
        e = old ^ (1ull << 14);
    }
    return false;
}

// Payload of the k-mer held in the 4-plane state x (CountHash.kmer_occ).
BFC_HD int kmer_occ(const SpecParams& sp, const uint64_t x[4]) {
    uint64_t h0, h1;
    kmer_hash(x, sp.k, &h0, &h1);
    int64_t shard, keybody;
    shard_keybody(h0, h1, sp.k, sp.l_pre, &shard, &keybody);
    return cuckoo_probe(sp, shard, keybody);
}
