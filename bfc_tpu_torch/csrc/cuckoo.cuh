// Two-slot cuckoo probe of the spectrum table, shared by KC and KD.
//
// Replaces bfc_tpu/ops/spectrum.py:cuckoo_lookup (:687) and
// cuckoo_lookup32 (:721).  The table is one u64 array of 1 << c_bits
// entries, entry = qlow << 15 | nest << 14 | payload(14); payload 0 is an
// empty slot.  Slot 1 is the top c_bits of the 64-bit position key, slot 2
// is slot 1 ^ alt(qlow); (slot, nest, qlow) reconstructs the identity, so
// a match is exact.  On the card a probe is one or two random 8-byte
// loads (KD issues both at once; KC the second only where the first
// misses): each costs one 32-byte sector.
//
// The prefix-sharded table (bfc_tpu's ShardedCuckoo, spectrum.py:316-343)
// is 1 << db sub-tables of 1 << cb_local entries, one a rank: the owner of
// a key is the top db bits of its position key, s1 the cb_local bits
// below them, qlow the identity bits below the top c_bits = db + cb_local,
// and s2 = s1 ^ subtable_alt(qlow).  KC and KD read the owner's sub-table
// through an array of device addresses, a peer's mapped by CUDA IPC;
// cuckoo_addr's sharded branch replaces sharded_cuckoo_lookup (:368), whose
// request/response all_to_all a thread in mid-search could not join.
#pragma once
#include "kmer.cuh"

struct SpecParams {
    const uint64_t* table;  // [1 << c_bits]; null when the table is sharded
    int k;
    int l_pre;
    int kb_bits;
    int c_bits;             // sharded: db + cb_local
    // the sharded table's 1 << db sub-tables, or null; every thread of a
    // launch takes the same layout, so the branch never diverges
    const uint64_t* const* subtables;
    int db;
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

// The sub-table rules (spectrum.py:396-441): the owning rank of a
// position key, its first slot in the owner's sub-table, and the
// alternate-slot offset there, which is the 64-bit multiplicative hash at
// every cb_local (cuckoo_alt's 32-bit form would miss silently).
BFC_HD int subtable_owner(uint64_t pk, int db) {
    return db ? (int)(pk >> (64 - db)) : 0;
}

BFC_HD uint64_t subtable_slot(uint64_t pk, int c_bits, int cb_local) {
    return (pk >> (64 - c_bits)) & bfc_mask(cb_local);
}

BFC_HD uint64_t subtable_alt(uint64_t qlow, int cb_local) {
    return (qlow * 0x9E3779B97F4A7C15ull) >> (64 - cb_local);
}

BFC_HD int cuckoo_match(uint64_t e, int nest, uint64_t qlow) {
    return (e & 0x3FFF) != 0 && (int)((e >> 14) & 1) == nest &&
           (e >> 15) == qlow;
}

BFC_HD int cuckoo_pick(uint64_t e1, uint64_t e2, uint64_t qlow) {
    if (cuckoo_match(e1, 0, qlow)) return (int)(e1 & 0x3FFF);
    if (cuckoo_match(e2, 1, qlow)) return (int)(e2 & 0x3FFF);
    return -1;
}

// The two slots a probe reads and the identity bits it matches.  A probe
// splits into cuckoo_addr (arithmetic only) and cuckoo_pick on the two
// loaded entries, so a caller can issue the loads of several probes
// before it uses any (KD's search step).
struct ProbeAddr {
    const uint64_t* p1;
    const uint64_t* p2;
    uint64_t qlow;
};

// The slots of (shard, keybody): in the replicated table, or in the
// owner's sub-table of the sharded one.
BFC_HD ProbeAddr cuckoo_addr(const SpecParams& sp, int64_t shard,
                             int64_t keybody) {
    ProbeAddr a;
    uint64_t pk = posk64(shard, keybody, sp.l_pre, sp.kb_bits);
    a.qlow = id_low(shard, keybody, sp.l_pre, sp.kb_bits, sp.c_bits);
    if (sp.subtables) {
        int cb_local = sp.c_bits - sp.db;
        const uint64_t* t = sp.subtables[subtable_owner(pk, sp.db)];
        uint64_t s1 = subtable_slot(pk, sp.c_bits, cb_local);
        a.p1 = t + s1;
        a.p2 = t + (s1 ^ subtable_alt(a.qlow, cb_local));
    } else {
        uint64_t s1 = pk >> (64 - sp.c_bits);
        a.p1 = sp.table + s1;
        a.p2 = sp.table + (s1 ^ cuckoo_alt(a.qlow, sp.c_bits));
    }
    return a;
}

// A read-only load of a table entry (the read-only data path on the card).
BFC_HD uint64_t table_load(const uint64_t* p) {
#ifdef __CUDA_ARCH__
    return (uint64_t)__ldg((const unsigned long long*)p);
#else
    return *p;
#endif
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

// The entry of a key in its own sub-table's first slot (nest 0).
BFC_HD uint64_t subtable_entry(int64_t shard, int64_t keybody, int payload,
                               int l_pre, int kb_bits, int c_bits,
                               int cb_local, uint64_t* slot) {
    *slot = subtable_slot(posk64(shard, keybody, l_pre, kb_bits), c_bits,
                          cb_local);
    return id_low(shard, keybody, l_pre, kb_bits, c_bits) << 15 |
           (uint64_t)(payload & 0x3FFF);
}

// KL's and KN's insert (replaces the placement rounds of
// cuckoo_build_device, spectrum.py:543, and cuckoo_build_local, :467):
// swap entry e into its slot; an evicted entry moves to its other slot,
// slot ^ alt(qlow), with its nest bit flipped, so the chain needs nothing
// but the entries.  alt is cuckoo_alt at c_bits for the whole table
// (cb_local 0) and subtable_alt at cb_local for a sub-table.  Every
// exchange is atomic, so no entry is lost or doubled; returns false when
// the chain reaches max_steps and the entry in hand is dropped.
BFC_HD bool cuckoo_insert(uint64_t* table, uint64_t e, uint64_t slot,
                          int c_bits, int max_steps, int cb_local = 0) {
    for (int step = 0; step < max_steps; step++) {
        uint64_t old = BFC_ATOMIC_EXCH_U64(table + slot, e);
        if ((old & 0x3FFF) == 0) return true;
        slot ^= cb_local ? subtable_alt(old >> 15, cb_local)
                         : cuckoo_alt(old >> 15, c_bits);
        e = old ^ (1ull << 14);
    }
    return false;
}

// The probe address of the k-mer held in the 4-plane state x.
BFC_HD ProbeAddr kmer_addr(const SpecParams& sp, const uint64_t x[4]) {
    uint64_t h0, h1;
    kmer_hash(x, sp.k, &h0, &h1);
    int64_t shard, keybody;
    shard_keybody(h0, h1, sp.k, sp.l_pre, &shard, &keybody);
    return cuckoo_addr(sp, shard, keybody);
}
