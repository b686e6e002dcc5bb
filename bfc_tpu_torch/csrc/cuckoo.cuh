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

// --- The window build of KL and KN (csrc/cuckoo_window.cuh) -------------
//
// The table's 2^tb slots are cut into windows of 2^wb (wb = min(wmax,
// tb); the card's wmax is CK_WIN_BITS).  A key's window is its first slot
// >> wb.  The count pass counts the keys a window (into cursor) and
// raises CK_FLAG where a row's window is below the row before it.  Rows
// in window order also give each window's first row (start) straight
// away: the row that first reaches a window writes its index into the
// starts it passes (ck_reach), so no scan runs.  Where the flag is up, or
// a row would pass more than CK_GAP windows (CK_GAPS), a scan turns the
// counts into start and cursor instead, and with the flag up the scatter
// writes each row's index into the records, grouped by window (rec[2j] =
// the row at grouped position j).  The build then takes window by
// window: the window cleared, each of its keys placed at its first slot
// (ck_place) unless that is taken, when it is recorded for the overflow
// (ck_overflow: its entry with the nest bit set, and its second slot) at
// the window's own next record, so a window that reads scattered row
// indices overwrites only records it has read; then the window is
// written out whole, zeros included.  Last, each window's overflow
// records run ck_insert's chains into the finished table.
//
// meta (int64): CK_HDR header words (the failure count, the flag, the
// gap flag), then start[nw + 1], cursor[nw] and the windows' overflow
// counts novf[nw].  rec (int64): [n][2].
#define CK_WIN_BITS 12  // a window: 2^12 slots, 32 KB of shared memory
#define CK_HDR 3
#define CK_FAIL 0
#define CK_FLAG 1
#define CK_GAPS 2
#define CK_GAP 64       // the most starts one row writes
#define CK_BUILD_THREADS 256
#define CK_BUILD_ROWS 4  // rows a build thread loads before it places any
#define CK_CHUNK (CK_BUILD_THREADS * CK_BUILD_ROWS)

// The layout of one build: the whole table (cb_local 0: KL) or a rank's
// sub-table of 2^cb_local slots (KN).
struct CkGeom {
    int l_pre;
    int kb_bits;
    int c_bits;
    int cb_local;
};

BFC_HD int ck_table_bits(const CkGeom& g) {
    return g.cb_local ? g.cb_local : g.c_bits;
}

BFC_HD int ck_win_bits(const CkGeom& g, int wmax) {
    int tb = ck_table_bits(g);
    return tb < wmax ? tb : wmax;
}

BFC_HD int64_t ck_windows(const CkGeom& g, int wmax) {
    return (int64_t)1 << (ck_table_bits(g) - ck_win_bits(g, wmax));
}

struct CkMeta {
    int64_t* hdr;
    int64_t* start;
    int64_t* cursor;
    int64_t* novf;
};

BFC_HD CkMeta ck_meta(int64_t* meta, int64_t nw) {
    CkMeta m;
    m.hdr = meta;
    m.start = meta + CK_HDR;
    m.cursor = m.start + nw + 1;
    m.novf = m.cursor + nw;
    return m;
}

// The first slot of (shard, keybody): the top c_bits of its position
// key, or in its owner's sub-table the cb_local bits below the owner's.
BFC_HD uint64_t ck_slot(const CkGeom& g, int64_t shard, int64_t keybody) {
    uint64_t pk = posk64(shard, keybody, g.l_pre, g.kb_bits);
    return g.cb_local ? subtable_slot(pk, g.c_bits, g.cb_local)
                      : pk >> (64 - g.c_bits);
}

// The entry of a key in its first slot (nest 0); *slot receives the slot.
BFC_HD uint64_t ck_entry(const CkGeom& g, int64_t shard, int64_t keybody,
                         int payload, uint64_t* slot) {
    *slot = ck_slot(g, shard, keybody);
    return id_low(shard, keybody, g.l_pre, g.kb_bits, g.c_bits) << 15 |
           (uint64_t)(payload & 0x3FFF);
}

BFC_HD uint64_t ck_alt(const CkGeom& g, uint64_t qlow) {
    return g.cb_local ? subtable_alt(qlow, g.cb_local)
                      : cuckoo_alt(qlow, g.c_bits);
}

// A thread's contiguous part [*lo, *hi) of the nw window counts, when
// `threads` threads share them.
BFC_HD void ck_scan_part(int64_t nw, int tid, int threads, int64_t* lo,
                         int64_t* hi) {
    int64_t per = (nw + threads - 1) / threads;
    int64_t a = (int64_t)tid * per;
    *lo = a < nw ? a : nw;
    *hi = a + per < nw ? a + per : nw;
}

// The part's counts (in cursor) become the first grouped position of
// each window from base on, in start, and the cursors start there; eight
// at a time, loaded, then written.
BFC_HD void ck_scan_write(const CkMeta& m, int64_t lo, int64_t hi,
                          int64_t base) {
    for (int64_t a = lo; a < hi; a += 8) {
        int64_t c[8];
        for (int u = 0; u < 8; u++) c[u] = a + u < hi ? m.cursor[a + u] : 0;
        for (int u = 0; u < 8 && a + u < hi; u++) {
            m.start[a + u] = m.cursor[a + u] = base;
            base += c[u];
        }
    }
}

// Row i of n, in window w after a row in window prev (i > 0): where the
// rows are in window order, it is the first row of every window in
// (prev, w] (in [0, w] for row 0), and the last row also ends every
// window after w (start[nw] = n); it writes those starts unless they are
// more than CK_GAP, when it raises CK_GAPS and leaves them to the scan.
BFC_HD void ck_reach(const CkMeta& m, int64_t nw, int64_t i, int64_t n,
                     uint64_t prev, uint64_t w) {
    if (i == 0 || w > prev) {
        int64_t lo = i > 0 ? (int64_t)prev + 1 : 0;
        if ((int64_t)w - lo >= CK_GAP) {
            m.hdr[CK_GAPS] = 1;
        } else {
            for (int64_t v = lo; v <= (int64_t)w; v++) m.start[v] = i;
        }
    }
    if (i == n - 1) {
        if (nw - (int64_t)w > CK_GAP) {
            m.hdr[CK_GAPS] = 1;
        } else {
            for (int64_t v = (int64_t)w + 1; v <= nw; v++) m.start[v] = n;
        }
    }
}

// The row at grouped position j: j itself while the rows are in window
// order, else the index the scatter wrote.
BFC_HD int64_t ck_row(const int64_t* rec, int64_t scattered, int64_t j) {
    return scattered ? rec[2 * j] : j;
}

// Place entry e at its first slot in its window's copy win of 2^wb slots;
// false where the slot is taken.
BFC_HD bool ck_place(uint64_t* win, uint64_t e, uint64_t slot, int wb) {
    uint64_t* p = win + (slot & bfc_mask(wb));
#ifdef __CUDA_ARCH__
    return atomicCAS((unsigned long long*)p, 0ull, (unsigned long long)e) ==
           0ull;
#else
    if (*p) return false;
    *p = e;
    return true;
#endif
}

// Record p of the overflow: the entry with its nest bit set, at its
// second slot.
BFC_HD void ck_overflow(const CkGeom& g, int64_t* rec, int64_t p,
                        uint64_t e, uint64_t slot) {
    rec[2 * p] = (int64_t)(e ^ (1ull << 14));
    rec[2 * p + 1] = (int64_t)(slot ^ ck_alt(g, e >> 15));
}

// KL's and KN's overflow insert (replaces the placement rounds of
// cuckoo_build_device, spectrum.py:543, and cuckoo_build_local, :467) of
// record p into the finished table: swap its entry e into its slot; an
// evicted entry moves to its other slot, slot ^ ck_alt(qlow), with its
// nest bit flipped, so the chain needs nothing but the entries.  Every
// exchange is atomic, so no entry is lost or doubled; returns false when
// the chain reaches max_steps and the entry in hand is dropped.
BFC_HD bool ck_insert(const CkGeom& g, uint64_t* table, const int64_t* rec,
                      int64_t p, int max_steps) {
    uint64_t e = (uint64_t)rec[2 * p], slot = (uint64_t)rec[2 * p + 1];
    for (int step = 0; step < max_steps; step++) {
        uint64_t old = BFC_ATOMIC_EXCH_U64(table + slot, e);
        if ((old & 0x3FFF) == 0) return true;
        slot ^= ck_alt(g, old >> 15);
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
