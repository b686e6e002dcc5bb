// KC per-slot and per-chunk bodies: k-mer coverage and the longest solid
// island of one read, a 32-slot chunk at a time (bfc_ec_kcov and
// bfc_ec_best_island, correct.c:96-130; refmodel.ec_kcov and
// ec_best_island).
#pragma once
#include "cuckoo.cuh"

// occ of lane j's slot: the payload of the k-mer ending there, -1 when
// there is none or it is absent.  The second nest is loaded only when the
// first does not match, cuckoo_pick's own order: on the main path this
// needs 1.32 sectors a probe, not 2, and ran 1.4x faster on an H100 than
// issuing both loads at once (PERF.md section 6).
BFC_HD int kc_occ(const SpecParams& sp, const SlotWin& w, int j) {
    uint64_t x[4];
    if (!win_kmer(w, j, sp.k, x)) return -1;
    ProbeAddr a = kmer_addr(sp, x);
    uint64_t e1 = table_load(a.p1);
    if (cuckoo_match(e1, 0, a.qlow)) return (int)(e1 & 0x3FFF);
    uint64_t e2 = table_load(a.p2);
    return cuckoo_match(e2, 1, a.qlow) ? (int)(e2 & 0x3FFF) : -1;
}

BFC_HD int kc_solid(int o, int min_cov) {
    return o >= 0 && (o & 0xFF) >= min_cov;
}

BFC_HD int kc_high(int o, int min_cov) {
    return kc_solid(o, min_cov) && ((o >> 8) & 0x3F) >= min_cov + 1;
}

// lcov or hcov of lane j's slot: the solid (or solid-and-high) k-mer ends
// in [j, j+k-1] of the 96 bits w0 | w1 << 32 | w2 << 64 (the chunk and the
// two after it; zero past the row), wrapped mod 64 like the reference's
// 6-bit fields.
BFC_HD int kc_window(uint32_t w0, uint32_t w1, uint32_t w2, int j, int k) {
    uint64_t lo = (uint64_t)w0 | ((uint64_t)w1 << 32);
    uint64_t v = j ? (lo >> j) | ((uint64_t)w2 << (64 - j)) : lo;
    return bfc_popc64(v & bfc_mask(k)) & 63;
}

// The island scan's state: the solid run ending at the last slot fed,
// and the longest run so far with its break position.
struct KcIsland {
    int run, maxv, max_i;
};

// Feed one chunk's solid word, bit j the slot base + j.  A run ends at
// the first zero after it, and only a strictly longer run replaces the
// best, so the first of equal runs wins.  Zeros before k - 1 (no k-mer
// ends there) and past the read (occ -1) end no run longer than 0, so
// the scan over whole chunks is the reference's over k - 1 .. n - 1.
BFC_HD void kc_island_step(KcIsland& I, uint32_t solid, int base) {
    int pos = 0;
    while (pos < 32) {
        int ones = bfc_ctz64(~(uint64_t)(solid >> pos));
        I.run += ones;
        pos += ones;
        if (pos == 32) return;  // the run goes on into the next chunk
        if (I.run > I.maxv) {
            I.maxv = I.run;
            I.max_i = base + pos;
        }
        I.run = 0;
        if (++pos == 32 || (solid >> pos) == 0) return;
        pos += bfc_ctz64(solid >> pos);
    }
}

// isl = {start, end, found} of a read of n bases once every chunk is fed;
// a run that reaches the last slot ends at n.
BFC_HD void kc_island_end(KcIsland I, int n, int k, int32_t* isl) {
    if (I.run > I.maxv) {
        I.maxv = I.run;
        I.max_i = n;
    }
    isl[0] = I.maxv > 0 ? I.max_i - I.maxv - k + 1 : 0;
    isl[1] = I.maxv > 0 ? I.max_i : 0;
    isl[2] = I.maxv > 0;
}
