// KC per-read body: k-mer coverage and the longest solid island.
#pragma once
#include "cuckoo.cuh"

// One read of n bases in a row of L slots (bfc_ec_kcov and
// bfc_ec_best_island, correct.c:96-130; refmodel.ec_kcov and
// ec_best_island).  Writes occ[i] (the payload of the k-mer ending at i,
// -1 when there is none or it is absent), lcov[j] / hcov[j] (solid /
// solid-and-high k-mer ends in [j, j+k-1], wrapping mod 64 like the
// reference's 6-bit fields) and isl = {start, end, found} with the
// reference's first-strict-maximum scan.
BFC_HD void kc_read(const SpecParams& sp, int min_cov, const uint8_t* b,
                    int n, int L, int32_t* occ, uint8_t* lcov,
                    uint8_t* hcov, int32_t* isl) {
    const int k = sp.k;
    uint64_t x[4] = {0, 0, 0, 0};
    int run = 0;
    for (int i = 0; i < L; i++) {
        int c = i < n ? b[i] : 4;
        int o = -1;
        if (c < 4) {
            kmer_append(x, c, k);
            if (++run >= k) o = kmer_occ(sp, x);
        } else {
            run = 0;
            kmer_clear(x);
        }
        occ[i] = o;
    }
    // sliding window over the k-mer ends j .. j+k-1
    int wl = 0, wh = 0;
    for (int j = L - 1; j >= 0; j--) {
        int o = occ[j];
        int solid = o >= 0 && (o & 0xFF) >= min_cov;
        int high = solid && ((o >> 8) & 0x3F) >= min_cov + 1;
        wl += solid;
        wh += high;
        if (j + k < L) {
            int o2 = occ[j + k];
            int s2 = o2 >= 0 && (o2 & 0xFF) >= min_cov;
            wl -= s2;
            wh -= s2 && ((o2 >> 8) & 0x3F) >= min_cov + 1;
        }
        lcov[j] = (uint8_t)(wl & 63);
        hcov[j] = (uint8_t)(wh & 63);
    }
    int maxv = 0, max_i = -1, l = 0;
    for (int i = k - 1; i < n; i++) {
        int o = occ[i];
        if (o >= 0 && (o & 0xFF) >= min_cov) {
            l++;
        } else {
            if (l > maxv) { maxv = l; max_i = i; }
            l = 0;
        }
    }
    if (l > maxv) { maxv = l; max_i = n; }
    isl[0] = maxv > 0 ? max_i - maxv - k + 1 : 0;
    isl[1] = maxv > 0 ? max_i : 0;
    isl[2] = maxv > 0;
}
