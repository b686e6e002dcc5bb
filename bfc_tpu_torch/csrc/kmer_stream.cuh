// KA per-read body: the counting pass's k-mer stream of one read.
#pragma once
#include "kmer.cuh"

// Rolls one padded read of L slots.  For each slot i it writes the sort
// key planes of a counting run: shard (BFC_INVALID_SHARD where no full
// ACGT k-mer ends at i), keybody, and arrp = (arr0 + i) << 1 | is_high,
// where is_high means all k bases passed the quality test.  ret (the low
// 64 bits of the Bloom-addressing hash) is written only when non-null.
BFC_HD void ka_read(const uint8_t* bases, const uint8_t* qok, int len, int L,
                    int k, int l_pre, int64_t arr0, int64_t* shard,
                    int64_t* keybody, int64_t* arrp, int64_t* ret) {
    uint64_t x[4] = {0, 0, 0, 0};
    int run = 0, qrun = 0;
    for (int i = 0; i < L; i++) {
        int c = i < len ? bases[i] : 4;
        int valid = 0, high = 0;
        if (c < 4) {
            kmer_append(x, c, k);
            run++;
            qrun = qok[i] ? qrun + 1 : 0;
            valid = run >= k;
            high = valid && qrun >= k;
        } else {
            run = qrun = 0;
            kmer_clear(x);
        }
        int64_t s = BFC_INVALID_SHARD, kb = 0;
        uint64_t r = 0;
        if (valid) {
            uint64_t h0, h1;
            r = kmer_hash(x, k, &h0, &h1);
            shard_keybody(h0, h1, k, l_pre, &s, &kb);
        }
        shard[i] = s;
        keybody[i] = kb;
        arrp[i] = ((arr0 + i) << 1) | high;
        if (ret) ret[i] = (int64_t)r;
    }
}
