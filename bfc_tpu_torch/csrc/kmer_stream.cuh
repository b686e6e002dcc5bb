// KA per-slot body: the counting pass's sort keys of one slot, cut from a
// warp's window over its read (kmer.cuh: SlotWin).
#pragma once
#include "kmer.cuh"

// The sort key planes of lane j's slot of a counting run: shard
// (BFC_INVALID_SHARD where no full ACGT k-mer ends there), keybody, and
// arrp = arr << 1 | is_high, where arr is the slot's arrival and is_high
// means all k bases passed the quality test.  ret (the low 64 bits of the
// Bloom-addressing hash) is written only when non-null.
BFC_HD void ka_slot(const SlotWin& w, int j, int k, int l_pre, int64_t arr,
                    int64_t* shard, int64_t* keybody, int64_t* arrp,
                    int64_t* ret) {
    uint64_t x[4];
    int64_t s = BFC_INVALID_SHARD, kb = 0;
    uint64_t r = 0;
    int high = 0;
    if (win_kmer(w, j, k, x)) {
        high = win_cut(w, 3, j, k) == bfc_mask(k);
        uint64_t h0, h1;
        r = kmer_hash(x, k, &h0, &h1);
        shard_keybody(h0, h1, k, l_pre, &s, &kb);
    }
    *shard = s;
    *keybody = kb;
    *arrp = (arr << 1) | high;
    if (ret) *ret = (int64_t)r;
}
