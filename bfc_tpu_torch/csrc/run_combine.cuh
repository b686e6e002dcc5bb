// KB per-row bodies: group heads and the combine of one group.
#pragma once
#include "kmer.cuh"

// Row i of a run sorted by (shard, keybody) opens a group when it is valid
// and its key differs from row i-1's.
BFC_HD int32_t kb_head(const int64_t* shard, const int64_t* keybody,
                       int64_t i) {
    if (shard[i] == BFC_INVALID_SHARD) return 0;
    return i == 0 || shard[i] != shard[i - 1] ||
           keybody[i] != keybody[i - 1];
}

// Folds the group that row i heads into compacted slot cum[i] - 1: the
// occurrence counts add, and the head (the earliest arrival, since the
// sort is stable over stream order) keeps its arrival, first_high and
// ret.  Rows that do not head a group write nothing.
BFC_HD void kb_combine(int64_t i, int64_t N, const int32_t* head,
                       const int64_t* cum, const int64_t* shard,
                       const int64_t* keybody, const int64_t* arr,
                       const int64_t* n, const int64_t* nh,
                       const uint8_t* fh, const int64_t* ret,
                       int64_t* o_shard, int64_t* o_keybody, int64_t* o_arr,
                       int64_t* o_n, int64_t* o_nh, uint8_t* o_fh,
                       int64_t* o_ret) {
    if (!head[i]) return;
    int64_t sn = n[i], snh = nh[i];
    for (int64_t j = i + 1;
         j < N && !head[j] && shard[j] != BFC_INVALID_SHARD; j++) {
        sn += n[j];
        snh += nh[j];
    }
    int64_t s = cum[i] - 1;
    o_shard[s] = shard[i];
    o_keybody[s] = keybody[i];
    o_arr[s] = arr[i];
    o_n[s] = sn;
    o_nh[s] = snh;
    o_fh[s] = fh[i];
    if (ret) o_ret[s] = ret[i];
}
