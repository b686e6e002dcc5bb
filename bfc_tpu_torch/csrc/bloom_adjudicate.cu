// KF: first-occurrence Bloom verdicts and the bf_high keep set, on
// arrivals below 2^32 - 1.
//
// Replaces bfc_tpu/ops/spectrum.py:adjudicate_sketch (:843) with the keep
// rule of bfc_tpu/models/trimmer.py:filter_keep_rets (:81).  The reference
// inserts every k-mer occurrence into a Bloom filter in stream order and
// counts an occurrence once its bits were all set before it (count.c:
// 71-87); for a distinct k-mer only its first occurrence can differ, and
// it found its bits set exactly when, at every probed bit, some other
// k-mer's first arrival came earlier.  The TPU kept the earliest arrival
// of every one of the 2^bf_shift bits in one array (4 bytes a bit: 32 GiB
// at -b33).  Here the rows are grouped by superblocks of Bloom blocks,
// then by block in shared memory, and each block is judged there
// (csrc/verdict.cuh, u32 arrivals): 13 bytes a row and 4 bytes a
// superblock of scratch.  keep = n - 1 + fp >= 1 is judged beside fp from
// the class the scatter packed into the row's record.
//
// Bound: bytes.  ret, arr and n read once, fp and keep written once: 18
// bytes a row.  The design moves more: ret twice, an 8-byte record
// written to a slot of its superblock's segment and read back, two
// atomics a row on the superblock histogram (in L2), a slot and a verdict
// byte a row written and read back, the latter at random.
#include "verdict.cuh"

extern "C" int kf_launch(long long C, const void* ret, const void* arr,
                         const void* n, int bf_shift, int sb, int n_hashes,
                         void* rec, void* slot, void* flags, void* cnt,
                         void* sums, void* fp, void* keep, void* stream) {
    return vd_launch<uint32_t>(
        C, (const int64_t*)ret, (const uint32_t*)arr, (const int32_t*)n,
        bf_shift, sb, n_hashes, (VdRec<uint32_t>*)rec, (uint32_t*)slot,
        (uint8_t*)flags, (uint32_t*)cnt, (uint32_t*)sums, (uint8_t*)fp,
        (uint8_t*)keep, (cudaStream_t)stream);
}
