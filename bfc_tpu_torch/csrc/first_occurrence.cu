// KI: exact first-occurrence Bloom verdicts at any arrival width.
//
// Replaces bfc_tpu/ops/spectrum.py:adjudicate_first_occurrence (:217) and
// its _forward_fill (:249), the sort verdict bfc_tpu takes once arrivals
// pass 2^32 (finalize_spectrum, counter.py:756-765; trimmer.py:88-91).
// The TPU sorted all C * n_hashes (bit, arrival) probes and filled each
// bit group's first arrival forward.  The verdict needs no order but
// arrival within a Bloom block, so here the rows are grouped by block
// (superblocks, then blocks in shared memory) and each block is judged in
// shared memory (csrc/verdict.cuh, u64 arrivals): no sort, no C * n_hashes
// temporary, 21 bytes a row and 4 bytes a superblock of scratch.  KF is
// the same design on u32 arrivals.
//
// Bound: bytes.  ret and arr read once, fp written once: 17 bytes a row.
// The design moves more: ret twice, a 16-byte record written to a slot of
// its superblock's segment and read back, two atomics a row on the
// superblock histogram, a slot and a verdict byte a row written and read
// back, the latter at random.  The per-bit minimum of u64 arrivals takes
// 4 KiB of shared memory a block in flight, twice KF's.
#include "verdict.cuh"

extern "C" int ki_launch(long long C, const void* ret, const void* arr,
                         int bf_shift, int sb, int n_hashes, void* rec,
                         void* slot, void* flags, void* cnt, void* sums,
                         void* fp, void* stream) {
    return vd_launch<uint64_t>(
        C, (const int64_t*)ret, (const uint64_t*)arr, nullptr, bf_shift, sb,
        n_hashes, (VdRec<uint64_t>*)rec, (uint32_t*)slot, (uint8_t*)flags,
        (uint32_t*)cnt, (uint32_t*)sums, (uint8_t*)fp, nullptr,
        (cudaStream_t)stream);
}
