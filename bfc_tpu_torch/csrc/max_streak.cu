// KH: each read's longest run of k-mers present in the trim Bloom filter.
//
// Replaces bfc_tpu/models/trimmer.py:max_streak_batch (:136) with its
// query _bloom_query (:71).  The TPU built every position's planes and
// hash at once and found the run with an associative max-scan over
// [B, L]; here one thread rolls one read, as the reference's max_streak
// does (correct.c:478-497), with no limit on the read length.
//
// Bound: bytes.  Each k-mer end costs one random 64-byte Bloom block (all
// of its probed bits share one 512-bit block) against one streamed base;
// the hash is ~60 integer ops, below the card's integer rate.  The
// per-thread reads of the base rows are strided, as in KA and KC.
#include "bloom.cuh"

#include <cuda_runtime.h>

__global__ void kh_kernel(const uint8_t* bases, const int32_t* lens, int B,
                          int L, int k, const uint32_t* words, int bf_shift,
                          int n_hashes, int64_t* out) {
    int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= B) return;
    out[r] = kh_read(bases + (size_t)r * L, lens[r], k, words, bf_shift,
                     n_hashes);
}

extern "C" int kh_launch(const void* bases, const void* lens, int B, int L,
                         int k, const void* words, int bf_shift, int n_hashes,
                         void* out, void* stream) {
    int threads = 128;
    int blocks = (B + threads - 1) / threads;
    if (blocks > 0)
        kh_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)bases, (const int32_t*)lens, B, L, k,
            (const uint32_t*)words, bf_shift, n_hashes, (int64_t*)out);
    return (int)cudaGetLastError();
}
