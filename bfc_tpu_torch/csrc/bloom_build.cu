// KG: the trim mode's Bloom filter of repeated k-mers.
//
// Replaces bfc_tpu/models/trimmer.py:_bloom_build (:49) with the probe
// addressing of spectrum.py:bloom_probe_bits (:184).  The TPU sorted the
// probed bit ids to dedupe them, so a scatter-add could act as an OR; the
// card has atomicOr, which is order-free, so each kept row ORs its bits
// straight into the zeroed u32 words (2^(bf_shift-5) of them, 1 GiB at
// -b33).  One thread a row over all rows of the aggregate, skipping rows
// that are not kept: that reads a 1-byte flag a row instead of
// compacting the kept rows first.
//
// Bound: bytes.  Zeroing writes 2^(bf_shift-3) bytes; each row reads 9
// bytes, and each kept row touches one random 64-byte block.
#include "bloom.cuh"

#include <cuda_runtime.h>

__global__ void kg_kernel(long long C, const int64_t* ret,
                          const uint8_t* keep, int bf_shift, int n_hashes,
                          uint32_t* words) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < C) kg_row(i, ret, keep, bf_shift, n_hashes, words);
}

extern "C" int kg_launch(long long C, const void* ret, const void* keep,
                         int bf_shift, int n_hashes, void* words,
                         void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = cudaMemsetAsync(words, 0, (size_t)1 << (bf_shift - 3), s);
    if (e != cudaSuccess) return (int)e;
    int threads = 256;
    if (C > 0)
        kg_kernel<<<(int)((C + threads - 1) / threads), threads, 0, s>>>(
            C, (const int64_t*)ret, (const uint8_t*)keep, bf_shift, n_hashes,
            (uint32_t*)words);
    return (int)cudaGetLastError();
}
