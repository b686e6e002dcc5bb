// KF: first-occurrence Bloom verdicts and the bf_high keep set.
//
// Replaces bfc_tpu/ops/spectrum.py:adjudicate_sketch (:843) with the keep
// rule of bfc_tpu/models/trimmer.py:filter_keep_rets (:81).  The reference
// inserts every k-mer occurrence into a Bloom filter in stream order and
// counts an occurrence once its bits were all set before it (count.c:
// 71-87); for a distinct k-mer only its first occurrence can differ, and
// it found its bits set exactly when, at every probed bit, some other
// k-mer's first arrival came earlier.  One launch zeroes a u32 scratch of
// 2^bf_shift entries and scatters ~arrival with atomicMax (the maximum of
// inverted arrivals is the earliest arrival); a second reads it back.
// Bit ids are 64-bit: bfc_tpu casts them to u32 (spectrum.py:856), which
// aliases bits at bf_shift >= 33.  Arrivals must fit 32 bits (checked by
// the caller).
//
// Bound: bytes.  Zeroing the scratch writes 4 * 2^bf_shift bytes (32 GiB
// at the default -b33), against ~18 bytes a row and two random 64-byte
// blocks a row (all of a row's bits share one 512-bit Bloom block).  The
// memset runs at the card's fill rate; the row passes are one thread a
// row and their atomics scatter.
#include "bloom.cuh"

#include <cuda_runtime.h>

__global__ void kf_scatter_kernel(long long C, const int64_t* ret,
                                  const int32_t* arr, int bf_shift,
                                  int n_hashes, uint32_t* dense) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < C) kf_scatter_row(i, ret, arr, bf_shift, n_hashes, dense);
}

__global__ void kf_verdict_kernel(long long C, const int64_t* ret,
                                  const int32_t* arr, const int32_t* n,
                                  int bf_shift, int n_hashes,
                                  const uint32_t* dense, uint8_t* fp,
                                  uint8_t* keep) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < C)
        kf_verdict_row(i, ret, arr, n, bf_shift, n_hashes, dense, fp, keep);
}

extern "C" int kf_launch(long long C, const void* ret, const void* arr,
                         const void* n, int bf_shift, int n_hashes,
                         void* dense, void* fp, void* keep, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = cudaMemsetAsync(dense, 0, (size_t)4 << bf_shift, s);
    if (e != cudaSuccess) return (int)e;
    int threads = 256;
    int blocks = (int)((C + threads - 1) / threads);
    if (C > 0) {
        kf_scatter_kernel<<<blocks, threads, 0, s>>>(
            C, (const int64_t*)ret, (const int32_t*)arr, bf_shift, n_hashes,
            (uint32_t*)dense);
        kf_verdict_kernel<<<blocks, threads, 0, s>>>(
            C, (const int64_t*)ret, (const int32_t*)arr, (const int32_t*)n,
            bf_shift, n_hashes, (const uint32_t*)dense, (uint8_t*)fp,
            (uint8_t*)keep);
    }
    return (int)cudaGetLastError();
}
