// KK: table payloads, the keep set and the two histograms of the spectrum.
//
// Replaces bfc_tpu/ops/spectrum.py:finalize_counts_fp (:868).  One thread a
// row applies the payload rule (finalize.cuh:kk_row); each block counts its
// kept rows' count and high bins in shared memory and adds them to the
// global int64 histograms with one atomic add a non-empty bin, so the 256
// and 64 hot global bins see ~C / 256 atomics instead of 2 C.  Integer
// sums are order-free: the histograms are exact.
//
// Bound: bytes.  18 bytes read and 5 written a row.
#include "finalize.cuh"

#include <cuda_runtime.h>

__global__ void kk_kernel(long long C, const int64_t* n,
                          const int64_t* n_high, const uint8_t* first_high,
                          const uint8_t* fp, int32_t* payload, uint8_t* keep,
                          unsigned long long* hist,
                          unsigned long long* hist_high) {
    __shared__ unsigned int h[256 + 64];
    for (int b = threadIdx.x; b < 256 + 64; b += blockDim.x) h[b] = 0;
    __syncthreads();
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < C) {
        int32_t p = kk_row(i, n, n_high, first_high, fp, payload, keep);
        if (p) {
            atomicAdd(h + (p & 255), 1u);
            atomicAdd(h + 256 + (p >> 8), 1u);
        }
    }
    __syncthreads();
    for (int b = threadIdx.x; b < 256 + 64; b += blockDim.x)
        if (h[b])
            atomicAdd(b < 256 ? hist + b : hist_high + (b - 256),
                      (unsigned long long)h[b]);
}

extern "C" int kk_launch(long long C, const void* n, const void* n_high,
                         const void* first_high, const void* fp,
                         void* payload, void* keep, void* hist,
                         void* hist_high, void* stream) {
    if (C > 0)
        kk_kernel<<<(int)((C + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
            C, (const int64_t*)n, (const int64_t*)n_high,
            (const uint8_t*)first_high, (const uint8_t*)fp,
            (int32_t*)payload, (uint8_t*)keep, (unsigned long long*)hist,
            (unsigned long long*)hist_high);
    return (int)cudaGetLastError();
}
