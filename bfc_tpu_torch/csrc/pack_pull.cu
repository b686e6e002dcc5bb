// KE: pack a run's payload for the pull to the host.
//
// Replaces bfc_tpu/ops/spectrum_dense.py:pack_pull (:233).  The arrival's
// high bits, n (saturated at 511), n_high (saturated at 127) and
// first_high fold into one 32-bit plane next to the arrival's low 32 bits,
// so a row crosses to the host in 24 bytes (32 with ret) instead of 41
// (49).  The saturation points lie above every payload cap (count 255,
// high 63), so the finalized table is bit-identical; arr_hi must fit 15
// bits (arrivals below 2^47, which the caller checks).
//
// Bound: bytes.  One thread a row reads 25 bytes and writes 8, coalesced.
#include "bloom.cuh"

#include <cuda_runtime.h>

__global__ void ke_kernel(long long C, const int64_t* arr, const int64_t* n,
                          const int64_t* nh, const uint8_t* fh, int32_t* a_lo,
                          int32_t* nfh) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < C) ke_row(i, arr, n, nh, fh, a_lo, nfh);
}

extern "C" int ke_launch(long long C, const void* arr, const void* n,
                         const void* nh, const void* fh, void* a_lo,
                         void* nfh, void* stream) {
    int threads = 256;
    if (C > 0)
        ke_kernel<<<(int)((C + threads - 1) / threads), threads, 0,
                    (cudaStream_t)stream>>>(
            C, (const int64_t*)arr, (const int64_t*)n, (const int64_t*)nh,
            (const uint8_t*)fh, (int32_t*)a_lo, (int32_t*)nfh);
    return (int)cudaGetLastError();
}
