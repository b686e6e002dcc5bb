// KI: exact first-occurrence Bloom verdicts at any arrival width.
//
// Replaces bfc_tpu/ops/spectrum.py:adjudicate_first_occurrence (:217) and
// its _forward_fill (:249), the sort verdict bfc_tpu takes once arrivals
// pass 2^32 (finalize_spectrum, counter.py:756-765; trimmer.py:88-91).
// The TPU sorted all C * n_hashes (bit, arrival) probes.  Here the rows are
// sorted by (Bloom block, arrival) instead, with two stable torch.sort
// passes in the wrapper (ops/spectrum.py), and each block is replayed by
// one thread over its 512 bits in shared memory (finalize.cuh:ki_block):
// no C * n_hashes temporary and no 2^bf_shift scratch, unlike KF.
//
// Bound: bytes.  Each row's ret and arrival are read once and fp written
// once; each row's ret is a random 8-byte read through the permutation.
// Blocks hold a few rows each at -b30 and -b33, so one thread a block is
// enough parallelism; a hot block (thousands of rows at -b20) serialises on
// its thread but stays correct.
#include "finalize.cuh"

#include <cuda_runtime.h>

#define KI_THREADS 128
#define KI_STRIDE 17  // words per thread's bitmap: 16, padded off a bank

__global__ void ki_kernel(long long n_blocks, const int64_t* starts,
                          const int64_t* perm, const int64_t* ret,
                          const int64_t* arr, int bf_shift, int n_hashes,
                          uint8_t* fp) {
    __shared__ uint32_t bm[KI_THREADS * KI_STRIDE];
    long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (s < n_blocks)
        ki_block(starts[s], starts[s + 1], perm, ret, arr, bf_shift,
                 n_hashes, bm + threadIdx.x * KI_STRIDE, fp);
}

extern "C" int ki_launch(long long n_blocks, const void* starts,
                         const void* perm, const void* ret, const void* arr,
                         int bf_shift, int n_hashes, void* fp, void* stream) {
    if (n_blocks > 0)
        ki_kernel<<<(int)((n_blocks + KI_THREADS - 1) / KI_THREADS),
                    KI_THREADS, 0, (cudaStream_t)stream>>>(
            n_blocks, (const int64_t*)starts, (const int64_t*)perm,
            (const int64_t*)ret, (const int64_t*)arr, bf_shift, n_hashes,
            (uint8_t*)fp);
    return (int)cudaGetLastError();
}
