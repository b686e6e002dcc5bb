// KJ: the Bloom-addressing hash of each row of a run that does not carry it.
//
// Replaces bfc_tpu/ops/spectrum_dense.py:run_to_aggregate (:312) and its
// derive_ret_device (:293): the device finalize needs ret for every row,
// and a run carries it only where the identity cannot give it back.  One
// thread a row inverts the identity in u64 registers (finalize.cuh:kj_row).
//
// Bound: bytes.  16 bytes read and 8 written a row, ~15 u64 ops.
#include "finalize.cuh"

#include <cuda_runtime.h>

__global__ void kj_kernel(long long C, const int64_t* shard,
                          const int64_t* keybody, int k, int l_pre,
                          int64_t* ret) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < C) kj_row(i, shard, keybody, k, l_pre, ret);
}

extern "C" int kj_launch(long long C, const void* shard, const void* keybody,
                         int k, int l_pre, void* ret, void* stream) {
    if (C > 0)
        kj_kernel<<<(int)((C + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
            C, (const int64_t*)shard, (const int64_t*)keybody, k, l_pre,
            (int64_t*)ret);
    return (int)cudaGetLastError();
}
