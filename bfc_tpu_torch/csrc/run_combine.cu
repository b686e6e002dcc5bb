// KB: combine equal keys of a sorted run into their head row and compact.
//
// Replaces bfc_tpu/ops/spectrum_dense.py:_combine_sorted (:103) with
// _seg_sum_to_head (:84) and bsort.compact_planes (:149), the tail of
// chunk_run (:128), merge_runs (:187) and merge_runs_sorted (:199).  The
// sort in front of it is torch.sort, as the JAX package left its sort to
// XLA's built-in lax.sort; the slot offsets between the two launches come
// from torch.cumsum of the head flags.  The TPU summed groups with a
// log2(N)-pass Hillis-Steele scan; here the head thread walks its group,
// which is 1-2 rows in a merge and short in a batch.
//
// Bound: bytes.  The head pass reads 16 bytes a row and writes 4; the
// combine reads each row once (~50 bytes) and writes each head once.
#include "run_combine.cuh"

#include <cuda_runtime.h>

__global__ void kb_head_kernel(const int64_t* shard, const int64_t* keybody,
                               long long N, int32_t* head) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < N) head[i] = kb_head(shard, keybody, i);
}

__global__ void kb_combine_kernel(
    long long N, const int32_t* head, const int64_t* cum,
    const int64_t* shard, const int64_t* keybody, const int64_t* arr,
    const int64_t* n, const int64_t* nh, const uint8_t* fh,
    const int64_t* ret, int64_t* o_shard, int64_t* o_keybody,
    int64_t* o_arr, int64_t* o_n, int64_t* o_nh, uint8_t* o_fh,
    int64_t* o_ret) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < N)
        kb_combine(i, N, head, cum, shard, keybody, arr, n, nh, fh, ret,
                   o_shard, o_keybody, o_arr, o_n, o_nh, o_fh, o_ret);
}

static int blocks_for(long long N, int threads) {
    return (int)((N + threads - 1) / threads);
}

extern "C" int kb_head_launch(const void* shard, const void* keybody,
                              long long N, void* head, void* stream) {
    if (N > 0)
        kb_head_kernel<<<blocks_for(N, 256), 256, 0, (cudaStream_t)stream>>>(
            (const int64_t*)shard, (const int64_t*)keybody, N,
            (int32_t*)head);
    return (int)cudaGetLastError();
}

extern "C" int kb_combine_launch(
    long long N, const void* head, const void* cum, const void* shard,
    const void* keybody, const void* arr, const void* n, const void* nh,
    const void* fh, const void* ret, void* o_shard, void* o_keybody,
    void* o_arr, void* o_n, void* o_nh, void* o_fh, void* o_ret,
    void* stream) {
    if (N > 0)
        kb_combine_kernel<<<blocks_for(N, 256), 256, 0,
                            (cudaStream_t)stream>>>(
            N, (const int32_t*)head, (const int64_t*)cum,
            (const int64_t*)shard, (const int64_t*)keybody,
            (const int64_t*)arr, (const int64_t*)n, (const int64_t*)nh,
            (const uint8_t*)fh, (const int64_t*)ret, (int64_t*)o_shard,
            (int64_t*)o_keybody, (int64_t*)o_arr, (int64_t*)o_n,
            (int64_t*)o_nh, (uint8_t*)o_fh, (int64_t*)o_ret);
    return (int)cudaGetLastError();
}
