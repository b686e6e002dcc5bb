// KM: a stable partition of rows by destination rank, written straight
// into the send buffers of a mesh exchange (route_rows.cuh).
//
// Replaces the bucketize that bfc_tpu builds from stable_order(dest) +
// searchsorted + bincount + scatter into fixed [n_dev, cap] buffers:
// parallel/mesh.py:sharded_chunk_aggregate (:120-144, the prefix rule) and
// sharded_adjudicate (:214-237, the Bloom-block rule), and
// ops/spectrum.py:sharded_cuckoo_lookup (:396-417).  The buffers here are
// exactly as long as the rows each rank receives (all_to_all_single takes
// uneven splits), so there is no capacity, no overflow and no retry.
//
// Two launches around an exclusive scan in the wrapper (torch.cumsum over
// the [R x tiles] counts):
//   km_count    one block a tile of KM_TILE rows; per-destination counts
//               in shared memory.
//   km_scatter  one block a tile, walking it in chunks of KM_THREADS rows;
//               in each warp __match_any_sync groups the lanes by
//               destination and __popc of the lower peers ranks them; the
//               warps' per-destination counts in shared memory order the
//               warps; a running base per destination orders the chunks.
//               So every row lands at its slot of a stable partition.
//
// Bound: bytes.  Each routed column is read once and written once, the
// destination key (shard or ret) is read in both passes, and the source
// index of each sent row is written (8 bytes) for the verdict's way back.
#include "route_rows.cuh"

#include <cuda_runtime.h>

#define KM_THREADS 256
#define KM_WARPS (KM_THREADS / 32)

__global__ void km_count_kernel(long long N, int rule, const int64_t* shard,
                                const int64_t* ret, int param, int R,
                                long long n_tiles, int64_t* cnt) {
    __shared__ unsigned int s_cnt[KM_MAX_RANKS];
    for (int d = threadIdx.x; d < R; d += KM_THREADS) s_cnt[d] = 0;
    __syncthreads();
    long long t = blockIdx.x;
    long long lo = t * KM_TILE, hi = lo + KM_TILE < N ? lo + KM_TILE : N;
    for (long long i = lo + threadIdx.x; i < hi; i += KM_THREADS) {
        int d = km_dest(rule, shard, ret, i, param, R);
        if (d < R) atomicAdd(&s_cnt[d], 1u);
    }
    __syncthreads();
    for (int d = threadIdx.x; d < R; d += KM_THREADS)
        cnt[(long long)d * n_tiles + t] = s_cnt[d];
}

__global__ void km_scatter_kernel(long long N, int rule, const int64_t* shard,
                                  const int64_t* ret, int param, int R,
                                  long long n_tiles, const int64_t* off,
                                  KmCols c, int64_t* perm) {
    __shared__ long long s_base[KM_MAX_RANKS];
    __shared__ int s_wc[KM_WARPS][KM_MAX_RANKS];
    int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    long long t = blockIdx.x;
    long long lo = t * KM_TILE, hi = lo + KM_TILE < N ? lo + KM_TILE : N;
    for (int d = tid; d < R; d += KM_THREADS) {
        s_base[d] = off[(long long)d * n_tiles + t];
        for (int v = 0; v < KM_WARPS; v++) s_wc[v][d] = 0;
    }
    __syncthreads();
    for (long long c0 = lo; c0 < hi; c0 += KM_THREADS) {
        long long i = c0 + tid;
        int d = i < hi ? km_dest(rule, shard, ret, i, param, R) : R;
        unsigned peers = __match_any_sync(0xffffffffu, d);
        int rank = __popc(peers & ((1u << lane) - 1u));
        if (d < R && rank == 0) s_wc[w][d] = __popc(peers);
        __syncthreads();
        if (d < R) {
            long long pos = s_base[d] + rank;
            for (int v = 0; v < w; v++) pos += s_wc[v][d];
            km_place(i, pos, c, perm);
        }
        __syncthreads();
        for (int e = tid; e < R; e += KM_THREADS) {
            long long s = 0;
            for (int v = 0; v < KM_WARPS; v++) {
                s += s_wc[v][e];
                s_wc[v][e] = 0;
            }
            s_base[e] += s;
        }
        __syncthreads();
    }
}

extern "C" int km_count_launch(long long N, int rule, const void* shard,
                               const void* ret, int param, int R,
                               long long n_tiles, void* cnt, void* stream) {
    if (R < 1 || R > KM_MAX_RANKS) return (int)cudaErrorInvalidValue;
    if (n_tiles > 0)
        km_count_kernel<<<(unsigned)n_tiles, KM_THREADS, 0,
                          (cudaStream_t)stream>>>(
            N, rule, (const int64_t*)shard, (const int64_t*)ret, param, R,
            n_tiles, (int64_t*)cnt);
    return (int)cudaGetLastError();
}

extern "C" int km_scatter_launch(
    long long N, int rule, const void* shard, const void* ret, int param,
    int R, long long n_tiles, const void* off, const void* in0,
    const void* in1, const void* in2, const void* in3, void* out0,
    void* out1, void* out2, void* out3, void* perm, void* stream) {
    if (R < 1 || R > KM_MAX_RANKS) return (int)cudaErrorInvalidValue;
    KmCols c = {{(const int64_t*)in0, (const int64_t*)in1,
                 (const int64_t*)in2, (const int64_t*)in3},
                {(int64_t*)out0, (int64_t*)out1, (int64_t*)out2,
                 (int64_t*)out3}};
    if (n_tiles > 0)
        km_scatter_kernel<<<(unsigned)n_tiles, KM_THREADS, 0,
                            (cudaStream_t)stream>>>(
            N, rule, (const int64_t*)shard, (const int64_t*)ret, param, R,
            n_tiles, (const int64_t*)off, c, (int64_t*)perm);
    return (int)cudaGetLastError();
}
