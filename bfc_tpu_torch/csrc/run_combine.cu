// KB: combine equal keys of a sorted run into their head row and compact,
// in one pass.
//
// Replaces bfc_tpu/ops/spectrum_dense.py:_combine_sorted (:103) with
// _seg_sum_to_head (:84) and bsort.compact_planes (:149), the tail of
// chunk_run (:128), merge_runs (:187) and merge_runs_sorted (:199).  The
// sort in front of it is torch.sort, as the JAX package left its sort to
// XLA's built-in lax.sort.  The TPU summed groups with a log2(N)-pass
// Hillis-Steele scan and compacted in further passes.
//
// Bound: bytes.  A row's key is read once for its head flag, its counts
// once by the fold of its group; a head's arrival, first_high and ret
// once, and each output once.  One launch does it all: a block takes the
// next tile of KB_TILE rows from a counter, flags its heads with warp
// ballots, scans the 64 (item, warp) counts in shared memory, and gets the
// heads before the tile by decoupled look-back over the tiles' status
// words (run_combine.cuh); then each head thread folds its group, which
// is 1-2 rows in a merge and short in a batch and may run into the next
// tile, into its compacted slot.  No head flag or offset array goes
// through device memory.  The last tile's prefix is the output size; the
// launcher copies it to pinned host memory, the one sync of a call.
#include "run_combine.cuh"

#include <cuda_runtime.h>

#define KB_THREADS 256
#define KB_ITEMS 8
#define KB_WARPS (KB_THREADS / 32)
#define KB_TILE (KB_THREADS * KB_ITEMS)

// status: n_tiles words, then the tile counter and the group count.
__global__ void __launch_bounds__(KB_THREADS)
kb_kernel(KbCols c, long long N, long long n_tiles, uint64_t* status) {
    __shared__ long long s_tile, s_excl;
    __shared__ int s_cnt[KB_ITEMS * KB_WARPS], s_off[KB_ITEMS * KB_WARPS];
    __shared__ int s_agg;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x == 0)
        s_tile = (long long)atomicAdd(
            (unsigned long long*)(status + n_tiles), 1ull);
    __syncthreads();
    const long long t = s_tile, base = t * KB_TILE;
    unsigned mask[KB_ITEMS];
#pragma unroll
    for (int j = 0; j < KB_ITEMS; j++) {
        long long i = base + j * KB_THREADS + warp * 32 + lane;
        int h = i < N ? kb_head(c.shard, c.keybody, i) : 0;
        mask[j] = __ballot_sync(0xffffffffu, h);
        if (lane == 0) s_cnt[j * KB_WARPS + warp] = __popc(mask[j]);
    }
    __syncthreads();
    if (warp == 0) {
        // the 64 counts in row order, two a lane
        int a = s_cnt[2 * lane], b = s_cnt[2 * lane + 1], v = a + b;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            int u = __shfl_up_sync(0xffffffffu, v, d);
            if (lane >= d) v += u;
        }
        int excl = v - a - b;
        s_off[2 * lane] = excl;
        s_off[2 * lane + 1] = excl + a;
        if (lane == 31) s_agg = v;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        long long excl = kb_publish(status, t, s_agg, 0);
        if (t == n_tiles - 1) status[n_tiles + 1] = excl + s_agg;
        s_excl = excl;
    }
    __syncthreads();
    const long long excl = s_excl;
    const unsigned below = (1u << lane) - 1;
#pragma unroll
    for (int j = 0; j < KB_ITEMS; j++) {
        if (!((mask[j] >> lane) & 1)) continue;
        long long i = base + j * KB_THREADS + warp * 32 + lane;
        kb_fold(c, N, i,
                excl + s_off[j * KB_WARPS + warp] + __popc(mask[j] & below));
    }
}

// Rows a tile, for sizing status (n_tiles + 2 words).
extern "C" int kb_tile_rows(long long* rows) {
    *rows = KB_TILE;
    return 0;
}

// N >= 1 rows; outputs sized for N; *count_host (pinned) receives the
// number of groups C when the stream reaches it.
extern "C" int kb_launch(long long N, const void* shard, const void* keybody,
                         const void* arr, const void* n, const void* nh,
                         const void* fh, const void* ret, void* o_shard,
                         void* o_keybody, void* o_arr, void* o_n, void* o_nh,
                         void* o_fh, void* o_ret, void* status,
                         void* count_host, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    long long n_tiles = (N + KB_TILE - 1) / KB_TILE;
    KbCols c = {(const int64_t*)shard, (const int64_t*)keybody,
                (const int64_t*)arr, (const int64_t*)n, (const int64_t*)nh,
                (const uint8_t*)fh, (const int64_t*)ret, (int64_t*)o_shard,
                (int64_t*)o_keybody, (int64_t*)o_arr, (int64_t*)o_n,
                (int64_t*)o_nh, (uint8_t*)o_fh, (int64_t*)o_ret};
    uint64_t* st = (uint64_t*)status;
    cudaMemsetAsync(st, 0, (n_tiles + 2) * sizeof(uint64_t), s);
    kb_kernel<<<(unsigned)n_tiles, KB_THREADS, 0, s>>>(c, N, n_tiles, st);
    cudaMemcpyAsync(count_host, st + n_tiles + 1, sizeof(int64_t),
                    cudaMemcpyDeviceToHost, s);
    return (int)cudaGetLastError();
}
