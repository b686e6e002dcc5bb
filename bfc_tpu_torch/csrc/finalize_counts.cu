// KK: table payloads, the keep set and the two histograms of the spectrum.
//
// Replaces bfc_tpu/ops/spectrum.py:finalize_counts_fp (:868).
//
// Bound: bytes.  18 bytes read and 5 written a row (23 B: 0.34 ms for the
// 3M-read main fold's 49.8M rows at 3.35 TB/s), so the kernel is a
// stream.  Its design (finalize.cuh, from kk_payload on):
//   - a grid of what the card holds at once, each warp taking tiles of
//     KK_TILE rows in turn, so a block's fixed costs (clearing its
//     sub-histograms, two syncs, the flush) are paid once a block and not
//     once every 256 rows;
//   - 16-byte loads and stores on every column where the columns'
//     alignment allows (kk_plan), and 288 bytes of loads in flight a lane
//     at the start of a tile;
//   - one sub-histogram a warp in shared memory for the block's whole
//     life, summed and added to the global int64 histograms at the end
//     with at most KK_BINS atomics a block: ~1,000 blocks on the card, not
//     one flush every 256 rows.
#include "finalize.cuh"

#include <cuda_runtime.h>

__global__ void __launch_bounds__(KK_THREADS)
kk_kernel(long long C, KkPlan plan, const int64_t* __restrict__ n,
          const int64_t* __restrict__ n_high,
          const uint8_t* __restrict__ first_high,
          const uint8_t* __restrict__ fp, int32_t* __restrict__ payload,
          uint8_t* __restrict__ keep, uint64_t* hist, uint64_t* hist_high) {
    __shared__ uint32_t sub[KK_WARPS][KK_BINS];
    __shared__ __align__(16) int32_t spl[KK_WARPS][KK_TILE];
    __shared__ __align__(16) uint8_t sfp[KK_WARPS][KK_TILE];
    __shared__ __align__(16) uint8_t sfh[KK_WARPS][KK_TILE];
    __shared__ __align__(16) uint8_t skp[KK_WARPS][KK_TILE];
    for (int b = threadIdx.x; b < KK_WARPS * KK_BINS; b += KK_THREADS)
        (&sub[0][0])[b] = 0;
    __syncthreads();
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long warps = (long long)gridDim.x * KK_WARPS;
    for (long long tile = (long long)blockIdx.x * KK_WARPS + w;
         tile < plan.tiles; tile += warps) {
        long long t = plan.head + tile * KK_TILE;
        kk_tile_stage(t, lane, first_high, fp, sfh[w], sfp[w]);
        __syncwarp();
        kk_tile_rows(t, lane, n, n_high, sfh[w], sfp[w], spl[w], skp[w],
                     sub[w]);
        __syncwarp();
        kk_tile_store(t, lane, spl[w], skp[w], payload, keep);
        __syncwarp();
    }
    const long long rest = C - plan.tiles * KK_TILE;
    for (long long j = (long long)blockIdx.x * KK_THREADS + threadIdx.x;
         j < rest; j += (long long)gridDim.x * KK_THREADS)
        kk_tally(sub[w], kk_row(kk_rest_row(plan, j), n, n_high, first_high,
                                fp, payload, keep));
    __syncthreads();
    for (int b = threadIdx.x; b < KK_BINS; b += KK_THREADS)
        kk_flush_bin(&sub[0][0], KK_WARPS, b, hist, hist_high);
}

// Blocks of the grid: enough for every tile's warp and every other row's
// thread, at most what the card holds at once.
static int kk_blocks(long long tiles, long long rest) {
    static int resident = 0;
    if (!resident) {
        int dev, sms, per_sm;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kk_kernel,
                                                      KK_THREADS, 0);
        resident = sms * (per_sm > 0 ? per_sm : 1);
    }
    long long need = (tiles + KK_WARPS - 1) / KK_WARPS;
    long long need_rest = (rest + KK_THREADS - 1) / KK_THREADS;
    if (need_rest > need) need = need_rest;
    return (int)(need < resident ? need : resident);
}

extern "C" int kk_launch(long long C, const void* n, const void* n_high,
                         const void* first_high, const void* fp,
                         void* payload, void* keep, void* hist,
                         void* hist_high, void* stream) {
    if (C > 0) {
        KkPlan plan = kk_plan(C, n, n_high, first_high, fp, payload, keep);
        kk_kernel<<<kk_blocks(plan.tiles, C - plan.tiles * KK_TILE),
                    KK_THREADS, 0, (cudaStream_t)stream>>>(
            C, plan, (const int64_t*)n, (const int64_t*)n_high,
            (const uint8_t*)first_high, (const uint8_t*)fp,
            (int32_t*)payload, (uint8_t*)keep, (uint64_t*)hist,
            (uint64_t*)hist_high);
    }
    return (int)cudaGetLastError();
}
