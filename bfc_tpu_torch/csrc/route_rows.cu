// KM: a stable partition of rows by destination rank, written straight
// into the send buffers of a mesh exchange (route_rows.cuh).
//
// Replaces the bucketize that bfc_tpu builds from stable_order(dest) +
// searchsorted + bincount + scatter into fixed [n_dev, cap] buffers:
// parallel/mesh.py:sharded_chunk_aggregate (:120-144, the prefix rule) and
// sharded_adjudicate (:214-237, the Bloom-block rule), and
// ops/spectrum.py:sharded_cuckoo_lookup (:396-417).  all_to_all_single
// takes uneven splits, so there is no capacity, no overflow and no retry.
//
// Bound: bytes.  Each routed column is read once and each sent row
// written once, the destination key (shard or ret) is read in both
// passes, and the source index of each sent row is written (8 bytes) for
// the verdict's way back.  But the exchange needs the counts on the host,
// and in the first design the host waited for the count pass, scanned
// with torch.cumsum, summed, allocated and only then launched the
// scatter, so the card idled around every call.  Here the host waits
// once, on an event behind the count and scan, with the scatter already
// enqueued:
//   km_count    one block a tile: per-destination counts in shared
//               memory, written to the [R x tiles] counts and added to
//               the R totals.
//   km_scan     one block a destination: its tiles' counts become, in
//               place, the output slot of its first row in each tile (the
//               totals of the destinations before it, plus its rows in the
//               tiles before).  The launcher copies the totals to pinned
//               host memory behind it.
//   km_scatter  one block a tile: each warp ranks its KM_WARP_ROWS
//               contiguous rows chunk by chunk (__match_any_sync, and a
//               running count a destination in shared memory), one scan
//               over (warp, destination) places every row in its
//               destination's segment of the tile, and the tile's 16-bit
//               row indices are staged in that order.  Then a column at a
//               time: the tile's column is loaded coalesced into shared
//               memory, and consecutive threads store consecutive output
//               slots, each value read back through the staged index;
//               perm likewise.  Six __syncthreads a tile and two a
//               column, none a chunk.
// Both passes load all of a thread's rows before they use any, so a warp
// has its chunks' loads in flight at once, and a power-of-two R takes the
// destination by a mask, not a division.  The wrapper allocates the
// outputs at N rows before either launch and returns their leading rows,
// so nothing waits on the counts but the host.
#include "route_rows.cuh"

#include <cuda_runtime.h>

// The scatter's blocks an SM: as many as its 47 KB of shared memory
// allow, with registers capped to fit them.
#define KM_SCATTER_BLOCKS 3

static_assert(KM_MAX_RANKS <= KM_THREADS, "a thread a destination");
static_assert(KM_MAX_RANKS <= 256, "destinations staged as bytes");
static_assert(KM_WARP_ROWS <= 0xFFFF, "ranks packed in 16 bits");
static_assert(KM_WARPS * KM_MAX_RANKS * sizeof(int) <=
                  KM_TILE * sizeof(int64_t),
              "the per-warp counts fit in the column buffer");

// Exclusive scan of v over the block; *total receives the sum.
template <typename T>
__device__ T km_block_scan(T v, T* s_warp, T* total) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    T x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        T u = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += u;
    }
    if (lane == 31) s_warp[w] = x;
    __syncthreads();
    T before = 0, all = 0;
#pragma unroll
    for (int i = 0; i < KM_WARPS; i++) {
        T s = s_warp[i];
        before += i < w ? s : 0;
        all += s;
    }
    __syncthreads();
    *total = all;
    return before + x - v;
}

// totals: R int64, zeroed.
__global__ void __launch_bounds__(KM_THREADS)
km_count_kernel(long long N, int rule, const int64_t* shard,
                const int64_t* ret, int param, int R, long long n_tiles,
                int64_t* off, int64_t* totals) {
    __shared__ unsigned s_cnt[KM_MAX_RANKS];
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const long long t = blockIdx.x;
    for (int d = tid; d < R; d += KM_THREADS) s_cnt[d] = 0;
    // the warp's chunk loads in flight at once
    int dc[KM_CHUNKS];
#pragma unroll
    for (int c = 0; c < KM_CHUNKS; c++)
        dc[c] = km_dest_at(rule, shard, ret, km_row(t, w, c, lane), N, param,
                           R);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < KM_CHUNKS; c++)
        if (dc[c] < R) atomicAdd(&s_cnt[dc[c]], 1u);
    __syncthreads();
    for (int d = tid; d < R; d += KM_THREADS) {
        off[(long long)d * n_tiles + t] = s_cnt[d];
        if (s_cnt[d])
            atomicAdd((unsigned long long*)(totals + d),
                      (unsigned long long)s_cnt[d]);
    }
}

// Block d: destination d's tile counts, in place, into the slot of its
// first row in each tile.
__global__ void __launch_bounds__(KM_THREADS)
km_scan_kernel(int R, long long n_tiles, int64_t* off,
               const int64_t* totals) {
    __shared__ int64_t s_warp[KM_WARPS];
    const int tid = threadIdx.x, d = blockIdx.x;
    int64_t before = 0, lo, hi, base;
    for (int e = tid; e < d; e += KM_THREADS) before += totals[e];
    km_block_scan<int64_t>(before, s_warp, &base);  // the rows before d's
    int64_t* cnt = off + (long long)d * n_tiles;
    km_scan_part(n_tiles, tid, &lo, &hi);
    int64_t sum;
    int64_t excl = km_block_scan<int64_t>(km_part_sum(cnt, lo, hi), s_warp,
                                          &sum);
    km_part_write(cnt, lo, hi, base + excl);
}

__global__ void __launch_bounds__(KM_THREADS, KM_SCATTER_BLOCKS)
km_scatter_kernel(long long N, int rule, const int64_t* shard,
                  const int64_t* ret, int param, int R, long long n_tiles,
                  const int64_t* off, KmCols c, int64_t* perm) {
    // the per-warp counts, then (after staging) one column of the tile
    __shared__ int64_t s_col[KM_TILE];
    int* s_wc = (int*)s_col;
    __shared__ int s_seg[KM_MAX_RANKS];
    __shared__ int64_t s_base[KM_MAX_RANKS];
    __shared__ uint16_t s_row[KM_TILE];
    __shared__ uint8_t s_dst[KM_TILE];
    __shared__ int s_warp[KM_WARPS];
    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const long long t = blockIdx.x;
    for (int e = tid; e < KM_WARPS * KM_MAX_RANKS; e += KM_THREADS)
        s_wc[e] = 0;
    // each row's destination (the warp's chunk loads in flight at once),
    // then its rank among its warp's earlier rows of it
    int v[KM_CHUNKS];
#pragma unroll
    for (int ch = 0; ch < KM_CHUNKS; ch++)
        v[ch] = km_dest_at(rule, shard, ret, km_row(t, w, ch, lane), N,
                           param, R);
    __syncthreads();
    int* wc = s_wc + w * KM_MAX_RANKS;
    const unsigned below = (1u << lane) - 1;
#pragma unroll
    for (int ch = 0; ch < KM_CHUNKS; ch++) {
        int d = v[ch];
        unsigned peers = __match_any_sync(0xffffffffu, d);
        int before = d < R ? wc[d] : 0;
        __syncwarp();
        if (d < R && lane == __ffs(peers) - 1)
            wc[d] = before + __popc(peers);
        __syncwarp();
        v[ch] = km_pack(d, before + __popc(peers & below));
    }
    __syncthreads();
    // thread d: the warps' bases in destination d's segment, its tile
    // total, and the segment's start in the tile by a scan over d
    int tot = tid < R ? km_warp_bases(s_wc, tid) : 0;
    int n_keep;
    int seg = km_block_scan<int>(tot, s_warp, &n_keep);
    if (tid < R) {
        s_seg[tid] = seg;
        s_base[tid] = off[(long long)tid * n_tiles + t] - seg;
    }
    __syncthreads();
    // stage: the tile's rows grouped by destination, in row order
#pragma unroll
    for (int ch = 0; ch < KM_CHUNKS; ch++) {
        int d = km_pack_dest(v[ch]);
        if (d < R) {
            int pos = s_seg[d] + wc[d] + km_pack_rank(v[ch]);
            s_row[pos] = (uint16_t)km_tile_row(w, ch, lane);
            s_dst[pos] = (uint8_t)d;
        }
    }
    __syncthreads();
    // write a column at a time: the tile's column loaded coalesced into
    // shared memory, then consecutive threads on consecutive output slots,
    // each value read back through the staged row index
    const int64_t lo = t * KM_TILE;
    const int rows = N - lo < KM_TILE ? (int)(N - lo) : KM_TILE;
    for (int j = 0; j < KM_COLS; j++) {
        if (!c.in[j]) continue;
        int64_t x[KM_TILE / KM_THREADS];
#pragma unroll
        for (int u = 0; u < KM_TILE / KM_THREADS; u++) {
            int e = u * KM_THREADS + tid;
            x[u] = e < rows ? c.in[j][lo + e] : 0;
        }
        __syncthreads();  // the column before is written
#pragma unroll
        for (int u = 0; u < KM_TILE / KM_THREADS; u++)
            s_col[u * KM_THREADS + tid] = x[u];
        __syncthreads();
        for (int s = tid; s < n_keep; s += KM_THREADS)
            c.out[j][km_slot_pos(s, s_dst, s_base)] = s_col[s_row[s]];
    }
    for (int s = tid; s < n_keep; s += KM_THREADS)
        perm[km_slot_pos(s, s_dst, s_base)] = km_slot_row(t, s, s_row);
}

// N >= 1 rows in n_tiles = ceil(N / KM_TILE) tiles.  off: R * n_tiles
// int64 (each tile's counts); totals: R int64, zeroed here.
extern "C" int km_count_launch(long long N, int rule, const void* shard,
                               const void* ret, int param, int R,
                               long long n_tiles, void* off, void* totals,
                               void* stream) {
    if (R < 1 || R > KM_MAX_RANKS || N < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaMemsetAsync(totals, 0, (size_t)R * sizeof(int64_t), s);
    km_count_kernel<<<(unsigned)n_tiles, KM_THREADS, 0, s>>>(
        N, rule, (const int64_t*)shard, (const int64_t*)ret, param, R,
        n_tiles, (int64_t*)off, (int64_t*)totals);
    return (int)cudaGetLastError();
}

// off and totals as km_count left them: off becomes the output slot of
// each (destination, tile)'s first row; counts_host, R int64 of pinned
// host memory, receives the totals when the stream reaches them.
extern "C" int km_scan_launch(int R, long long n_tiles, void* off,
                              const void* totals, void* counts_host,
                              void* stream) {
    if (R < 1 || R > KM_MAX_RANKS || n_tiles < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    km_scan_kernel<<<R, KM_THREADS, 0, s>>>(R, n_tiles, (int64_t*)off,
                                            (const int64_t*)totals);
    cudaMemcpyAsync(counts_host, totals, (size_t)R * sizeof(int64_t),
                    cudaMemcpyDeviceToHost, s);
    return (int)cudaGetLastError();
}

// off as km_scan left it; each present output column and perm hold N
// rows, of which the leading sum(totals) are written.
extern "C" int km_scatter_launch(
    long long N, int rule, const void* shard, const void* ret, int param,
    int R, long long n_tiles, const void* off, const void* in0,
    const void* in1, const void* in2, const void* in3, void* out0,
    void* out1, void* out2, void* out3, void* perm, void* stream) {
    if (R < 1 || R > KM_MAX_RANKS || N < 1) return (int)cudaErrorInvalidValue;
    KmCols c = {{(const int64_t*)in0, (const int64_t*)in1,
                 (const int64_t*)in2, (const int64_t*)in3},
                {(int64_t*)out0, (int64_t*)out1, (int64_t*)out2,
                 (int64_t*)out3}};
    km_scatter_kernel<<<(unsigned)n_tiles, KM_THREADS, 0,
                        (cudaStream_t)stream>>>(
        N, rule, (const int64_t*)shard, (const int64_t*)ret, param, R,
        n_tiles, (const int64_t*)off, c, (int64_t*)perm);
    return (int)cudaGetLastError();
}
