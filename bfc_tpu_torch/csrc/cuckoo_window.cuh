// The kernels of KL's and KN's window build, and ck_launch, which
// enqueues them (nvcc only; csrc/cuckoo_build.cu and
// csrc/cuckoo_build_local.cu bind it).  The steps and the bodies they run
// are in cuckoo.cuh, where csrc/host_shim.cpp runs the same steps on the
// CPU.  ck_launch first clears the counters (a memset of them, never of
// the table), then:
//
//   ck_count     a block a chunk of rows, four rows a thread: each
//                row's window, counted a run of equal windows at a time
//                (a warp's ballot) into cursor; the flag where a row's
//                window is below the row before it; and the starts of the
//                windows a row is the first to reach (cuckoo.cuh:
//                ck_reach), which are every start where the rows are in
//                order and no gap is too wide.
//   ck_scan      returns at once unless the flag or the gap flag is up;
//                then one block turns the counts into start and cursor.
//   ck_scatter   returns at once unless the flag is up; then each row's
//                index goes to its window's next record (a warp's rows of
//                one window take one atomic).
//   ck_build     a block a window: the window cleared in shared memory,
//                its rows loaded four a thread, each key's entry placed
//                at its first slot with a shared-memory CAS, or recorded
//                for the overflow; then the window stored to the table
//                with coalesced 16-byte stores.  The table is written
//                once, by this pass, and never cleared.
//   ck_overflow  a block a window: each overflow record runs
//                ck_insert from its second slot into the finished
//                table; a chain that fails adds to the failure count.
//                These exchanges are random 8-byte writes into a table
//                larger than L2, so their rate, not the bytes, sets this
//                kernel's time.
#pragma once
#include "cuckoo.cuh"

#include <cuda_runtime.h>

#define CK_THREADS 512      // the count's and the scatter's blocks
#define CK_WARPS (CK_THREADS / 32)
#define CK_COUNT_ROWS 4     // rows a count thread
#define CK_SCATTER_BLOCKS 1024
#define CK_OVERFLOW_THREADS 128

// Exclusive scan of v over a CK_THREADS block; *total receives the sum.
__device__ int64_t ck_block_scan(int64_t v, int64_t* s_warp,
                                 int64_t* total) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    int64_t x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        int64_t u = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += u;
    }
    if (lane == 31) s_warp[w] = x;
    __syncthreads();
    int64_t before = 0, all = 0;
#pragma unroll
    for (int i = 0; i < CK_WARPS; i++) {
        int64_t s = s_warp[i];
        before += i < w ? s : 0;
        all += s;
    }
    __syncthreads();
    *total = all;
    return before + x - v;
}

// meta zeroed.  A block a chunk of CK_THREADS * CK_COUNT_ROWS rows, a
// warp CK_COUNT_ROWS runs of 32 consecutive rows of it.  Each row's
// window is compared with the row before it (a shuffle; the warp's first
// row's predecessor is loaded with the rest), and each run of equal
// windows among a warp's 32 rows adds its length with one atomic: one or
// two a warp where the rows are in order.
__global__ void __launch_bounds__(CK_THREADS)
ck_count_kernel(long long n, const int64_t* shard, const int64_t* keybody,
                CkGeom g, int64_t* meta) {
    const int wb = ck_win_bits(g, CK_WIN_BITS);
    const int64_t nw = ck_windows(g, CK_WIN_BITS);
    const CkMeta m = ck_meta(meta, nw);
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const long long first = (long long)blockIdx.x * CK_THREADS *
                            CK_COUNT_ROWS + (long long)w * CK_COUNT_ROWS * 32;
    // the warp's loads in flight at once, its first row's predecessor
    // with them
    uint64_t win[CK_COUNT_ROWS], before = 0;
#pragma unroll
    for (int c = 0; c < CK_COUNT_ROWS; c++) {
        long long i = first + c * 32 + lane;
        win[c] = i < n ? ck_slot(g, shard[i], keybody[i]) >> wb : ~0ull;
    }
    if (lane == 0 && first > 0 && first < n)
        before = ck_slot(g, shard[first - 1], keybody[first - 1]) >> wb;
    int down = 0;
#pragma unroll
    for (int c = 0; c < CK_COUNT_ROWS; c++) {
        long long i = first + c * 32 + lane;
        // the row before lane 0's: lane 31's of the run before
        uint64_t carry = before;
        if (c) carry = __shfl_sync(0xffffffffu, win[c > 0 ? c - 1 : 0], 31);
        uint64_t prev = __shfl_up_sync(0xffffffffu, win[c], 1);
        if (lane == 0) prev = carry;
        bool head = i < n && (lane == 0 || win[c] != prev);
        down |= i > 0 && i < n && win[c] < prev;
        if (i < n) ck_reach(m, nw, i, n, prev, win[c]);
        unsigned heads = __ballot_sync(0xffffffffu, head);
        unsigned live = __ballot_sync(0xffffffffu, i < n);
        if (head) {
            unsigned after = heads & ~((2u << lane) - 1);  // later heads
            int end = after ? __ffs(after) - 1 : 32 - __clz(live);
            atomicAdd((unsigned long long*)(m.cursor + win[c]),
                      (unsigned long long)(end - lane));
        }
    }
    if (__syncthreads_or(down) && tid == 0) m.hdr[CK_FLAG] = 1;
}

// One block, and only where the count could not give the starts (the
// rows out of window order, or a gap): the windows' counts become start
// and cursor (eight loads in flight a thread), and start[nw] the number
// of rows.
__global__ void __launch_bounds__(CK_THREADS)
ck_scan_kernel(CkGeom g, int64_t* meta) {
    __shared__ int64_t s_warp[CK_WARPS];
    const int64_t nw = ck_windows(g, CK_WIN_BITS);
    const CkMeta m = ck_meta(meta, nw);
    if (!m.hdr[CK_FLAG] && !m.hdr[CK_GAPS]) return;
    int64_t lo, hi, sum = 0, total;
    ck_scan_part(nw, threadIdx.x, CK_THREADS, &lo, &hi);
    for (int64_t a = lo; a < hi; a += 8) {
        int64_t c[8];
#pragma unroll
        for (int u = 0; u < 8; u++) c[u] = a + u < hi ? m.cursor[a + u] : 0;
#pragma unroll
        for (int u = 0; u < 8; u++) sum += c[u];
    }
    int64_t first = ck_block_scan(sum, s_warp, &total);
    ck_scan_write(m, lo, hi, first);
    if (threadIdx.x == 0) m.start[nw] = total;
}

__global__ void __launch_bounds__(CK_THREADS)
ck_scatter_kernel(long long n, const int64_t* shard, const int64_t* keybody,
                  CkGeom g, int64_t* meta, int64_t* rec) {
    const int64_t nw = ck_windows(g, CK_WIN_BITS);
    const CkMeta m = ck_meta(meta, nw);
    if (!m.hdr[CK_FLAG]) return;  // the rows are in window order
    const int wb = ck_win_bits(g, CK_WIN_BITS);
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1;
    for (long long i0 = (long long)blockIdx.x * CK_THREADS; i0 < n;
         i0 += (long long)gridDim.x * CK_THREADS) {
        long long i = i0 + threadIdx.x;
        uint64_t w = i < n ? ck_slot(g, shard[i], keybody[i]) >> wb : ~0ull;
        unsigned peers = __match_any_sync(0xffffffffu, w);
        int leader = __ffs(peers) - 1;
        unsigned long long p = 0;
        if (i < n && lane == leader)
            p = atomicAdd((unsigned long long*)(m.cursor + w),
                          (unsigned long long)__popc(peers));
        p = __shfl_sync(0xffffffffu, p, leader);
        if (i < n) rec[2 * ((int64_t)p + __popc(peers & below))] = i;
    }
}

__global__ void __launch_bounds__(CK_BUILD_THREADS)
ck_build_kernel(const int64_t* shard, const int64_t* keybody,
                const int32_t* payload, CkGeom g, int64_t* meta,
                int64_t* rec, uint64_t* table) {
    __shared__ __align__(16) uint64_t s_win[1 << CK_WIN_BITS];
    __shared__ unsigned s_novf;
    const int wb = ck_win_bits(g, CK_WIN_BITS);
    const int64_t nw = ck_windows(g, CK_WIN_BITS);
    const CkMeta m = ck_meta(meta, nw);
    const int tid = threadIdx.x;
    const int64_t b = blockIdx.x, half = (int64_t)1 << (wb - 1);
    ulonglong2* sw = (ulonglong2*)s_win;
    for (int64_t i = tid; i < half; i += CK_BUILD_THREADS)
        sw[i] = make_ulonglong2(0ull, 0ull);
    if (tid == 0) s_novf = 0;
    const int64_t lo = m.start[b], hi = m.start[b + 1];
    const int64_t scattered = m.hdr[CK_FLAG];
    __syncthreads();
    for (int64_t c0 = lo; c0 < hi; c0 += CK_CHUNK) {
        int64_t row[CK_BUILD_ROWS];
#pragma unroll
        for (int u = 0; u < CK_BUILD_ROWS; u++) {
            int64_t j = c0 + u * CK_BUILD_THREADS + tid;
            row[u] = j < hi ? ck_row(rec, scattered, j) : -1;
        }
        // every row index of the chunk read before a record is written
        if (scattered) __syncthreads();
        uint64_t e[CK_BUILD_ROWS], slot[CK_BUILD_ROWS];
#pragma unroll
        for (int u = 0; u < CK_BUILD_ROWS; u++)
            e[u] = row[u] < 0 ? 0 : ck_entry(g, shard[row[u]],
                                             keybody[row[u]],
                                             payload[row[u]], &slot[u]);
#pragma unroll
        for (int u = 0; u < CK_BUILD_ROWS; u++)
            if ((e[u] & 0x3FFF) && !ck_place(s_win, e[u], slot[u], wb))
                ck_overflow(g, rec, lo + atomicAdd(&s_novf, 1u), e[u],
                            slot[u]);
    }
    __syncthreads();
    if (tid == 0) m.novf[b] = s_novf;
    ulonglong2* dst = (ulonglong2*)(table + (b << wb));
    for (int64_t i = tid; i < half; i += CK_BUILD_THREADS) dst[i] = sw[i];
}

__global__ void __launch_bounds__(CK_OVERFLOW_THREADS)
ck_overflow_kernel(CkGeom g, int64_t* meta, const int64_t* rec,
                   uint64_t* table, int max_steps) {
    const CkMeta m = ck_meta(meta, ck_windows(g, CK_WIN_BITS));
    const int64_t b = blockIdx.x, lo = m.start[b], cnt = m.novf[b];
    for (int64_t p = threadIdx.x; p < cnt; p += CK_OVERFLOW_THREADS)
        if (!ck_insert(g, table, rec, lo + p, max_steps))
            atomicAdd((unsigned long long*)(m.hdr + CK_FAIL), 1ull);
}

// One build's launches on `stream`: the counters cleared, then for n > 0
// the count, the scan, the scatter, the build and the overflow; for n = 0
// the build alone, which writes the empty table.  Returns the first
// error.
static int ck_launch(long long n, const void* shard, const void* keybody,
                     const void* payload, CkGeom g, void* meta, void* rec,
                     void* table, int max_steps, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t nw = ck_windows(g, CK_WIN_BITS);
    const int64_t* s = (const int64_t*)shard;
    const int64_t* kb = (const int64_t*)keybody;
    int64_t* m = (int64_t*)meta;
    int64_t* r = (int64_t*)rec;
    uint64_t* t = (uint64_t*)table;
    cudaError_t rc = cudaMemsetAsync(
        meta, 0, sizeof(int64_t) * (CK_HDR + 3 * nw + 1), st);
    if (rc != cudaSuccess) return (int)rc;
    if (n > 0) {
        long long rows = (long long)CK_THREADS * CK_COUNT_ROWS;
        ck_count_kernel<<<(unsigned)((n + rows - 1) / rows), CK_THREADS, 0,
                          st>>>(n, s, kb, g, m);
        if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
        ck_scan_kernel<<<1, CK_THREADS, 0, st>>>(g, m);
        if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
        long long blocks = (n + CK_THREADS - 1) / CK_THREADS;
        ck_scatter_kernel<<<(unsigned)(blocks < CK_SCATTER_BLOCKS
                                           ? blocks : CK_SCATTER_BLOCKS),
                            CK_THREADS, 0, st>>>(n, s, kb, g, m, r);
        if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
    }
    ck_build_kernel<<<(unsigned)nw, CK_BUILD_THREADS, 0, st>>>(
        s, kb, (const int32_t*)payload, g, m, r, t);
    if ((rc = cudaGetLastError()) != cudaSuccess || n <= 0) return (int)rc;
    ck_overflow_kernel<<<(unsigned)nw, CK_OVERFLOW_THREADS, 0, st>>>(
        g, m, r, t, max_steps);
    return (int)cudaGetLastError();
}
