// KP: row, column and lane gathers over a [rows, 128] i32 table, each a
// dependent chain of `steps` steps (probe.cuh:kp_*).
//
// Replaces scripts/tpu_probe2.py sD: D1 (:196; :213 in a loop of 16 with
// ix = (ix + rows[:, 0]) & (R - 1)), the row take; D2 (:233; :245 in a
// loop of 16), the column take out[q, l] = tab[idx[q, l], l]; and
// scripts/tpu_session_gather.py sC (:135, the lane take out[r, l] =
// rows[r, ix[r, l]], 16 steps) and sD (:159, the column take, 16 steps).
//
// Bound: bytes.  The table's 32-byte sectors that the chains read (row:
// the first word of each row passed, the whole last row), one an access
// where the table exceeds L2, each distinct one once where it fits; plus
// indices and outputs.  Every chain step is a dependent load, and a walk
// in device memory pays a random sector from L2 an element a step.  What
// a chain reads is small, so where it fits a block stages it once and
// walks in shared memory (the wrapper picks the route by the table's
// shape, ops/probe.py:tile_route; row mode always walks the table):
//   column  Shared route: a cluster of two blocks takes a pair of groups of
//           KP_COLS adjacent lanes (2 KP_COLS lanes: one 32-byte sector of
//           a row) and a slice of the queries.  Each block stages half the
//           rows, two neighbouring threads reading a row's sector, each
//           writing its half into the shared memory of the block that
//           walks that group (its own or its peer's), so both blocks hold
//           their group's columns (rows * 16 bytes) and no sector is read
//           half used.  A thread then walks one query's KP_COLS chains
//           together there.  The slices fill the card once: as many
//           clusters as it holds at once.  Global route: a thread an
//           element, its chain in the table, a warp's indices and outputs
//           coalesced (32 adjacent lanes of a query).
//   row     a warp a query, its lanes walking the chain in the table with
//           one broadcast load a step, then copying the row 16 bytes a
//           lane (the first design's walk: staging the first words did
//           not repay its stage at the row sites' 1 and 16 steps).
//   lane    a block stages KP_LANE_ROWS rows (coalesced) and a thread
//           walks one element's chain within its row.
// Each thread loads its first indices before its block stages, so their
// latency hides behind the stage.
#include "probe.cuh"

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define KP_THREADS 256
#define KP_COL_THREADS 1024
#define KP_LANE_ROWS 4
#define KP_GROUPS (PROBE_W / KP_COLS)

// Row mode: a warp a query, every lane walking its chain in the table
// (one broadcast load a step), then the warp's copy.
__global__ void __launch_bounds__(KP_THREADS)
kp_row_kernel(long long Q, const int32_t* __restrict__ tab, uint32_t mask,
              const int32_t* __restrict__ idx, int steps,
              int32_t* __restrict__ out, int32_t* __restrict__ ix_out) {
    long long q = ((long long)blockIdx.x * KP_THREADS + threadIdx.x) >> 5;
    if (q >= Q) return;
    uint32_t r = kp_row_chain(tab, mask, idx[q], steps);
    kp_row_copy(tab, mask, r, threadIdx.x & 31, out + q * PROBE_W,
                ix_out + q);
}

// The shared route: block b, rank b % 2 of its cluster, takes group
// (b / 2) % (KP_GROUPS / 2) * 2 + rank and the queries [s * per, s * per
// + per) of slice s = b / KP_GROUPS; a thread the queries q, q +
// KP_COL_THREADS, ... of them (the first one's indices loaded before the
// stage, each next one's before the stores).
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(KP_COL_THREADS)
kp_column_shared_kernel(long long Q, long long per,
                        const int32_t* __restrict__ tab, uint32_t rows,
                        const int32_t* __restrict__ idx, int steps,
                        int32_t* v, int32_t* ix) {
    extern __shared__ __align__(16) int32_t s_col[];
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned rank = cluster.block_rank();
    const int p0 = (blockIdx.x / 2) % (KP_GROUPS / 2) * 2 * KP_COLS;
    const int c0 = p0 + rank * KP_COLS;
    const long long s = blockIdx.x / KP_GROUPS;
    const long long q1 = (s + 1) * per < Q ? (s + 1) * per : Q;
    long long q = s * per + threadIdx.x;
    int32_t x0[KP_COLS] = {0, 0, 0, 0};
    if (q < q1) probe_load4(idx + (size_t)q * PROBE_W + c0, x0);
    // every block of the cluster must have started before any writes into
    // its shared memory: arrive (relaxed: nothing to order yet) once the
    // index load is in flight, and wait for the peer before the stage
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    // this block's half of the rows (rank 0 the first), a sector two
    // threads, each half into the block that walks its group
    const int h = threadIdx.x & 1;
    int32_t* col = cluster.map_shared_rank(s_col, h);
    const uint32_t half = (rows + 1) / 2;
    const uint32_t r1 = rank ? rows : half;
    for (uint32_t r = rank * half + (threadIdx.x >> 1); r < r1;
         r += KP_STAGE_UNROLL * (KP_COL_THREADS / 2))
        kp_col_stage(tab, p0, h, rows, r, KP_COL_THREADS / 2, r1, col);
    cluster.sync();
    const uint32_t mask = rows - 1;
    for (; q < q1; q += KP_COL_THREADS) {
        int32_t vo[KP_COLS], xo[KP_COLS];
        size_t e = (size_t)q * PROBE_W + c0;
        kp_col_chains(s_col, rows, mask, x0, steps, vo, xo);
        if (q + KP_COL_THREADS < q1)
            probe_load4(idx + e + (size_t)KP_COL_THREADS * PROBE_W, x0);
        probe_store4(v + e, vo);
        probe_store4(ix + e, xo);
    }
}

// The global route: thread e takes element e (a warp 32 adjacent lanes
// of one query).
__global__ void __launch_bounds__(KP_THREADS)
kp_column_global_kernel(long long n, const int32_t* __restrict__ tab,
                        uint32_t mask, const int32_t* __restrict__ idx,
                        int steps, int32_t* v, int32_t* ix) {
    long long e = (long long)blockIdx.x * KP_THREADS + threadIdx.x;
    if (e < n)
        kp_col_elem(tab, mask, (int)(e % PROBE_W), idx, (size_t)e, steps, v,
                    ix);
}

__global__ void __launch_bounds__(KP_LANE_ROWS * PROBE_W)
kp_lane_kernel(long long rows, const int32_t* __restrict__ tab,
               const int32_t* __restrict__ idx, int steps, int32_t* v,
               int32_t* ix) {
    __shared__ int32_t s_rows[KP_LANE_ROWS * PROBE_W];
    long long e = (long long)blockIdx.x * KP_LANE_ROWS * PROBE_W + threadIdx.x;
    bool in = e < rows * PROBE_W;
    int32_t start = in ? idx[e] : 0;
    if (in) s_rows[threadIdx.x] = tab[e];
    __syncthreads();
    if (in)
        kp_lane_elem(s_rows + threadIdx.x / PROBE_W * PROBE_W, start, steps,
                     v + e, ix + e);
}

// Once: the column kernel's shared route allowed KP_STAGE_BYTES of
// dynamic shared memory.  Returns its slices: as many slices of
// KP_GROUPS / 2 clusters (a block KP_STAGE_BYTES) as the card holds at
// once.
static int kp_setup() {
    static int slices = 0;
    if (!slices) {
        cudaFuncSetAttribute(kp_column_shared_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             KP_STAGE_BYTES);
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(KP_GROUPS, 1, 1);
        cfg.blockDim = dim3(KP_COL_THREADS, 1, 1);
        cfg.dynamicSmemBytes = KP_STAGE_BYTES;
        int clusters = 0;
        if (cudaOccupancyMaxActiveClusters(&clusters,
                                           kp_column_shared_kernel,
                                           &cfg) != cudaSuccess)
            clusters = 0;
        cudaGetLastError();   // a refused query is not a launch error
        slices = clusters / (KP_GROUPS / 2);
        if (slices < 1) slices = 1;
    }
    return slices;
}

extern "C" int kp_row_launch(long long Q, const void* tab, long long rows,
                             const void* idx, int steps, void* out, void* ix,
                             void* stream) {
    if (Q > 0)
        kp_row_kernel<<<(int)((Q * 32 + KP_THREADS - 1) / KP_THREADS),
                        KP_THREADS, 0, (cudaStream_t)stream>>>(
            Q, (const int32_t*)tab, (uint32_t)(rows - 1),
            (const int32_t*)idx, steps, (int32_t*)out, (int32_t*)ix);
    return (int)cudaGetLastError();
}

// staged: 1 for the shared route (clusters of two blocks, rows *
// KP_COLS * 4 bytes of shared memory a block), 0 for the global route.
extern "C" int kp_column_launch(long long Q, const void* tab, long long rows,
                                const void* idx, int steps, int staged,
                                void* v, void* ix, void* stream) {
    if (Q <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    uint32_t mask = (uint32_t)(rows - 1);
    if (!staged) {
        long long n = Q * PROBE_W;
        kp_column_global_kernel<<<(int)((n + KP_THREADS - 1) / KP_THREADS),
                                  KP_THREADS, 0, st>>>(
            n, (const int32_t*)tab, mask, (const int32_t*)idx, steps,
            (int32_t*)v, (int32_t*)ix);
        return (int)cudaGetLastError();
    }
    long long S = kp_setup();
    if (S > Q) S = Q;
    long long per = (Q + S - 1) / S;
    kp_column_shared_kernel<<<(int)(S * KP_GROUPS), KP_COL_THREADS,
                              (size_t)rows * KP_COLS * 4, st>>>(
        Q, per, (const int32_t*)tab, (uint32_t)rows, (const int32_t*)idx,
        steps, (int32_t*)v, (int32_t*)ix);
    return (int)cudaGetLastError();
}

extern "C" int kp_lane_launch(long long rows, const void* tab,
                              const void* idx, int steps, void* v, void* ix,
                              void* stream) {
    if (rows > 0)
        kp_lane_kernel<<<(int)((rows + KP_LANE_ROWS - 1) / KP_LANE_ROWS),
                         KP_LANE_ROWS * PROBE_W, 0, (cudaStream_t)stream>>>(
            rows, (const int32_t*)tab, (const int32_t*)idx, steps,
            (int32_t*)v, (int32_t*)ix);
    return (int)cudaGetLastError();
}
