// KP: row, column and lane gathers over a [rows, 128] i32 table, each a
// dependent chain of `steps` steps (probe.cuh:kp_*).
//
// Replaces scripts/tpu_probe2.py sD: D1 (:196; :213 in a loop of 16 with
// ix = (ix + rows[:, 0]) & (R - 1)), the row take; D2 (:233; :245 in a
// loop of 16), the column take out[q, l] = tab[idx[q, l], l]; and
// scripts/tpu_session_gather.py sC (:135, the lane take out[r, l] =
// rows[r, ix[r, l]], 16 steps) and sD (:159, the column take, 16 steps).
//   row     one warp a query.  Every lane runs the chain on the rows'
//           first words (one broadcast load a step), then the warp copies
//           the last row, 16 bytes a lane.
//   column  one thread an element: each lane of a query walks its own
//           column.
//   lane    one block a tile of KP_TILE rows, staged in shared memory; a
//           thread takes one lane of each row and chains within the row.
//
// Bound: bytes.  The table's 32-byte sectors that the chains read (row:
// the first word of each row passed, the whole last row), one an access
// where the table exceeds L2, each distinct one once where it fits; plus
// indices and outputs.
#include "probe.cuh"

#include <cuda_runtime.h>

#define KP_THREADS 256
#define KP_TILE 8

__global__ void kp_row_kernel(long long Q, const int32_t* __restrict__ tab,
                              uint32_t mask, const int32_t* __restrict__ idx,
                              int steps, int32_t* out, int32_t* ix_out) {
    long long q = ((long long)blockIdx.x * KP_THREADS + threadIdx.x) >> 5;
    int lane = threadIdx.x & 31;
    if (q >= Q) return;
    uint32_t ix = (uint32_t)idx[q] & mask;
    for (int s = 1; s < steps; s++) ix = kp_row_step(tab, mask, ix);
    int4 r = reinterpret_cast<const int4*>(tab + (size_t)ix * PROBE_W)[lane];
    reinterpret_cast<int4*>(out + q * PROBE_W)[lane] = r;
    int first = __shfl_sync(0xffffffffu, r.x, 0);
    if (lane == 0) ix_out[q] = (int32_t)probe_next(ix, first, mask);
}

__global__ void kp_column_kernel(long long n, const int32_t* __restrict__ tab,
                                 uint32_t mask,
                                 const int32_t* __restrict__ idx, int steps,
                                 int32_t* v, int32_t* ix) {
    long long e = (long long)blockIdx.x * KP_THREADS + threadIdx.x;
    if (e < n)
        kp_col_elem(tab, mask, (int)(e & (PROBE_W - 1)), idx[e], steps,
                    v + e, ix + e);
}

__global__ void kp_lane_kernel(long long rows,
                               const int32_t* __restrict__ tab,
                               const int32_t* __restrict__ idx, int steps,
                               int32_t* v, int32_t* ix) {
    __shared__ int32_t s_rows[KP_TILE][PROBE_W];
    long long r0 = (long long)blockIdx.x * KP_TILE;
    int l = threadIdx.x;
    int n = rows - r0 < KP_TILE ? (int)(rows - r0) : KP_TILE;
    for (int r = 0; r < n; r++) s_rows[r][l] = tab[(r0 + r) * PROBE_W + l];
    __syncthreads();
    for (int r = 0; r < n; r++) {
        long long e = (r0 + r) * PROBE_W + l;
        kp_lane_elem(s_rows[r], idx[e], steps, v + e, ix + e);
    }
}

extern "C" int kp_row_launch(long long Q, const void* tab, long long rows,
                             const void* idx, int steps, void* out,
                             void* ix, void* stream) {
    if (Q > 0)
        kp_row_kernel<<<(int)((Q * 32 + KP_THREADS - 1) / KP_THREADS),
                        KP_THREADS, 0, (cudaStream_t)stream>>>(
            Q, (const int32_t*)tab, (uint32_t)(rows - 1),
            (const int32_t*)idx, steps, (int32_t*)out, (int32_t*)ix);
    return (int)cudaGetLastError();
}

extern "C" int kp_column_launch(long long Q, const void* tab, long long rows,
                                const void* idx, int steps, void* v,
                                void* ix, void* stream) {
    long long n = Q * PROBE_W;
    if (n > 0)
        kp_column_kernel<<<(int)((n + KP_THREADS - 1) / KP_THREADS),
                           KP_THREADS, 0, (cudaStream_t)stream>>>(
            n, (const int32_t*)tab, (uint32_t)(rows - 1),
            (const int32_t*)idx, steps, (int32_t*)v, (int32_t*)ix);
    return (int)cudaGetLastError();
}

extern "C" int kp_lane_launch(long long rows, const void* tab,
                              const void* idx, int steps, void* v, void* ix,
                              void* stream) {
    if (rows > 0)
        kp_lane_kernel<<<(int)((rows + KP_TILE - 1) / KP_TILE), PROBE_W, 0,
                         (cudaStream_t)stream>>>(
            rows, (const int32_t*)tab, (const int32_t*)idx, steps,
            (int32_t*)v, (int32_t*)ix);
    return (int)cudaGetLastError();
}
