// KQ: 30 read-modify-write passes over a row of 128 i32,
// x[b, (pos[b] + i) % 128] += 1 for i < 30 (PROBE_PASSES), `steps` times,
// in place.
//
// Replaces the lockstep one-hot passes: scripts/tpu_probe_r2.py s4a
// (:172, 30 select + row-sum + write-back passes over [2048, 128] in VMEM),
// scripts/tpu_probe2.py sE (:296, the same in a loop of 32) and
// scripts/tpu_session_gather.py sF (:221, in a loop of 16, pos from
// p_ref[:, 0]).  On the TPU each pass touches the whole [B, 128] block to
// reach one element a row; here only the owner of the element touches it,
// and the question is where the row lives:
//   registers  one warp a row, lane j holding columns 4j..4j+3 in
//              registers (probe.cuh:kq_lane); a pass is one add by the
//              owning lane.
//   shared     one thread a row, the block's KQ_ROWS rows in shared
//              memory, padded to 129 words against bank conflicts
//              (probe.cuh:kq_row).
// Both load and store the rows once, coalesced.
//
// Bound: bytes.  The rows read and written once and pos read once; the
// passes are ~4 integer ops each, per row.
#include "probe.cuh"

#include <cuda_runtime.h>

#define KQ_THREADS 256
#define KQ_ROWS 64

__global__ void kq_registers_kernel(long long B, int32_t* x,
                                    const int32_t* __restrict__ pos,
                                    int steps) {
    long long b = ((long long)blockIdx.x * KQ_THREADS + threadIdx.x) >> 5;
    int lane = threadIdx.x & 31;
    if (b >= B) return;
    int4* row = reinterpret_cast<int4*>(x + b * PROBE_W);
    int4 v = row[lane];
    int32_t r[4] = {v.x, v.y, v.z, v.w};
    kq_lane(r, lane, pos[b], steps);
    row[lane] = make_int4(r[0], r[1], r[2], r[3]);
}

__global__ void kq_shared_kernel(long long B, int32_t* x,
                                 const int32_t* __restrict__ pos,
                                 int steps) {
    __shared__ int32_t s_x[KQ_ROWS][PROBE_W + 1];
    long long b0 = (long long)blockIdx.x * KQ_ROWS;
    int n = B - b0 < KQ_ROWS ? (int)(B - b0) : KQ_ROWS;
    for (int e = threadIdx.x; e < n * PROBE_W; e += KQ_ROWS)
        s_x[e / PROBE_W][e % PROBE_W] = x[b0 * PROBE_W + e];
    __syncthreads();
    if ((int)threadIdx.x < n)
        kq_row(s_x[threadIdx.x], pos[b0 + threadIdx.x], steps);
    __syncthreads();
    for (int e = threadIdx.x; e < n * PROBE_W; e += KQ_ROWS)
        x[b0 * PROBE_W + e] = s_x[e / PROBE_W][e % PROBE_W];
}

extern "C" int kq_registers_launch(long long B, void* x, const void* pos,
                                   int steps, void* stream) {
    if (B > 0)
        kq_registers_kernel<<<(int)((B * 32 + KQ_THREADS - 1) / KQ_THREADS),
                              KQ_THREADS, 0, (cudaStream_t)stream>>>(
            B, (int32_t*)x, (const int32_t*)pos, steps);
    return (int)cudaGetLastError();
}

extern "C" int kq_shared_launch(long long B, void* x, const void* pos,
                                int steps, void* stream) {
    if (B > 0)
        kq_shared_kernel<<<(int)((B + KQ_ROWS - 1) / KQ_ROWS), KQ_ROWS, 0,
                           (cudaStream_t)stream>>>(
            B, (int32_t*)x, (const int32_t*)pos, steps);
    return (int)cudaGetLastError();
}
