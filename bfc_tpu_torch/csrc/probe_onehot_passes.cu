// KQ: 30 read-modify-write passes over a row of 128 i32,
// x[b, (pos[b] + i) % 128] += 1 for i < 30 (PROBE_PASSES), `steps` times,
// out of place: x is read once and the result written once to out.
//
// Replaces the lockstep one-hot passes: scripts/tpu_probe_r2.py s4a
// (:172, 30 select + row-sum + write-back passes over [2048, 128] in VMEM),
// scripts/tpu_probe2.py sE (:296, the same in a loop of 32) and
// scripts/tpu_session_gather.py sF (:221, in a loop of 16, pos from
// p_ref[:, 0]).  On the TPU each pass touches the whole [B, 128] block to
// reach one element a row; here only the lane that holds the element
// touches it.  A step's 30 passes select 30 distinct columns, so they
// commute and a row's lanes apply them at once.  Both variants run a warp
// a row, KQ_ROWS rows a block, lane j reading columns 4j..4j+3 of
// x in one 16-byte load and writing them to out in one store; they differ
// in where the passes are applied:
//   registers  lane j adds to its own four columns the passes that
//              select them (probe.cuh:kq_lane);
//   shared     the warp stages its row in shared memory and lane i < 30
//              applies pass i there as a read-modify-write of word
//              (pos + i) % 128 (probe.cuh:kq_pass), 30 consecutive words
//              in 30 banks.
// An x off a 16-byte boundary is read 4 bytes a load instead.
//
// Bound: bytes.  The rows read and written once and pos read once; the
// passes are ~4 integer ops each, per row.  At the probe sites (1 MB of
// rows) the call is one launch and one round trip.
#include "probe.cuh"

#include <cuda_runtime.h>
#include <stdint.h>

#define KQ_THREADS (32 * KQ_ROWS)

template <bool A16>
__device__ void kq_load(const int32_t* p, int32_t r[4]) {
    if (A16) {
        probe_load4(p, r);
    } else {
        for (int c = 0; c < 4; c++) r[c] = __ldg(p + c);
    }
}

template <bool A16>
__global__ void __launch_bounds__(KQ_THREADS)
kq_registers_kernel(long long B, const int32_t* __restrict__ x,
                    const int32_t* __restrict__ pos, int steps,
                    int32_t* __restrict__ out) {
    long long b = (long long)blockIdx.x * KQ_ROWS + (threadIdx.x >> 5);
    int lane = threadIdx.x & 31;
    if (b >= B) return;
    int32_t r[4];
    kq_load<A16>(x + b * PROBE_W + 4 * lane, r);
    kq_lane(r, lane, __ldg(pos + b), steps);
    probe_store4(out + b * PROBE_W + 4 * lane, r);
}

template <bool A16>
__global__ void __launch_bounds__(KQ_THREADS)
kq_shared_kernel(long long B, const int32_t* __restrict__ x,
                 const int32_t* __restrict__ pos, int steps,
                 int32_t* __restrict__ out) {
    __shared__ __align__(16) int32_t s_x[KQ_ROWS][PROBE_W];
    int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    long long b = (long long)blockIdx.x * KQ_ROWS + w;
    if (b >= B) return;   // a whole warp: no block-wide barrier follows
    int32_t* row = s_x[w];
    int32_t r[4];
    kq_load<A16>(x + b * PROBE_W + 4 * lane, r);
    *reinterpret_cast<int4*>(row + 4 * lane) = make_int4(r[0], r[1], r[2],
                                                         r[3]);
    __syncwarp();
    kq_pass(row, lane, __ldg(pos + b), steps);
    __syncwarp();
    int4 y = *reinterpret_cast<const int4*>(row + 4 * lane);
    r[0] = y.x, r[1] = y.y, r[2] = y.z, r[3] = y.w;
    probe_store4(out + b * PROBE_W + 4 * lane, r);
}

template <bool A16>
static void kq_enqueue(int shared, long long B, const int32_t* x,
                       const int32_t* pos, int steps, int32_t* out,
                       cudaStream_t st) {
    int grid = (int)((B + KQ_ROWS - 1) / KQ_ROWS);
    if (shared)
        kq_shared_kernel<A16><<<grid, KQ_THREADS, 0, st>>>(B, x, pos, steps,
                                                          out);
    else
        kq_registers_kernel<A16><<<grid, KQ_THREADS, 0, st>>>(B, x, pos,
                                                             steps, out);
}

// out on a 16-byte boundary (the wrapper allocates it); x on any 4-byte one.
static int kq_launch(int shared, long long B, const void* x, const void* pos,
                     int steps, void* out, void* stream) {
    if (B > 0) {
        cudaStream_t st = (cudaStream_t)stream;
        if ((uintptr_t)x % 16 == 0)
            kq_enqueue<true>(shared, B, (const int32_t*)x,
                             (const int32_t*)pos, steps, (int32_t*)out, st);
        else
            kq_enqueue<false>(shared, B, (const int32_t*)x,
                              (const int32_t*)pos, steps, (int32_t*)out, st);
    }
    return (int)cudaGetLastError();
}

extern "C" int kq_registers_launch(long long B, const void* x,
                                   const void* pos, int steps, void* out,
                                   void* stream) {
    return kq_launch(0, B, x, pos, steps, out, stream);
}

extern "C" int kq_shared_launch(long long B, const void* x, const void* pos,
                                int steps, void* out, void* stream) {
    return kq_launch(1, B, x, pos, steps, out, stream);
}
