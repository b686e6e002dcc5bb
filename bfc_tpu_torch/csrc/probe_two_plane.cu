// KR: the cuckoo table's two-probe, two-plane lookup as a dependent chain:
// slots ix and ix * -1640531527 & (N - 1), each read from a lo and a hi
// i32 plane, the value lo of the first slot whose hi ^ ix lies below 2^16
// (else -1), then ix = (ix + v) & (N - 1).
//
// Replaces scripts/tpu_session_gather.py sG (:257, 4 steps over [8192,
// 128] planes, 2^15 queries in chunks of 512, each slot fetched by row
// broadcast and lane extract).  Two routes (ops/probe.py:two_plane_route
// picks one by the queries):
//   eager  a thread a query (probe.cuh:kr_query).  nvcc builds it as one
//          round of hi at both slots and lo at the second, then lo at the
//          first only where that slot matched (cuobjdump -sass: three
//          loads, one predicated load a step): three sectors a step on
//          cuckoo planes whose keys sit in their second slot, three on a
//          miss at both, where the function needs two.  Below ~32,768
//          queries a step is about one round trip, which a second
//          dependent round would lengthen.
//   lazy   a thread a query, hi at both slots in one round, then lo only
//          at the slot that matched (probe.cuh:kr_lazy_query): the
//          sectors the function needs.
//          From ~32,768 queries the card's rate of random sectors sets
//          the time, not the round trips, so the second round costs
//          nothing there, and a miss at both slots saves a sector.  More
//          queries a thread, walked together, did not read faster.
//
// Bound: bytes.  The sectors the function needs: hi at ix, hi at the
// second slot only where the first misses, lo only at the slot that
// matches; one an access where the planes exceed L2, each distinct one
// once where they fit; plus indices and outputs.  ~12 integer ops a step.
// Over 256 MiB of planes an NVIDIA H100 80GB HBM3 at 700 W reads ~34 G
// random sectors a second on either route (chip_ab.py --parts kr), a
// third of the 105 G that the bound's 3.35 TB/s allows: the bound lies
// far below what the card reaches there.
#include "probe.cuh"

#include <cuda_runtime.h>

#define KR_THREADS 256

template <bool LAZY>
__global__ void __launch_bounds__(KR_THREADS)
kr_kernel(long long Q, const int32_t* __restrict__ lo,
          const int32_t* __restrict__ hi, uint32_t mask,
          const int32_t* __restrict__ idx, int steps,
          int32_t* __restrict__ v, int32_t* __restrict__ ix) {
    long long q = (long long)blockIdx.x * KR_THREADS + threadIdx.x;
    if (q >= Q) return;
    if (LAZY)
        kr_lazy_query(lo, hi, mask, idx[q], steps, v + q, ix + q);
    else
        kr_query(lo, hi, mask, idx[q], steps, v + q, ix + q);
}

// lazy: 1 for the lazy route, 0 for the eager one.
extern "C" int kr_launch(long long Q, const void* lo, const void* hi,
                         long long N, const void* idx, int steps, int lazy,
                         void* v, void* ix, void* stream) {
    if (Q > 0) {
        int grid = (int)((Q + KR_THREADS - 1) / KR_THREADS);
        cudaStream_t st = (cudaStream_t)stream;
        const int32_t *l = (const int32_t*)lo, *h = (const int32_t*)hi,
                      *i = (const int32_t*)idx;
        int32_t *vo = (int32_t*)v, *io = (int32_t*)ix;
        uint32_t mask = (uint32_t)(N - 1);
        if (lazy)
            kr_kernel<true><<<grid, KR_THREADS, 0, st>>>(Q, l, h, mask, i,
                                                         steps, vo, io);
        else
            kr_kernel<false><<<grid, KR_THREADS, 0, st>>>(Q, l, h, mask, i,
                                                          steps, vo, io);
    }
    return (int)cudaGetLastError();
}
