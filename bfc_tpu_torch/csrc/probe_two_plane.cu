// KR: the cuckoo table's two-probe, two-plane lookup as a dependent chain
// (probe.cuh:kr_query): slots ix and ix * -1640531527 & (N - 1), each
// read from a lo and a hi i32 plane, the value lo of the first slot whose
// hi ^ ix lies below 2^16 (else -1), then ix = (ix + v) & (N - 1).
//
// Replaces scripts/tpu_session_gather.py sG (:257, 4 steps over [8192,
// 128] planes, 2^15 queries in chunks of 512, each slot fetched by row
// broadcast and lane extract).  One thread a query starts the four loads
// of a step together; the card hides their latency with other queries.
//
// Bound: bytes.  The sectors the function needs, though this kernel loads
// all four: hi at ix, hi at the second slot only where the first misses,
// lo only at the slot that matches; one an access where the planes exceed
// L2, each distinct one once where they fit; plus indices and outputs.
// ~12 integer ops a step.
#include "probe.cuh"

#include <cuda_runtime.h>

__global__ void kr_kernel(long long Q, const int32_t* __restrict__ lo,
                          const int32_t* __restrict__ hi, uint32_t mask,
                          const int32_t* __restrict__ idx, int steps,
                          int32_t* v, int32_t* ix) {
    long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (q < Q) kr_query(lo, hi, mask, idx[q], steps, v + q, ix + q);
}

extern "C" int kr_launch(long long Q, const void* lo, const void* hi,
                         long long N, const void* idx, int steps, void* v,
                         void* ix, void* stream) {
    if (Q > 0)
        kr_kernel<<<(int)((Q + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
            Q, (const int32_t*)lo, (const int32_t*)hi, (uint32_t)(N - 1),
            (const int32_t*)idx, steps, (int32_t*)v, (int32_t*)ix);
    return (int)cudaGetLastError();
}
