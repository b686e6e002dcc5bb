// KO: the dependent flat gather, v = tab[ix], ix = (ix + v) & (N - 1), a
// chain of `steps` steps a query (probe.cuh:ko_query).
//
// Replaces the flat-gather Pallas probes: scripts/tpu_probe_r2.py s4b
// (:204, scalar loop), s4c (:231, vector take), s4d (:269, row read and
// one-hot lane select), s4e (:323, HBM DMAs, 8 in flight);
// scripts/tpu_probe4.py sD (:189, 16 DMAs in flight; :206 in a loop of 8);
// scripts/tpu_session_gather.py sE (:180, row broadcast and lane extract
// in chunks of 512, 4 steps).  One thread a query: the card keeps as many
// loads in flight as it has resident threads, which is what the TPU's DMA
// slots emulate.  The chain is KD's pattern of one probe feeding the next.
//
// The order of the loads matters beyond L2: 4,194,304 start indices over
// 2^26 entries read 29.3 G sectors/s as drawn and 57.5 G/s sorted (NVIDIA
// H100 80GB HBM3, 700.00 W; chip_ab.py --parts ko, "order").  A route that
// keeps the chains grouped by region of the table pays a binning and a
// read and write of its pairs a step for that, and won only from ~12
// steps with a chain for every 16 entries, a shape no probe site has.
// Blocks of 32-128 threads did not shorten a step at 8,192 chains.
//
// Bound: bytes.  The table's 32-byte sectors that the chains read, one an
// access where the table exceeds the 50 MB L2, each distinct one once
// where it fits (chip_probe.py:touched); plus indices and outputs.  Each
// step is ~4 integer ops.
#include "probe.cuh"

#include <cuda_runtime.h>

__global__ void ko_kernel(long long Q, const int32_t* __restrict__ tab,
                          uint32_t mask, const int32_t* __restrict__ idx,
                          int steps, int32_t* v, int32_t* ix) {
    long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (q < Q) ko_query(tab, mask, idx[q], steps, v + q, ix + q);
}

extern "C" int ko_launch(long long Q, const void* tab, long long N,
                         const void* idx, int steps, void* v, void* ix,
                         void* stream) {
    if (Q > 0)
        ko_kernel<<<(int)((Q + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
            Q, (const int32_t*)tab, (uint32_t)(N - 1), (const int32_t*)idx,
            steps, (int32_t*)v, (int32_t*)ix);
    return (int)cudaGetLastError();
}
