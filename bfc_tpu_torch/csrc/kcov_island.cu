// KC: per-read k-mer coverage annotation and the best solid island.
//
// Replaces bfc_tpu/ops/annotate.py:kcov_batch (:67) and
// best_island_batch (:101), with the cuckoo probe of
// bfc_tpu/ops/spectrum.py:cuckoo_lookup32 (:721) inlined from
// cuckoo.cuh.  The TPU computed windows with cumsums and the island with
// an associative scan and an argmax over [B, L]; here one thread walks one
// read, as the reference's bfc_ec_kcov and bfc_ec_best_island do.
//
// Bound: bytes, counted as random 32-byte sectors.  Each k-mer end costs
// two independent table loads (one sector each) against a few bytes of
// streamed input and output, so the table probes dominate the traffic.
// Many reads in flight hide their latency.
#include "kcov_island.cuh"

#include <cuda_runtime.h>

__global__ void kc_kernel(SpecParams sp, int min_cov, const uint8_t* bases,
                          const int32_t* lens, int B, int L, int32_t* occ,
                          uint8_t* lcov, uint8_t* hcov, int32_t* isl) {
    int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= B) return;
    size_t o = (size_t)r * L;
    kc_read(sp, min_cov, bases + o, lens[r], L, occ + o, lcov + o, hcov + o,
            isl + 3 * (size_t)r);
}

extern "C" int kc_launch(const void* table, int k, int l_pre, int kb_bits,
                         int c_bits, int min_cov, const void* bases,
                         const void* lens, int B, int L, void* occ,
                         void* lcov, void* hcov, void* isl, void* stream) {
    SpecParams sp = {(const uint64_t*)table, k, l_pre, kb_bits, c_bits};
    int threads = 128;
    int blocks = (B + threads - 1) / threads;
    if (blocks > 0)
        kc_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            sp, min_cov, (const uint8_t*)bases, (const int32_t*)lens, B, L,
            (int32_t*)occ, (uint8_t*)lcov, (uint8_t*)hcov, (int32_t*)isl);
    return (int)cudaGetLastError();
}
