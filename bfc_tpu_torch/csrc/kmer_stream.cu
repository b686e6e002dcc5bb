// KA: the counting pass's fused k-mer stream.
//
// Replaces bfc_tpu/ops/kmer.py:kmer_stream (:199) with kmer_planes (:64),
// valid_kmer_mask (:92), high_quality_mask (:106), canonical_hash (:135)
// and shard_and_keybody (:175).  The TPU built the planes of every
// position at once with log2(k) shifted ORs and masks from associative
// scans; here one thread rolls one read, as the reference's kmer.h does.
//
// Bound: bytes.  Per slot it reads 2 bytes (base, quality flag) and
// writes 24 (shard, keybody, arrp; 32 with ret), about 40 integer ops of
// hashing, far below the card's integer rate.  The design keeps the
// rolling state in registers and writes each output once; the row-major
// per-thread stores are not coalesced, which a later PR can fix by
// transposing through shared memory.
#include "kmer_stream.cuh"

#include <cuda_runtime.h>

__global__ void ka_kernel(const uint8_t* bases, const uint8_t* qok,
                          const int32_t* lens, int B, int L, int k,
                          int l_pre, long long arrival_base, int64_t* shard,
                          int64_t* keybody, int64_t* arrp, int64_t* ret) {
    int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= B) return;
    size_t o = (size_t)r * L;
    ka_read(bases + o, qok + o, lens[r], L, k, l_pre,
            (int64_t)arrival_base + (int64_t)o, shard + o, keybody + o,
            arrp + o, ret ? ret + o : nullptr);
}

extern "C" int ka_launch(const void* bases, const void* qok, const void* lens,
                         int B, int L, int k, int l_pre,
                         long long arrival_base, void* shard, void* keybody,
                         void* arrp, void* ret, void* stream) {
    int threads = 128;
    int blocks = (B + threads - 1) / threads;
    if (blocks > 0)
        ka_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)bases, (const uint8_t*)qok, (const int32_t*)lens,
            B, L, k, l_pre, arrival_base, (int64_t*)shard, (int64_t*)keybody,
            (int64_t*)arrp, (int64_t*)ret);
    return (int)cudaGetLastError();
}
