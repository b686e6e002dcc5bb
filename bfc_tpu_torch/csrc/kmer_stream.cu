// KA: the counting pass's fused k-mer stream, one warp a read.
//
// Replaces bfc_tpu/ops/kmer.py:kmer_stream (:199) with kmer_planes (:64),
// valid_kmer_mask (:92), high_quality_mask (:106), canonical_hash (:135)
// and shard_and_keybody (:175).  The TPU built the planes of every
// position at once with log2(k) shifted ORs and masks from associative
// scans.
//
// Bound: bytes.  Per slot it reads 2 bytes (base, quality flag) and
// writes 24 (shard, keybody, arrp; 32 with ret), about 60 u64 ops of
// hashing, below the card's integer rate.  The design:
// - One warp a read, of any length: lane j takes slots j, j + 32, ... .
//   For each 32-slot chunk four ballots give the bit-planes of the
//   base's two bits, "ACGT inside the read" and "quality ok"; the warp
//   keeps the two chunks before, and each lane cuts its k-mer's planes
//   from the 96-bit window with a funnel shift (kmer.cuh: win_cut,
//   kmer_from_bits) instead of rolling a chain over the read.
// - A lane loads the next chunk's base and quality bytes before it
//   hashes this chunk's k-mer, so a read waits on one load, not one a
//   chunk.
// - A warp's 32 lanes store 32 consecutive int64 of each output, 256
//   bytes a store.
// - The grid is what the card holds at once (blocks of KA_THREADS, from
//   this kernel's occupancy), each warp taking every n-th read.
#include "kmer_stream.cuh"

#include <cuda_runtime.h>

#define KA_THREADS 256

__global__ void __launch_bounds__(KA_THREADS)
ka_kernel(const uint8_t* bases, const uint8_t* qok, const int32_t* lens,
          int B, int L, int k, int l_pre, long long arrival_base,
          int64_t* shard, int64_t* keybody, int64_t* arrp, int64_t* ret) {
    const int lane = threadIdx.x & 31;
    const long long warps = (long long)gridDim.x * (KA_THREADS / 32);
    for (long long r = (long long)blockIdx.x * (KA_THREADS / 32) +
                       (threadIdx.x >> 5);
         r < B; r += warps) {
        const size_t o = (size_t)r * L;
        const int len = lens[r];
        unsigned c, q;
        slot_load(bases + o, qok + o, len, L, lane, &c, &q);
        SlotWin w;
        win_clear(w);
        for (int c0 = 0; c0 < L; c0 += 32) {
            const int s = c0 + lane;
            // the next chunk's bytes load while this chunk hashes
            unsigned cn, qn;
            slot_load(bases + o, qok + o, len, L, s + 32, &cn, &qn);
            unsigned v = slot_votes(c, q);
#pragma unroll
            for (int i = 0; i < 4; i++)
                w.cur[i] = __ballot_sync(0xffffffffu, (v >> i) & 1);
            if (s < L)
                ka_slot(w, lane, k, l_pre,
                        (int64_t)arrival_base + (int64_t)(o + s),
                        shard + o + s, keybody + o + s, arrp + o + s,
                        ret ? ret + o + s : nullptr);
            win_next(w);
            c = cn, q = qn;
        }
    }
}

// Blocks of the grid: the reads' warps, at most what the card holds.
static int ka_blocks(int B) {
    static int resident = 0;
    if (!resident) {
        int dev, sms, per_sm;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ka_kernel,
                                                      KA_THREADS, 0);
        resident = sms * (per_sm > 0 ? per_sm : 1);
    }
    long long need = ((long long)B + KA_THREADS / 32 - 1) / (KA_THREADS / 32);
    return (int)(need < resident ? need : resident);
}

extern "C" int ka_launch(const void* bases, const void* qok, const void* lens,
                         int B, int L, int k, int l_pre,
                         long long arrival_base, void* shard, void* keybody,
                         void* arrp, void* ret, void* stream) {
    int blocks = ka_blocks(B);
    if (blocks > 0 && L > 0)
        ka_kernel<<<blocks, KA_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)bases, (const uint8_t*)qok, (const int32_t*)lens,
            B, L, k, l_pre, arrival_base, (int64_t*)shard, (int64_t*)keybody,
            (int64_t*)arrp, (int64_t*)ret);
    return (int)cudaGetLastError();
}
