// KH: each read's longest run of k-mers present in the trim Bloom filter,
// one warp a read.
//
// Replaces bfc_tpu/models/trimmer.py:max_streak_batch (:136) with its
// query _bloom_query (:71).  The TPU built every position's planes and
// hash at once and found the run with an associative max-scan over
// [B, L].
//
// Bound: bytes, counted as one random 64-byte Bloom block a k-mer end (all
// of its probed bits share one 512-bit block) against one streamed base;
// the hash is ~60 integer ops, below the card's integer rate.  A probe is
// a random load, so the design keeps many in flight (the first design
// rolled a read a thread, 128 threads a block: the trim batch of 8,192
// reads filled 64 blocks, a chain of ~50 dependent hash-and-probe steps a
// thread, with strided base loads):
// - One warp a read, of any length: lane j takes slots j, j + 32, ... .
//   For each 32-slot chunk three ballots give the bit-planes of the
//   base's two bits and "ACGT inside the read"; each lane cuts its k-mer's
//   planes from the window of the chunk and the two before (kmer.cuh),
//   hashes it and probes its Bloom block, so a warp has 32 independent
//   probes in flight.  The next chunk's bases load while this one probes.
// - The hits are one ballot word a chunk: each lane derives its slot's t
//   (bloom.cuh: kh_step) from it and the hit run carried into the chunk,
//   keeps its own maximum, and the warp takes the maximum of its lanes'
//   at the end of the read.  Chunks past the read's length are skipped.
// - The grid is what the card holds at once (blocks of KH_THREADS, from
//   this kernel's occupancy), each warp taking every n-th read.
#include "bloom.cuh"

#include <cuda_runtime.h>

#define KH_THREADS 256

__global__ void __launch_bounds__(KH_THREADS)
kh_kernel(const uint8_t* bases, const int32_t* lens, int B, int L, int k,
          const uint32_t* words, int bf_shift, int n_hashes, int64_t* out) {
    const int lane = threadIdx.x & 31;
    const long long warps = (long long)gridDim.x * (KH_THREADS / 32);
    for (long long r = (long long)blockIdx.x * (KH_THREADS / 32) +
                       (threadIdx.x >> 5);
         r < B; r += warps) {
        const uint8_t* row = bases + (size_t)r * L;
        const int n = lens[r] < L ? lens[r] : L;
        SlotWin w;
        win_clear(w);
        KhRun run = {0, 0};
        uint64_t best = 0;
        unsigned b, q;
        slot_load(row, nullptr, n, L, lane, &b, &q);
        for (int base = 0; base < n; base += 32) {
            // the next chunk's bases load while this chunk probes
            unsigned bn, qn;
            slot_load(row, nullptr, n, L, base + 32 + lane, &bn, &qn);
            unsigned v = slot_votes(b, q);
            b = bn, q = qn;
#pragma unroll
            for (int i = 0; i < 3; i++)
                w.cur[i] = __ballot_sync(0xffffffffu, (v >> i) & 1);
            uint32_t hits = __ballot_sync(
                0xffffffffu, kh_hit(w, lane, k, words, bf_shift, n_hashes));
            kh_step(run, &best, hits, lane, base, n);
            win_next(w);
        }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
            uint64_t o = __shfl_xor_sync(0xffffffffu, best, d);
            best = o > best ? o : best;
        }
        if (lane == 0) out[r] = (int64_t)best;
    }
}

// Blocks of the grid: the reads' warps, at most what the card holds.
static int kh_blocks(int B) {
    static int resident = 0;
    if (!resident) {
        int dev, sms, per_sm;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kh_kernel, KH_THREADS, 0);
        resident = sms * (per_sm > 0 ? per_sm : 1);
    }
    long long need = ((long long)B + KH_THREADS / 32 - 1) / (KH_THREADS / 32);
    return (int)(need < resident ? need : resident);
}

extern "C" int kh_launch(const void* bases, const void* lens, int B, int L,
                         int k, const void* words, int bf_shift, int n_hashes,
                         void* out, void* stream) {
    int blocks = kh_blocks(B);
    if (blocks > 0)
        kh_kernel<<<blocks, KH_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)bases, (const int32_t*)lens, B, L, k,
            (const uint32_t*)words, bf_shift, n_hashes, (int64_t*)out);
    return (int)cudaGetLastError();
}
