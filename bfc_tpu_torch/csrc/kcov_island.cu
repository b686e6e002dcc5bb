// KC: per-read k-mer coverage annotation and the best solid island, one
// warp a read.
//
// Replaces bfc_tpu/ops/annotate.py:kcov_batch (:67) and
// best_island_batch (:101), with the cuckoo probe of
// bfc_tpu/ops/spectrum.py:cuckoo_lookup32 (:721) inlined from
// cuckoo.cuh.  The TPU computed windows with cumsums and the island with
// an associative scan and an argmax over [B, L].
//
// Bound: bytes, counted as random 32-byte sectors.  Each k-mer end costs
// a table probe of one or two random sectors against a few bytes of
// streamed input and output, and random sectors come back at a third of
// the card's sequential rate (PERF.md §6, KO and KR), so the design keeps
// as many probes in flight as it can:
// - One warp a read, of any length: lane j takes slots j, j + 32, ... .
//   For each 32-slot chunk three ballots give the bit-planes of the base's
//   two bits and "ACGT inside the read"; each lane cuts its k-mer's planes
//   from the window of the chunk and the two before (kmer.cuh) and probes
//   the table, so a warp has 32 independent probes in flight.  The next
//   chunk's bases load while this chunk probes.
// - Ballots of "solid" and "solid and high" make the chunk's mask words.
//   lcov and hcov of a slot are popcounts over [j, j+k-1], so a chunk's
//   are written two chunks later, when the masks ahead of it are known;
//   the island is a scan over the solid words that every lane runs alike.
//   occ, lcov and hcov are each written once, 32 consecutive values a
//   store, and never read back.
// - A probe loads the second nest only where the first misses
//   (kcov_island.cuh: kc_occ).
// - The grid is what the card holds at once (blocks of KC_THREADS, from
//   this kernel's occupancy), each warp taking every n-th read.
#include "kcov_island.cuh"

#include <cuda_runtime.h>

#define KC_THREADS 256

__global__ void __launch_bounds__(KC_THREADS)
kc_kernel(SpecParams sp, int min_cov, const uint8_t* bases,
          const int32_t* lens, int B, int L, int32_t* occ, uint8_t* lcov,
          uint8_t* hcov, int32_t* isl) {
    const int lane = threadIdx.x & 31;
    const int k = sp.k;
    const int n_chunks = (L + 31) / 32;
    const long long warps = (long long)gridDim.x * (KC_THREADS / 32);
    for (long long r = (long long)blockIdx.x * (KC_THREADS / 32) +
                       (threadIdx.x >> 5);
         r < B; r += warps) {
        const size_t o = (size_t)r * L;
        const int n = lens[r];
        SlotWin w;
        win_clear(w);
        KcIsland I = {0, 0, -1};
        // solid and high words of the two chunks before this one
        uint32_t s0 = 0, s1 = 0, h0 = 0, h1 = 0;
        unsigned b, q;
        slot_load(bases + o, nullptr, n, L, lane, &b, &q);
        for (int c = 0; c < n_chunks + 2; c++) {
            uint32_t sc = 0, hc = 0;
            if (c < n_chunks) {
                const int s = 32 * c + lane;
                // the next chunk's bases load while this chunk probes
                unsigned bn, qn;
                slot_load(bases + o, nullptr, n, L, s + 32, &bn, &qn);
                unsigned v = slot_votes(b, q);
                b = bn, q = qn;
#pragma unroll
                for (int i = 0; i < 3; i++)
                    w.cur[i] = __ballot_sync(0xffffffffu, (v >> i) & 1);
                int e = s < L ? kc_occ(sp, w, lane) : -1;
                if (s < L) occ[o + s] = e;
                sc = __ballot_sync(0xffffffffu, kc_solid(e, min_cov));
                hc = __ballot_sync(0xffffffffu, kc_high(e, min_cov));
                kc_island_step(I, sc, 32 * c);
                win_next(w);
            }
            const int s2 = 32 * (c - 2) + lane;
            if (c >= 2 && s2 < L) {
                lcov[o + s2] = (uint8_t)kc_window(s0, s1, sc, lane, k);
                hcov[o + s2] = (uint8_t)kc_window(h0, h1, hc, lane, k);
            }
            s0 = s1, s1 = sc, h0 = h1, h1 = hc;
        }
        if (lane == 0) kc_island_end(I, n, k, isl + 3 * (size_t)r);
    }
}

// Blocks of the grid: the reads' warps, at most what the card holds.
static int kc_blocks(int B) {
    static int resident = 0;
    if (!resident) {
        int dev, sms, per_sm;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kc_kernel, KC_THREADS, 0);
        resident = sms * (per_sm > 0 ? per_sm : 1);
    }
    long long need = ((long long)B + KC_THREADS / 32 - 1) / (KC_THREADS / 32);
    return (int)(need < resident ? need : resident);
}

// table: the replicated table, or null; subtables: the sharded table's
// device array of 1 << db sub-table addresses, or null.
extern "C" int kc_launch(const void* table, const void* subtables, int db,
                         int k, int l_pre, int kb_bits, int c_bits,
                         int min_cov, const void* bases, const void* lens,
                         int B, int L, void* occ, void* lcov, void* hcov,
                         void* isl, void* stream) {
    SpecParams sp = {(const uint64_t*)table, k, l_pre, kb_bits, c_bits,
                     (const uint64_t* const*)subtables, db};
    int blocks = kc_blocks(B);
    if (blocks > 0)
        kc_kernel<<<blocks, KC_THREADS, 0, (cudaStream_t)stream>>>(
            sp, min_cov, (const uint8_t*)bases, (const int32_t*)lens, B, L,
            (int32_t*)occ, (uint8_t*)lcov, (uint8_t*)hcov, (int32_t*)isl);
    return (int)cudaGetLastError();
}
