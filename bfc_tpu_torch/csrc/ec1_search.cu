// KD: per-read error correction, the whole of bfc_ec1 in one thread.
//
// Replaces bfc_tpu/ops/search.py:ec1dir_batch (:436) with _search_loop
// (:648), heap_push (:273), heap_pop (:324), _occ_of (:392) and
// _search_backtrack (:1057); annotate.py:greedy_k_batch (:170) with the
// island-hop loop of corrector.py:correct_core (:143-175); and the rest of
// correct_core (:67-379): the many-N gate, the reverse-complemented second
// direction, the direction merge and the packed output.  The TPU ran all
// reads in lockstep lanes with one-hot extracts, split heaps, soft caps and
// resume pools; on the card one thread carries one read through
// refmodel.ec1 (:818) and ec1dir (:579) directly.
//
// Bound: the latency of dependent random loads.  By bytes, each search
// step costs 1-4 probes of two random 32-byte sectors, plus heap and stack
// traffic in the read's scratch; the operations are a few hundred integer
// ops a step.  Threads of one warp follow different search paths, so
// divergence and the longest read of the batch set the time.  This first
// version keeps the heap and stack in device-memory scratch (cached in L1
// and L2) and leaves sorting reads by difficulty to a later PR.
#include "ec1_search.cuh"

#include <cuda_runtime.h>

__global__ void kd_kernel(KdParams P, int B, int L, const uint8_t* bases,
                          const uint8_t* q, const int32_t* lens,
                          const uint8_t* lcov, const uint8_t* hcov,
                          const int32_t* isl, uint8_t* ec0, uint8_t* ec1,
                          KdHeapEnt* heap, KdStackEnt* stack,
                          uint8_t* packed, int32_t* out) {
    int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= B) return;
    size_t o = (size_t)r * L;
    kd_read(P, L, bases + o, q + o, lcov + o, hcov + o, lens[r],
            isl + 3 * (size_t)r, ec0 + o, ec1 + o,
            heap + (size_t)r * P.heap_cap, stack + (size_t)r * P.stack_cap,
            packed + o, out + (size_t)KD_N_OUT * r);
}

extern "C" int kd_sizes(int* heap_ent, int* stack_ent, int* n_out) {
    *heap_ent = (int)sizeof(KdHeapEnt);
    *stack_ent = (int)sizeof(KdStackEnt);
    *n_out = KD_N_OUT;
    return 0;
}

// table: the replicated table, or null; subtables: the sharded table's
// device array of 1 << db sub-table addresses, or null.
extern "C" int kd_launch(const void* table, const void* subtables, int db,
                         int k, int l_pre, int kb_bits, int c_bits,
                         const int* iparams, int B, int L,
                         const void* bases, const void* q, const void* lens,
                         const void* lcov, const void* hcov, const void* isl,
                         void* ec0, void* ec1, void* heap, void* stack,
                         void* packed, void* out, void* stream) {
    KdParams P;
    P.sp.table = (const uint64_t*)table;
    P.sp.k = k;
    P.sp.l_pre = l_pre;
    P.sp.kb_bits = kb_bits;
    P.sp.c_bits = c_bits;
    P.sp.subtables = (const uint64_t* const*)subtables;
    P.sp.db = db;
    P.min_cov = iparams[0];
    P.win_multi_ec = iparams[1];
    P.max_end_ext = iparams[2];
    P.w_ec = iparams[3];
    P.w_ec_high = iparams[4];
    P.w_absent = iparams[5];
    P.w_absent_high = iparams[6];
    P.max_path_diff = iparams[7];
    P.max_heap = iparams[8];
    P.mode = iparams[9];
    P.heap_cap = iparams[10];
    P.stack_cap = iparams[11];
    int threads = 64;
    int blocks = (B + threads - 1) / threads;
    if (blocks > 0)
        kd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            P, B, L, (const uint8_t*)bases, (const uint8_t*)q,
            (const int32_t*)lens, (const uint8_t*)lcov, (const uint8_t*)hcov,
            (const int32_t*)isl, (uint8_t*)ec0, (uint8_t*)ec1,
            (KdHeapEnt*)heap, (KdStackEnt*)stack, (uint8_t*)packed,
            (int32_t*)out);
    return (int)cudaGetLastError();
}
