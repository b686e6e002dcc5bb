// KD: per-read error correction, the whole of bfc_ec1 a read, on
// persistent threads.
//
// Replaces bfc_tpu/ops/search.py:ec1dir_batch (:436) with _search_loop
// (:648), heap_push (:273), heap_pop (:324), _occ_of (:392) and
// _search_backtrack (:1057); annotate.py:greedy_k_batch (:170) with the
// island-hop loop of corrector.py:correct_core (:143-175); and the rest of
// correct_core (:67-379): the many-N gate, the reverse-complemented second
// direction, the direction merge and the packed output.  The TPU ran all
// reads in lockstep lanes with one-hot extracts, split heaps, soft caps and
// resume pools; on the card a thread carries one read at a time through
// refmodel.ec1 (:818) and ec1dir (:579) directly.
//
// Bound: the latency of each thread's chain of search steps.  A step is a
// pop, 1-4 table probes of two random 32-byte sectors each, whose slots
// depend on a hash of the popped state, and a few pushes; by bytes and
// operations the work needs a tenth of the time it takes.  What the
// design does about it (ec1_search.cuh has the details):
// - The grid is what the card holds at once (kd_plan, from this kernel's
//   occupancy), and each thread takes reads from a global counter until
//   the batch is done: scratch is sized by resident threads, and a thread
//   that finishes a short read starts the next instead of idling behind
//   the batch's longest one.  The caller's batch is about two reads a
//   resident thread (search.py:CORRECT_BATCH).
// - A step issues the loads of all the probes it will use before it uses
//   any, and loads no probe the spec would not make.
// - The heap's keys (4 bytes) sit in shared memory; an entry's 72 bytes
//   go to scratch once and are never sifted; the step's cheapest push
//   stays in registers, written back only when a cheaper push displaces
//   it, so a clean step writes 16 bytes of stack and nothing else.  A
//   step reads one info byte of its read, not four arrays.
// - A warp's threads are on different reads and bases: a step probes
//   and pushes by ordinal (its j-th base), not by base, so a warp runs
//   one hash and one push a thread, not four.
// - Beyond 4 blocks an SM, L1 misses cost more than threads gain: see
//   KD_MIN_BLOCKS.
// - Pass 1 gives a read KD_STACK1 stack entries; a read that needs more
//   is deferred to pass 2, which runs it again with the full stack_cap
//   on fewer threads in the same scratch.
#include "ec1_search.cuh"

#include <cuda_runtime.h>

#define KD_THREADS 64
// Blocks of 64 an SM: 4.  The registers are bounded for them, and the
// shared-memory carveout asks for no more than their heap keys take
// (4 x 32 KiB), which leaves the rest of the SM's 256 KiB to L1: there
// the threads' info bytes, stack lines and pool slots stay.  On an H100
// this ran faster than 3 blocks (8-byte keys), than 6 (whose keys leave
// 28 KiB of L1) and than 8 with the keys in scratch (128 registers,
// spills); PERF.md section 6 has the times.
#define KD_MIN_BLOCKS 4
#define KD_CARVEOUT 58  // percent of the 228 KiB: 132 KiB of shared memory

template <int PASS>
__global__ void __launch_bounds__(KD_THREADS, KD_MIN_BLOCKS)
kd_kernel(KdParams P, KdBatch bt, uint8_t* scratch, long long per_thread,
          int stack_cap) {
    extern __shared__ KdKey kd_keys[];
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    uint8_t* mine = scratch + t * per_thread;
    KdScratch S;
    S.keys = kd_keys + threadIdx.x;
    S.kstride = blockDim.x;
    S.pool = (KdEnt*)mine;
    S.stack = (KdStackEnt*)(mine + (size_t)P.heap_cap * sizeof(KdEnt));
    S.stack_cap = stack_cap;
    kd_worker(P, bt, S, PASS);
}

static long long round16(long long v) { return (v + 15) & ~15ll; }

// The launch plan for heap_cap and stack_cap (same for both passes):
// plan[0] threads a block, [1] resident blocks a pass-1 grid, [2] pass 1's
// stack entries a thread, [3] pass 1's scratch bytes a thread, [4] pass
// 2's scratch bytes a thread, [5] dynamic shared bytes a block, [6]
// registers a thread, [7] local-memory bytes a thread, [8] blocks an SM,
// [9] SMs, [10] KD_N_OUT, [11] KD_SLOT_BITS.  Pass 2 fits as many threads
// as pass 1's scratch holds.
extern "C" int kd_plan(int heap_cap, int stack_cap, long long* plan) {
    int dev, sms, nb = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    int smem = KD_THREADS * heap_cap * (int)sizeof(KdKey);
    cudaFuncSetAttribute(kd_kernel<1>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(kd_kernel<2>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(kd_kernel<1>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         KD_CARVEOUT);
    cudaFuncSetAttribute(kd_kernel<2>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         KD_CARVEOUT);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kd_kernel<1>,
                                                  KD_THREADS, smem);
    cudaFuncAttributes fa;
    cudaFuncGetAttributes(&fa, kd_kernel<1>);
    int stack1 = stack_cap < KD_STACK1 ? stack_cap : KD_STACK1;
    long long pool = (long long)heap_cap * sizeof(KdEnt);
    plan[0] = KD_THREADS;
    plan[1] = (long long)nb * sms;
    plan[2] = stack1;
    plan[3] = round16(pool + (long long)stack1 * sizeof(KdStackEnt));
    plan[4] = round16(pool + (long long)stack_cap * sizeof(KdStackEnt));
    plan[5] = smem;
    plan[6] = fa.numRegs;
    plan[7] = (long long)fa.localSizeBytes;
    plan[8] = nb;
    plan[9] = sms;
    plan[10] = KD_N_OUT;
    plan[11] = KD_SLOT_BITS;
    return (int)cudaGetLastError();
}

// table: the replicated table, or null; subtables: the sharded table's
// device array of 1 << db sub-table addresses, or null.  ctr: 3 int32 of
// device scratch, zeroed here; retry: B int32.  Pass 1 runs on blocks1
// blocks with stack1 entries a thread (per1 scratch bytes), pass 2, when
// stack1 < stack_cap, on blocks2 blocks (per2 bytes) in the same scratch.
extern "C" int kd_launch(const void* table, const void* subtables, int db,
                         int k, int l_pre, int kb_bits, int c_bits,
                         const int* iparams, int B, int L,
                         const void* bases, const void* q, const void* lens,
                         const void* lcov, const void* hcov, const void* isl,
                         void* ec0, void* ec1, void* info, void* packed,
                         void* out,
                         void* scratch, void* ctr, void* retry, int blocks1,
                         int stack1, long long per1, int blocks2,
                         long long per2, int smem, void* stream) {
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
    KdBatch bt = {B, L, (const uint8_t*)bases, (const uint8_t*)q,
                  (const int32_t*)lens, (const uint8_t*)lcov,
                  (const uint8_t*)hcov, (const int32_t*)isl, (uint8_t*)ec0,
                  (uint8_t*)ec1, (uint8_t*)info, (uint8_t*)packed,
                  (int32_t*)out,
                  (int32_t*)ctr, (int32_t*)retry};
    cudaStream_t s = (cudaStream_t)stream;
    if (B <= 0) return (int)cudaGetLastError();
    // the attribute is the kernel's, not the plan's: set it for this smem
    cudaFuncSetAttribute(kd_kernel<1>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(kd_kernel<2>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaMemsetAsync(ctr, 0, 3 * sizeof(int32_t), s);
    kd_kernel<1><<<blocks1, KD_THREADS, smem, s>>>(
        P, bt, (uint8_t*)scratch, per1, stack1);
    if (stack1 < P.stack_cap)
        kd_kernel<2><<<blocks2, KD_THREADS, smem, s>>>(
            P, bt, (uint8_t*)scratch, per2, P.stack_cap);
    return (int)cudaGetLastError();
}
