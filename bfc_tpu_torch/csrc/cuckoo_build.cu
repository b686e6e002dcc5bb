// KL: the two-slot cuckoo table that every probe reads (cuckoo.cuh).
//
// Replaces bfc_tpu/ops/spectrum.py:cuckoo_build_device (:543).  The TPU
// placed all keys in synchronous rounds, each a scatter-max over the whole
// table that picked one winner a slot.  Here one thread a key swaps its
// entry into its first slot with atomicExch and carries any entry it
// evicts to that entry's other slot (cuckoo.cuh:cuckoo_insert); the
// chains run concurrently and each exchange is atomic.  A chain that
// reaches KL_MAX_STEPS drops the entry in hand and counts a failure; the
// caller then builds again one bit larger.  The layout depends on the
// order of the exchanges and differs from run to run and from the plain
// version's; lookups do not (each key sits in one of its two slots with
// the matching nest bit).  The table must be zeroed (payload 0 = empty).
//
// Bound: bytes.  20 bytes read a key, the 8 * 2^c_bits-byte table zeroed
// and at least one random 32-byte sector written a key.
#include "cuckoo.cuh"

#include <cuda_runtime.h>

#define KL_MAX_STEPS 1000

__global__ void kl_kernel(long long n, const int64_t* shard,
                          const int64_t* keybody, const int32_t* payload,
                          int l_pre, int kb_bits, int c_bits,
                          uint64_t* table, int* fail) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint64_t slot;
    uint64_t e = cuckoo_entry(shard[i], keybody[i], payload[i], l_pre,
                              kb_bits, c_bits, &slot);
    if (!cuckoo_insert(table, e, slot, c_bits, KL_MAX_STEPS))
        atomicAdd(fail, 1);
}

extern "C" int kl_launch(long long n, const void* shard, const void* keybody,
                         const void* payload, int l_pre, int kb_bits,
                         int c_bits, void* table, void* fail, void* stream) {
    if (n > 0)
        kl_kernel<<<(int)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
            n, (const int64_t*)shard, (const int64_t*)keybody,
            (const int32_t*)payload, l_pre, kb_bits, c_bits,
            (uint64_t*)table, (int*)fail);
    return (int)cudaGetLastError();
}
