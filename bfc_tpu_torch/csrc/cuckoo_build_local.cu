// KN: one rank's cuckoo sub-table of the prefix-sharded table, and the
// memory that lets the other ranks read it.
//
// Replaces bfc_tpu/ops/spectrum.py:cuckoo_build_local (:467), which
// parallel/mesh.py:_build_sharded_table (:589) ran on every device of the
// mesh.  The TPU placed a device's keys in synchronous rounds of
// scatter-max winners; here KL's window build runs with the sub-table's
// slot rule and alternate hash (cuckoo.cuh:ck_slot and ck_alt at
// cb_local), straight into the exportable allocation: the keys grouped by
// window of 2^12 slots, each window built in shared memory and written
// out whole, then the keys whose first slot was taken inserted by
// ck_insert's chains.  A chain that reaches KN_MAX_STEPS drops the
// entry in hand and counts a failure; the ranks then agree to build again
// one bit larger.  The layout depends on the order of the exchanges;
// lookups do not.
//
// Bound: bytes.  20 bytes read a key and the 8 * 2^cb_local-byte table
// written once (the first design also cleared it first and paid a random
// 32-byte sector a key).
//
// The sub-table lives in an allocation of its own (kn_alloc, cudaMalloc),
// never in a block of PyTorch's caching allocator: an IPC handle names the
// base of an allocation, so a tensor at an offset inside a larger block
// could not be exported.  kn_export writes its handle, which the ranks
// all-gather; kn_open maps a peer's sub-table into this process (peer
// access over NVLink enabled lazily; the same HBM when ranks share a card);
// kn_close unmaps it, and only then may its owner kn_free it.  Each entry
// point makes `device` current for its call and restores the caller's.
#include "cuckoo_window.cuh"

#include <string.h>

#define KN_MAX_STEPS 1000

// KL's launches with the sub-table's rules (cuckoo_window.cuh:
// ck_launch), straight into the sub-table.
extern "C" int kn_launch(long long n, const void* shard, const void* keybody,
                         const void* payload, int l_pre, int kb_bits,
                         int c_bits, int cb_local, void* meta, void* rec,
                         void* table, void* stream) {
    return ck_launch(n, shard, keybody, payload,
                     {l_pre, kb_bits, c_bits, cb_local}, meta, rec, table,
                     KN_MAX_STEPS, stream);
}

// Runs f with `device` current, then makes the caller's device current
// again; returns f's error, else the restore's.
template <typename F>
static int kn_on(int device, F f) {
    int old = 0;
    cudaError_t rc = cudaGetDevice(&old);
    if (rc != cudaSuccess) return (int)rc;
    rc = cudaSetDevice(device);
    if (rc != cudaSuccess) return (int)rc;
    cudaError_t out = f();
    rc = cudaSetDevice(old);
    return (int)(out != cudaSuccess ? out : rc);
}

extern "C" int kn_handle_bytes(int* n) {
    *n = (int)sizeof(cudaIpcMemHandle_t);
    return 0;
}

extern "C" int kn_alloc(int device, long long bytes, void** ptr) {
    return kn_on(device, [&] { return cudaMalloc(ptr, (size_t)bytes); });
}

extern "C" int kn_free(int device, void* ptr) {
    return kn_on(device, [&] { return cudaFree(ptr); });
}

extern "C" int kn_export(int device, void* ptr, void* handle) {
    return kn_on(device, [&] {
        cudaIpcMemHandle_t h;
        cudaError_t rc = cudaIpcGetMemHandle(&h, ptr);
        memcpy(handle, &h, sizeof h);
        return rc;
    });
}

extern "C" int kn_open(int device, const void* handle, void** ptr) {
    return kn_on(device, [&] {
        cudaIpcMemHandle_t h;
        memcpy(&h, handle, sizeof h);
        return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
    });
}

extern "C" int kn_close(int device, void* ptr) {
    return kn_on(device, [&] { return cudaIpcCloseMemHandle(ptr); });
}
