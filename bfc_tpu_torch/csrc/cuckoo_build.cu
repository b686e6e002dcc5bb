// KL: the two-slot cuckoo table that every probe reads (cuckoo.cuh).
//
// Replaces bfc_tpu/ops/spectrum.py:cuckoo_build_device (:543).  The TPU
// placed all keys in synchronous rounds, each a scatter-max over the whole
// table that picked one winner a slot.  Here the keys are grouped by
// window of 2^12 slots and each window is built in shared memory (the
// steps in cuckoo.cuh, the kernels in cuckoo_window.cuh): a key takes its
// first slot with a shared-memory CAS, the window goes to the table in
// coalesced stores, and only the keys whose first slot was taken (12.6%
// at the main fold's load of 0.275) run ck_insert's chain of global
// atomic exchanges afterwards.  The callers pass the keys sorted by
// (shard, keybody), so a window's keys are one run of rows and the
// scatter that would group them returns at once; keys in any order are
// grouped by it.  A chain that reaches KL_MAX_STEPS drops the entry in
// hand and counts a failure; the caller then builds again one bit larger.
// The layout depends on the order of the exchanges and differs from the
// plain version's; lookups do not (each key sits in one of its two slots
// with the matching nest bit).
//
// Bound: bytes.  20 bytes read a key and the 8 * 2^c_bits-byte table
// written once.  The first design also cleared the table before it ran
// and paid a random 32-byte sector a key for its atomic exchange; this
// one writes each slot once, by the window pass, and reads the keys
// twice (shard and keybody in the count, all 20 bytes in the build).
#include "cuckoo_window.cuh"

#define KL_MAX_STEPS 1000

// The build's launches (cuckoo_window.cuh:ck_launch): the counters
// cleared, then the count, scatter, build and overflow kernels (the build
// alone for n = 0).  meta and rec: spectrum.cuckoo_scratch's.
extern "C" int kl_launch(long long n, const void* shard, const void* keybody,
                         const void* payload, int l_pre, int kb_bits,
                         int c_bits, void* meta, void* rec, void* table,
                         void* stream) {
    return ck_launch(n, shard, keybody, payload, {l_pre, kb_bits, c_bits, 0},
                     meta, rec, table, KL_MAX_STEPS, stream);
}
