// CPU build of the kernels' per-read bodies, for the tests.
//
// Compiled with `g++ -x c++ -D__host__= -D__device__= -O2 -shared -fPIC`
// and loaded with ctypes (tests/test_torch_host_shim.py): each function
// loops over the reads or rows that one CUDA thread would take, with the
// same arguments as the matching *_launch function minus the stream, so
// the tests can hold the CUDA logic against the plain PyTorch versions
// on a machine without a card.
#include "ec1_search.cuh"
#include "kcov_island.cuh"
#include "kmer_stream.cuh"
#include "run_combine.cuh"

extern "C" {

void ka_host(const uint8_t* bases, const uint8_t* qok, const int32_t* lens,
             int B, int L, int k, int l_pre, long long arrival_base,
             int64_t* shard, int64_t* keybody, int64_t* arrp, int64_t* ret) {
    for (int r = 0; r < B; r++) {
        size_t o = (size_t)r * L;
        ka_read(bases + o, qok + o, lens[r], L, k, l_pre,
                (int64_t)arrival_base + (int64_t)o, shard + o, keybody + o,
                arrp + o, ret ? ret + o : nullptr);
    }
}

void kb_head_host(const int64_t* shard, const int64_t* keybody, long long N,
                  int32_t* head) {
    for (long long i = 0; i < N; i++) head[i] = kb_head(shard, keybody, i);
}

void kb_combine_host(long long N, const int32_t* head, const int64_t* cum,
                     const int64_t* shard, const int64_t* keybody,
                     const int64_t* arr, const int64_t* n, const int64_t* nh,
                     const uint8_t* fh, const int64_t* ret, int64_t* o_shard,
                     int64_t* o_keybody, int64_t* o_arr, int64_t* o_n,
                     int64_t* o_nh, uint8_t* o_fh, int64_t* o_ret) {
    for (long long i = 0; i < N; i++)
        kb_combine(i, N, head, cum, shard, keybody, arr, n, nh, fh, ret,
                   o_shard, o_keybody, o_arr, o_n, o_nh, o_fh, o_ret);
}

void kc_host(const uint64_t* table, int k, int l_pre, int kb_bits,
             int c_bits, int min_cov, const uint8_t* bases,
             const int32_t* lens, int B, int L, int32_t* occ, uint8_t* lcov,
             uint8_t* hcov, int32_t* isl) {
    SpecParams sp = {table, k, l_pre, kb_bits, c_bits};
    for (int r = 0; r < B; r++) {
        size_t o = (size_t)r * L;
        kc_read(sp, min_cov, bases + o, lens[r], L, occ + o, lcov + o,
                hcov + o, isl + 3 * (size_t)r);
    }
}

void kd_host(const uint64_t* table, int k, int l_pre, int kb_bits,
             int c_bits, const int* ip, int B, int L, const uint8_t* bases,
             const uint8_t* q, const int32_t* lens, const uint8_t* lcov,
             const uint8_t* hcov, const int32_t* isl, uint8_t* packed,
             int32_t* out) {
    KdParams P = {{table, k, l_pre, kb_bits, c_bits},
                  ip[0], ip[1], ip[2], ip[3], ip[4], ip[5], ip[6],
                  ip[7], ip[8], ip[9], ip[10], ip[11]};
    KdHeapEnt* heap = new KdHeapEnt[P.heap_cap];
    KdStackEnt* stack = new KdStackEnt[P.stack_cap];
    uint8_t* ec0 = new uint8_t[L];
    uint8_t* ec1 = new uint8_t[L];
    for (int r = 0; r < B; r++) {
        size_t o = (size_t)r * L;
        kd_read(P, L, bases + o, q + o, lcov + o, hcov + o, lens[r],
                isl + 3 * (size_t)r, ec0, ec1, heap, stack, packed + o,
                out + (size_t)KD_N_OUT * r);
    }
    delete[] heap;
    delete[] stack;
    delete[] ec0;
    delete[] ec1;
}

}  // extern "C"
