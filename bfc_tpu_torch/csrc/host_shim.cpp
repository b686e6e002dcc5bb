// CPU build of the kernels' per-read bodies, for the tests.
//
// Compiled with `g++ -x c++ -D__host__= -D__device__= -O2 -shared -fPIC`
// and loaded with ctypes (tests/test_torch_host_shim.py): each function
// loops over the reads or rows that one CUDA thread would take, with the
// same arguments as the matching *_launch function minus the stream, so
// the tests can hold the CUDA logic against the plain PyTorch versions
// on a machine without a card.
#include "bloom.cuh"
#include "cuckoo.cuh"
#include "ec1_search.cuh"
#include "finalize.cuh"
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

void ke_host(long long C, const int64_t* arr, const int64_t* n,
             const int64_t* nh, const uint8_t* fh, int32_t* a_lo,
             int32_t* nfh) {
    for (long long i = 0; i < C; i++) ke_row(i, arr, n, nh, fh, a_lo, nfh);
}

// KF's two passes in order; dense must hold 2^bf_shift zeroed entries.
void kf_host(long long C, const int64_t* ret, const int32_t* arr,
             const int32_t* n, int bf_shift, int n_hashes, uint32_t* dense,
             uint8_t* fp, uint8_t* keep) {
    for (long long i = 0; i < C; i++)
        kf_scatter_row(i, ret, arr, bf_shift, n_hashes, dense);
    for (long long i = 0; i < C; i++)
        kf_verdict_row(i, ret, arr, n, bf_shift, n_hashes, dense, fp, keep);
}

// words must hold 2^(bf_shift-5) zeroed entries.
void kg_host(long long C, const int64_t* ret, const uint8_t* keep,
             int bf_shift, int n_hashes, uint32_t* words) {
    for (long long i = 0; i < C; i++)
        kg_row(i, ret, keep, bf_shift, n_hashes, words);
}

void kh_host(const uint8_t* bases, const int32_t* lens, int B, int L, int k,
             const uint32_t* words, int bf_shift, int n_hashes,
             int64_t* out) {
    for (int r = 0; r < B; r++)
        out[r] = kh_read(bases + (size_t)r * L, lens[r], k, words, bf_shift,
                         n_hashes);
}

void ki_host(long long n_blocks, const int64_t* starts, const int64_t* perm,
             const int64_t* ret, const int64_t* arr, int bf_shift,
             int n_hashes, uint8_t* fp) {
    uint32_t bm[16];
    for (long long s = 0; s < n_blocks; s++)
        ki_block(starts[s], starts[s + 1], perm, ret, arr, bf_shift,
                 n_hashes, bm, fp);
}

void kj_host(long long C, const int64_t* shard, const int64_t* keybody,
             int k, int l_pre, int64_t* ret) {
    for (long long i = 0; i < C; i++) kj_row(i, shard, keybody, k, l_pre, ret);
}

// hist and hist_high must be zeroed.
void kk_host(long long C, const int64_t* n, const int64_t* n_high,
             const uint8_t* first_high, const uint8_t* fp, int32_t* payload,
             uint8_t* keep, int64_t* hist, int64_t* hist_high) {
    for (long long i = 0; i < C; i++) {
        int32_t p = kk_row(i, n, n_high, first_high, fp, payload, keep);
        if (p) {
            hist[p & 255]++;
            hist_high[p >> 8]++;
        }
    }
}

// KL's inserts one key after another into a zeroed table; returns the
// number of keys whose chain failed.
int kl_host(long long n, const int64_t* shard, const int64_t* keybody,
            const int32_t* payload, int l_pre, int kb_bits, int c_bits,
            uint64_t* table, int max_steps) {
    int fail = 0;
    for (long long i = 0; i < n; i++) {
        uint64_t slot;
        uint64_t e = cuckoo_entry(shard[i], keybody[i], payload[i], l_pre,
                                  kb_bits, c_bits, &slot);
        fail += !cuckoo_insert(table, e, slot, c_bits, max_steps);
    }
    return fail;
}

void probe_bits_host(long long C, const int64_t* ret, int bf_shift,
                     int n_hashes, int64_t* out) {
    for (long long i = 0; i < C; i++)
        bloom_probe_bits((uint64_t)ret[i], bf_shift, n_hashes,
                         (uint64_t*)out + i * n_hashes);
}

}  // extern "C"
