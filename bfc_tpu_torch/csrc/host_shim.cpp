// CPU build of the kernels' per-read bodies, for the tests.
//
// Compiled with `g++ -x c++ -D__host__= -D__device__= -O2 -shared -fPIC`
// and loaded with ctypes (tests/test_torch_host_shim.py): each function
// loops over the reads or rows that one CUDA thread would take (for KA
// and KC, whose warps share a read, over the chunks and lanes of a warp,
// with the ballots built lane by lane), with the same arguments as the
// matching *_launch function minus the stream, so the tests can hold the
// CUDA logic against the plain PyTorch versions on a machine without a
// card.
#include "bloom.cuh"
#include "cuckoo.cuh"
#include "ec1_search.cuh"
#include "finalize.cuh"
#include "kcov_island.cuh"
#include "kmer_stream.cuh"
#include "probe.cuh"
#include "route_rows.cuh"
#include "run_combine.cuh"
#include "verdict.cuh"

#include <algorithm>
#include <vector>

// KF and KI: the verdict's steps in the kernels' order.  The count, an
// inclusive scan, the scatter (rows from the last when reverse is set, so
// every segment holds its rows in the other order), then each superblock
// as a verdict CTA takes it: staged (grouped by block, an index a row in
// the scatter's order; blocks of at most VD_PAIR rows a row at a time by
// vd_pair_fp, then group g's larger blocks g, g + VD_NG, ... through the
// three table steps on that group's 512 entries) or read whole (block by
// block, the CTA's one table cleared after each); then the gather.
// Returns the entries left unreset at the end (0).
template <typename A>
static long long vd_host(long long C, const int64_t* ret, const A* arr,
                         const int32_t* n, int bf_shift, int sb, int n_hashes,
                         int reverse, uint8_t* fp, uint8_t* keep) {
    const int NG = VD_THREADS / VD_GROUP;
    uint32_t n_super = 1u << (bf_shift - BFC_BLK_SHIFT - sb), nb = 1u << sb;
    uint32_t* cnt = new uint32_t[n_super]();
    for (long long i = 0; i < C; i++) vd_count_row(i, ret, bf_shift, sb, cnt);
    for (uint32_t q = 1; q < n_super; q++) cnt[q] += cnt[q - 1];
    VdRec<A>* rec = new VdRec<A>[C + 1];
    uint32_t* slot = new uint32_t[C + 1];
    uint8_t* flags = new uint8_t[C + 1];
    for (long long t = 0; t < C; t++)
        vd_scatter_row(reverse ? C - 1 - t : t, ret, arr, n, bf_shift, sb, cnt,
                       rec, slot);
    A* mins = new A[NG * 512];
    for (int j = 0; j < NG * 512; j++) mins[j] = (A)~(A)0;
    uint32_t* bstart = new uint32_t[nb + 1];
    uint16_t* perm = new uint16_t[VD_CAP];
    for (uint32_t q = 0; q < n_super; q++) {
        uint32_t s = cnt[q], m = (q + 1 < n_super ? cnt[q + 1] : C) - s;
        const VdRec<A>* recs = rec + s;
        uint8_t* fl = flags + s;
        if (vd_staged(m, sb)) {
            for (uint32_t b = 0; b <= nb; b++) bstart[b] = 0;
            for (uint32_t r = 0; r < m; r++)
                bstart[vd_local_block(recs[r]) + 1]++;
            for (uint32_t b = 1; b <= nb; b++) bstart[b] += bstart[b - 1];
            for (uint32_t b = 0, p = 0; b < nb; b++)
                for (uint32_t r = 0; r < m; r++)
                    if (vd_local_block(recs[r]) == b) perm[p++] = (uint16_t)r;
            for (uint32_t x = 0; x < m; x++) {
                uint32_t r = perm[x], b = vd_local_block(recs[r]);
                if (bstart[b + 1] - bstart[b] <= VD_PAIR)
                    fl[r] = vd_flag(recs[r],
                                    vd_pair_fp(recs[r], recs, perm, bstart[b],
                                               bstart[b + 1], n_hashes));
            }
            for (int g = 0; g < NG; g++)
                for (uint32_t b = g; b < nb; b += NG) {
                    uint32_t bs = bstart[b], be = bstart[b + 1];
                    if (be - bs <= VD_PAIR) continue;
                    A* t = mins + g * 512;
                    for (uint32_t x = bs; x < be; x++)
                        vd_min_row(recs[perm[x]], n_hashes, t);
                    for (uint32_t x = bs; x < be; x++)
                        fl[perm[x]] = vd_flag(recs[perm[x]],
                                              vd_judge(recs[perm[x]],
                                                       n_hashes, t));
                    for (uint32_t x = bs; x < be; x++)
                        vd_reset_row(recs[perm[x]], n_hashes, t);
                }
        } else {
            for (uint32_t b = 0; b < nb; b++) {
                for (uint32_t r = 0; r < m; r++)
                    if (vd_local_block(recs[r]) == b)
                        vd_min_row(recs[r], n_hashes, mins);
                for (uint32_t r = 0; r < m; r++)
                    if (vd_local_block(recs[r]) == b)
                        fl[r] = vd_flag(recs[r],
                                        vd_judge(recs[r], n_hashes, mins));
                for (int j = 0; j < 512; j++) mins[j] = (A)~(A)0;
            }
        }
    }
    for (long long i = 0; i < C; i++) vd_gather_row(i, slot, flags, fp, keep);
    long long dirty = 0;
    for (int j = 0; j < NG * 512; j++) dirty += mins[j] != (A)~(A)0;
    delete[] cnt;
    delete[] rec;
    delete[] slot;
    delete[] flags;
    delete[] mins;
    delete[] bstart;
    delete[] perm;
    return dirty;
}

extern "C" {

// KA's warp a read: each chunk's four ballot words built lane by lane,
// then each lane's slot cut from the window.
void ka_host(const uint8_t* bases, const uint8_t* qok, const int32_t* lens,
             int B, int L, int k, int l_pre, long long arrival_base,
             int64_t* shard, int64_t* keybody, int64_t* arrp, int64_t* ret) {
    for (int r = 0; r < B; r++) {
        size_t o = (size_t)r * L;
        SlotWin w;
        win_clear(w);
        for (int c0 = 0; c0 < L; c0 += 32) {
            for (int lane = 0; lane < 32; lane++) {
                unsigned c, q;
                slot_load(bases + o, qok + o, lens[r], L, c0 + lane, &c, &q);
                unsigned v = slot_votes(c, q);
                for (int i = 0; i < 4; i++)
                    w.cur[i] = (w.cur[i] & ~(1u << lane)) |
                               (((v >> i) & 1u) << lane);
            }
            for (int lane = 0; lane < 32 && c0 + lane < L; lane++) {
                size_t s = o + c0 + lane;
                ka_slot(w, lane, k, l_pre, (int64_t)arrival_base + (int64_t)s,
                        shard + s, keybody + s, arrp + s,
                        ret ? ret + s : nullptr);
            }
            win_next(w);
        }
    }
}

// KB's tiles of `tile` rows, one after another; lazy: tiles past the
// first publish only their aggregate, so every look-back walks to tile 0.
// Returns the number of groups.
long long kb_host(long long N, long long tile, int lazy, const int64_t* shard,
                  const int64_t* keybody, const int64_t* arr,
                  const int64_t* n, const int64_t* nh, const uint8_t* fh,
                  const int64_t* ret, int64_t* o_shard, int64_t* o_keybody,
                  int64_t* o_arr, int64_t* o_n, int64_t* o_nh, uint8_t* o_fh,
                  int64_t* o_ret) {
    KbCols c = {shard, keybody, arr, n, nh, fh, ret, o_shard, o_keybody,
                o_arr, o_n, o_nh, o_fh, o_ret};
    long long n_tiles = (N + tile - 1) / tile;
    uint64_t* status = new uint64_t[n_tiles + 1]();
    int64_t count = 0;
    for (long long t = 0; t < n_tiles; t++)
        kb_tile_serial(c, N, t, tile, status, lazy, &count);
    delete[] status;
    return count;
}

// KC's warp a read, as kc_launch takes it (table or subtables, a host
// array of 1 << db host addresses): each chunk's ballot words built lane
// by lane, the lanes' probes, their solid and high words, and each
// chunk's lcov and hcov two chunks later.
void kc_host(const uint64_t* table, const uint64_t* const* subtables, int db,
             int k, int l_pre, int kb_bits, int c_bits, int min_cov,
             const uint8_t* bases, const int32_t* lens, int B, int L,
             int32_t* occ, uint8_t* lcov, uint8_t* hcov, int32_t* isl) {
    SpecParams sp = {table, k, l_pre, kb_bits, c_bits, subtables, db};
    int n_chunks = (L + 31) / 32;
    for (int r = 0; r < B; r++) {
        size_t o = (size_t)r * L;
        SlotWin w;
        win_clear(w);
        KcIsland I = {0, 0, -1};
        uint32_t s0 = 0, s1 = 0, h0 = 0, h1 = 0;
        for (int c = 0; c < n_chunks + 2; c++) {
            uint32_t sc = 0, hc = 0;
            if (c < n_chunks) {
                for (int lane = 0; lane < 32; lane++) {
                    unsigned b, q;
                    slot_load(bases + o, nullptr, lens[r], L, 32 * c + lane,
                              &b, &q);
                    unsigned v = slot_votes(b, q);
                    for (int i = 0; i < 3; i++)
                        w.cur[i] = (w.cur[i] & ~(1u << lane)) |
                                   (((v >> i) & 1u) << lane);
                }
                for (int lane = 0; lane < 32; lane++) {
                    int s = 32 * c + lane;
                    if (s >= L) break;
                    int e = kc_occ(sp, w, lane);
                    occ[o + s] = e;
                    sc |= (uint32_t)kc_solid(e, min_cov) << lane;
                    hc |= (uint32_t)kc_high(e, min_cov) << lane;
                }
                kc_island_step(I, sc, 32 * c);
                win_next(w);
            }
            for (int lane = 0; c >= 2 && lane < 32; lane++) {
                int s2 = 32 * (c - 2) + lane;
                if (s2 >= L) break;
                lcov[o + s2] = (uint8_t)kc_window(s0, s1, sc, lane, k);
                hcov[o + s2] = (uint8_t)kc_window(h0, h1, hc, lane, k);
            }
            s0 = s1, s1 = sc, h0 = h1, h1 = hc;
        }
        kc_island_end(I, lens[r], k, isl + 3 * (size_t)r);
    }
}

// KD's two passes as the kernel runs them, each by one worker taking
// every read in turn: pass 1 with a stack of stack1 entries, pass 2 with
// the full stack_cap over the reads pass 1 deferred (*n_deferred).
void kd_host(const uint64_t* table, const uint64_t* const* subtables, int db,
             int k, int l_pre, int kb_bits, int c_bits, const int* ip, int B,
             int L, const uint8_t* bases, const uint8_t* q,
             const int32_t* lens, const uint8_t* lcov, const uint8_t* hcov,
             const int32_t* isl, uint8_t* packed, int32_t* out, int stack1,
             int32_t* n_deferred) {
    KdParams P = {{table, k, l_pre, kb_bits, c_bits, subtables, db},
                  ip[0], ip[1], ip[2], ip[3], ip[4], ip[5], ip[6],
                  ip[7], ip[8], ip[9], ip[10], ip[11]};
    size_t n = (size_t)B * L;
    uint8_t* ec0 = new uint8_t[n + 1];
    uint8_t* ec1 = new uint8_t[n + 1];
    uint8_t* info = new uint8_t[n + 1];
    int32_t ctr[3] = {0, 0, 0};
    int32_t* retry = new int32_t[B + 1];
    KdBatch bt = {B, L, bases, q, lens, lcov, hcov, isl, ec0, ec1, info,
                  packed, out, ctr, retry};
    KdKey* keys = new KdKey[P.heap_cap];
    KdEnt* pool = new KdEnt[P.heap_cap];
    KdStackEnt* stack = new KdStackEnt[P.stack_cap];
    KdScratch S = {keys, 1, pool, stack,
                   stack1 < P.stack_cap ? stack1 : P.stack_cap};
    kd_worker(P, bt, S, 1);
    if (S.stack_cap < P.stack_cap) {
        S.stack_cap = P.stack_cap;
        kd_worker(P, bt, S, 2);
    }
    *n_deferred = ctr[1];
    delete[] keys;
    delete[] pool;
    delete[] stack;
    delete[] retry;
    delete[] ec0;
    delete[] ec1;
    delete[] info;
}

void ke_host(long long C, const int64_t* arr, const int64_t* n,
             const int64_t* nh, const uint8_t* fh, int32_t* a_lo,
             int32_t* nfh) {
    for (long long i = 0; i < C; i++) ke_row(i, arr, n, nh, fh, a_lo, nfh);
}

long long kf_host(long long C, const int64_t* ret, const uint32_t* arr,
                  const int32_t* n, int bf_shift, int sb, int n_hashes,
                  int reverse, uint8_t* fp, uint8_t* keep) {
    return vd_host<uint32_t>(C, ret, arr, n, bf_shift, sb, n_hashes, reverse,
                             fp, keep);
}

// words must hold 2^(bf_shift-5) zeroed entries.
void kg_host(long long C, const int64_t* ret, const uint8_t* keep,
             int bf_shift, int n_hashes, uint32_t* words) {
    for (long long i = 0; i < C; i++)
        kg_row(i, ret, keep, bf_shift, n_hashes, words);
}

// KH's warp a read: each chunk's ballot words built lane by lane, the
// lanes' hits, then each lane's step; the read's answer is the largest of
// its lanes' (the warp's shuffle maximum).
void kh_host(const uint8_t* bases, const int32_t* lens, int B, int L, int k,
             const uint32_t* words, int bf_shift, int n_hashes,
             int64_t* out) {
    for (int r = 0; r < B; r++) {
        const uint8_t* row = bases + (size_t)r * L;
        int n = lens[r] < L ? lens[r] : L;
        SlotWin w;
        win_clear(w);
        KhRun run[32] = {};
        uint64_t best[32] = {};
        for (int base = 0; base < n; base += 32) {
            for (int lane = 0; lane < 32; lane++) {
                unsigned c, q;
                slot_load(row, nullptr, n, L, base + lane, &c, &q);
                unsigned v = slot_votes(c, q);
                for (int i = 0; i < 3; i++)
                    w.cur[i] = (w.cur[i] & ~(1u << lane)) |
                               (((v >> i) & 1u) << lane);
            }
            uint32_t hits = 0;
            for (int lane = 0; lane < 32; lane++)
                hits |= (uint32_t)kh_hit(w, lane, k, words, bf_shift,
                                         n_hashes) << lane;
            for (int lane = 0; lane < 32; lane++)
                kh_step(run[lane], &best[lane], hits, lane, base, n);
            win_next(w);
        }
        uint64_t m = 0;
        for (int lane = 0; lane < 32; lane++)
            m = best[lane] > m ? best[lane] : m;
        out[r] = (int64_t)m;
    }
}

// KH's steps alone over given hit words (hits[c]: chunk c's ballot),
// lane by lane, for a read of len slots.
long long kh_steps_host(const uint32_t* hits, int n_chunks, int len) {
    KhRun run[32] = {};
    uint64_t best[32] = {};
    for (int c = 0; c < n_chunks; c++)
        for (int lane = 0; lane < 32; lane++)
            kh_step(run[lane], &best[lane], hits[c], lane, 32 * c, len);
    uint64_t m = 0;
    for (int lane = 0; lane < 32; lane++) m = best[lane] > m ? best[lane] : m;
    return (long long)m;
}

long long ki_host(long long C, const int64_t* ret, const uint64_t* arr,
                  int bf_shift, int sb, int n_hashes, int reverse,
                  uint8_t* fp) {
    return vd_host<uint64_t>(C, ret, arr, nullptr, bf_shift, sb, n_hashes,
                             reverse, fp, nullptr);
}

void kj_host(long long C, const int64_t* shard, const int64_t* keybody,
             int k, int l_pre, int64_t* ret) {
    for (long long i = 0; i < C; i++) kj_row(i, shard, keybody, k, l_pre, ret);
}

// KK as kk_launch runs it on `blocks` blocks of KK_WARPS warps: the plan
// (kk_plan); each warp's tiles, lane by lane through the warp's staging
// arrays, each step for every lane before the next (the card's
// __syncwarp); the rows outside the tiles one a thread; each warp
// tallying into its own sub-histogram; then each block's flush.  hist
// and hist_high must be zeroed.
void kk_host(long long C, const int64_t* n, const int64_t* n_high,
             const uint8_t* first_high, const uint8_t* fp, int32_t* payload,
             uint8_t* keep, int64_t* hist, int64_t* hist_high, int blocks) {
    KkPlan plan = kk_plan(C, n, n_high, first_high, fp, payload, keep);
    std::vector<uint32_t> sub(KK_WARPS * KK_BINS);
    std::vector<int32_t> spl(KK_TILE);
    std::vector<uint8_t> sfp(KK_TILE), sfh(KK_TILE), skp(KK_TILE);
    const long long rest = C - plan.tiles * KK_TILE;
    for (int blk = 0; blk < blocks; blk++) {
        std::fill(sub.begin(), sub.end(), 0u);
        for (int w = 0; w < KK_WARPS; w++) {
            uint32_t* h = sub.data() + w * KK_BINS;
            for (long long tile = (long long)blk * KK_WARPS + w;
                 tile < plan.tiles; tile += (long long)blocks * KK_WARPS) {
                long long t = plan.head + tile * KK_TILE;
                for (int l = 0; l < 32; l++)
                    kk_tile_stage(t, l, first_high, fp, sfh.data(),
                                  sfp.data());
                for (int l = 0; l < 32; l++)
                    kk_tile_rows(t, l, n, n_high, sfh.data(), sfp.data(),
                                 spl.data(), skp.data(), h);
                for (int l = 0; l < 32; l++)
                    kk_tile_store(t, l, spl.data(), skp.data(), payload,
                                  keep);
            }
            for (int l = 0; l < 32; l++)
                for (long long j = (long long)blk * KK_THREADS + 32 * w + l;
                     j < rest; j += (long long)blocks * KK_THREADS)
                    kk_tally(h, kk_row(kk_rest_row(plan, j), n, n_high,
                                       first_high, fp, payload, keep));
        }
        for (int b = 0; b < KK_BINS; b++)
            kk_flush_bin(sub.data(), KK_WARPS, b, (uint64_t*)hist,
                         (uint64_t*)hist_high);
    }
}

// KK's plan for these columns: (head, tiles).
void kk_plan_host(long long C, const void* n, const void* n_high,
                  const void* first_high, const void* fp, const void* payload,
                  const void* keep, long long* out) {
    KkPlan p = kk_plan(C, n, n_high, first_high, fp, payload, keep);
    out[0] = p.head;
    out[1] = p.tiles;
}

// KL's and KN's window build, phase by phase as kl_launch and kn_launch
// enqueue its kernels (their arguments, cb_local 0 for KL, without the
// stream; then the chains' steps and the window bits wmax: the card's
// are CK_WIN_BITS): meta cleared; for n > 0 the count (the rows in
// order, each writing the starts it reaches), the scan where the flag or
// the gap flag is up, and the scatter where the flag is up; the build,
// window by window, a window's rows chunk by chunk with every row of a
// chunk read before any is placed (the card's threads load theirs, then
// sync where the rows come from the records); for n > 0 the overflow.
void ck_host(long long n, const int64_t* shard, const int64_t* keybody,
             const int32_t* payload, int l_pre, int kb_bits, int c_bits,
             int cb_local, int64_t* meta, int64_t* rec, uint64_t* table,
             int max_steps, int wmax) {
    CkGeom g = {l_pre, kb_bits, c_bits, cb_local};
    int wb = ck_win_bits(g, wmax);
    int64_t nw = ck_windows(g, wmax), W = (int64_t)1 << wb;
    CkMeta m = ck_meta(meta, nw);
    std::fill(meta, meta + CK_HDR + 3 * nw + 1, 0);
    if (n > 0) {
        uint64_t prev = 0;
        for (long long i = 0; i < n; i++) {
            uint64_t w = ck_slot(g, shard[i], keybody[i]) >> wb;
            if (i > 0 && w < prev) m.hdr[CK_FLAG] = 1;
            ck_reach(m, nw, i, n, prev, w);
            m.cursor[w]++;
            prev = w;
        }
        if (m.hdr[CK_FLAG] || m.hdr[CK_GAPS]) {
            ck_scan_write(m, 0, nw, 0);
            m.start[nw] = n;
        }
        if (m.hdr[CK_FLAG])
            for (long long i = 0; i < n; i++)
                rec[2 * m.cursor[ck_slot(g, shard[i], keybody[i]) >> wb]++] =
                    i;
    }
    std::vector<uint64_t> win(W);
    std::vector<int64_t> row(CK_CHUNK);
    for (int64_t b = 0; b < nw; b++) {
        std::fill(win.begin(), win.end(), 0);
        int64_t lo = m.start[b], hi = m.start[b + 1], novf = 0;
        for (int64_t c0 = lo; c0 < hi; c0 += CK_CHUNK) {
            int64_t c1 = c0 + CK_CHUNK < hi ? c0 + CK_CHUNK : hi;
            for (int64_t j = c0; j < c1; j++)
                row[j - c0] = ck_row(rec, m.hdr[CK_FLAG], j);
            for (int64_t j = c0; j < c1; j++) {
                int64_t r = row[j - c0];
                uint64_t slot;
                uint64_t e = ck_entry(g, shard[r], keybody[r], payload[r],
                                      &slot);
                if ((e & 0x3FFF) && !ck_place(win.data(), e, slot, wb))
                    ck_overflow(g, rec, lo + novf++, e, slot);
            }
        }
        m.novf[b] = novf;
        std::copy(win.begin(), win.end(), table + (b << wb));
    }
    if (n > 0)
        for (int64_t b = 0; b < nw; b++)
            for (int64_t p = 0; p < m.novf[b]; p++)
                m.hdr[CK_FAIL] += !ck_insert(g, table, rec, m.start[b] + p,
                                             max_steps);
}

// The sub-table rules of each key: owner, s1, s2 and qlow.
void subtable_slots_host(long long n, const int64_t* shard,
                         const int64_t* keybody, int l_pre, int kb_bits,
                         int c_bits, int db, int64_t* owner, int64_t* s1,
                         int64_t* s2, int64_t* qlow) {
    int cb_local = c_bits - db;
    for (long long i = 0; i < n; i++) {
        uint64_t pk = posk64(shard[i], keybody[i], l_pre, kb_bits);
        uint64_t q = id_low(shard[i], keybody[i], l_pre, kb_bits, c_bits);
        owner[i] = subtable_owner(pk, db);
        s1[i] = (int64_t)subtable_slot(pk, c_bits, cb_local);
        s2[i] = s1[i] ^ (int64_t)subtable_alt(q, cb_local);
        qlow[i] = (int64_t)q;
    }
}

// The lanes of a warp chunk whose destination equals lane j's
// (__match_any_sync).
static unsigned km_peers(const int* d, int j) {
    unsigned m = 0;
    for (int l = 0; l < 32; l++) m |= (unsigned)(d[l] == d[j]) << l;
    return m;
}

// KM's count pass, each tile's counts into off ([R x n_tiles]) and added
// to totals (R, zeroed here), then its scan pass as its blocks run it, a
// destination at a time, thread part by thread part.  N = 0: the
// wrapper launches nothing, every count is 0.
void km_count_host(long long N, int rule, const int64_t* shard,
                   const int64_t* ret, int param, int R, long long n_tiles,
                   int64_t* off, int64_t* totals) {
    for (int d = 0; d < R; d++) totals[d] = 0;
    for (long long t = 0; t < n_tiles; t++) {
        int64_t cnt[KM_MAX_RANKS] = {0};
        for (int w = 0; w < KM_WARPS; w++)
            for (int c = 0; c < KM_CHUNKS; c++)
                for (int l = 0; l < 32; l++) {
                    int d = km_dest_at(rule, shard, ret, km_row(t, w, c, l),
                                       N, param, R);
                    if (d < R) cnt[d]++;
                }
        for (int d = 0; d < R; d++) {
            off[d * n_tiles + t] = cnt[d];
            totals[d] += cnt[d];
        }
    }
    int64_t before = 0;
    for (int d = 0; d < R && n_tiles; d++) {
        int64_t* cnt = off + d * n_tiles;
        int64_t lo[KM_THREADS], hi[KM_THREADS], part[KM_THREADS];
        int64_t base = before;
        for (int tid = 0; tid < KM_THREADS; tid++) {
            km_scan_part(n_tiles, tid, &lo[tid], &hi[tid]);
            part[tid] = km_part_sum(cnt, lo[tid], hi[tid]);
        }
        for (int tid = 0; tid < KM_THREADS; tid++) {
            km_part_write(cnt, lo[tid], hi[tid], base);
            base += part[tid];
        }
        before += totals[d];
    }
}

// KM's scatter pass, tile by tile as its block runs it (off as
// km_count_host leaves it): each warp's chunks ranked lane by lane (all
// lanes read the running count, then the first of each destination adds
// its peers), the (warp, destination) bases, the segments' starts, the
// staged rows, then the slots in order.
void km_scatter_host(long long N, int rule, const int64_t* shard,
                     const int64_t* ret, int param, int R, long long n_tiles,
                     const int64_t* off, const int64_t* in0,
                     const int64_t* in1, const int64_t* in2,
                     const int64_t* in3, int64_t* out0, int64_t* out1,
                     int64_t* out2, int64_t* out3, int64_t* perm) {
    KmCols c = {{in0, in1, in2, in3}, {out0, out1, out2, out3}};
    int wc[KM_WARPS * KM_MAX_RANKS], v[KM_WARPS][KM_CHUNKS][32];
    int seg[KM_MAX_RANKS];
    int64_t base[KM_MAX_RANKS];
    uint16_t row[KM_TILE];
    uint8_t dst[KM_TILE];
    for (long long t = 0; t < n_tiles; t++) {
        for (int e = 0; e < KM_WARPS * KM_MAX_RANKS; e++) wc[e] = 0;
        for (int w = 0; w < KM_WARPS; w++)
            for (int ch = 0; ch < KM_CHUNKS; ch++) {
                int d[32], before[32];
                for (int l = 0; l < 32; l++) {
                    d[l] = km_dest_at(rule, shard, ret, km_row(t, w, ch, l),
                                      N, param, R);
                    before[l] = d[l] < R ? wc[w * KM_MAX_RANKS + d[l]] : 0;
                }
                for (int l = 0; l < 32; l++) {
                    unsigned peers = km_peers(d, l);
                    if (d[l] < R && l == __builtin_ctz(peers))
                        wc[w * KM_MAX_RANKS + d[l]] =
                            before[l] + __builtin_popcount(peers);
                    v[w][ch][l] = km_pack(
                        d[l], before[l] + __builtin_popcount(
                                              peers & ((1u << l) - 1u)));
                }
            }
        int n_keep = 0;
        for (int d = 0; d < R; d++) {
            int tot = km_warp_bases(wc, d);
            seg[d] = n_keep;
            base[d] = off[d * n_tiles + t] - n_keep;
            n_keep += tot;
        }
        for (int w = 0; w < KM_WARPS; w++)
            for (int ch = 0; ch < KM_CHUNKS; ch++)
                for (int l = 0; l < 32; l++) {
                    int d = km_pack_dest(v[w][ch][l]);
                    if (d >= R) continue;
                    int pos = seg[d] + wc[w * KM_MAX_RANKS + d] +
                              km_pack_rank(v[w][ch][l]);
                    row[pos] = (uint16_t)km_tile_row(w, ch, l);
                    dst[pos] = (uint8_t)d;
                }
        for (int j = 0; j < KM_COLS; j++)
            for (int s = 0; c.in[j] && s < n_keep; s++)
                c.out[j][km_slot_pos(s, dst, base)] =
                    c.in[j][km_slot_row(t, s, row)];
        for (int s = 0; s < n_keep; s++)
            perm[km_slot_pos(s, dst, base)] = km_slot_row(t, s, row);
    }
}

void probe_bits_host(long long C, const int64_t* ret, int bf_shift,
                     int n_hashes, int64_t* out) {
    for (long long i = 0; i < C; i++)
        bloom_probe_bits((uint64_t)ret[i], bf_shift, n_hashes,
                         (uint64_t*)out + i * n_hashes);
}

// The probe kernels KO-KR: one query, element or row (or, for KQ's
// register variant, each of a row's 32 lanes) at a time.
void ko_host(long long Q, const int32_t* tab, long long N, const int32_t* idx,
             int steps, int32_t* v, int32_t* ix) {
    for (long long q = 0; q < Q; q++)
        ko_query(tab, (uint32_t)(N - 1), idx[q], steps, v + q, ix + q);
}

// KP row mode as kp_row_launch runs it: each query's chain on the table,
// then its row copied lane by lane.
void kp_row_host(long long Q, const int32_t* tab, long long rows,
                 const int32_t* idx, int steps, int32_t* out, int32_t* ix) {
    uint32_t mask = (uint32_t)(rows - 1);
    for (long long q = 0; q < Q; q++) {
        uint32_t r = kp_row_chain(tab, mask, idx[q], steps);
        for (int lane = 0; lane < 32; lane++)
            kp_row_copy(tab, mask, r, lane, out + q * PROBE_W, ix + q);
    }
}

// KP column mode as kp_column_launch runs it.  staged = 1: each pair of
// groups of KP_COLS lanes staged, half by half, KP_STAGE_UNROLL rows at a
// time (as the two blocks of a cluster hold them), then each query's
// chains of each group walked together; staged = 0: each element's chain
// walked in the table.
void kp_column_host(long long Q, const int32_t* tab, long long rows,
                    const int32_t* idx, int steps, int staged, int32_t* v,
                    int32_t* ix) {
    uint32_t mask = (uint32_t)(rows - 1);
    if (!staged) {
        for (long long e = 0; e < Q * PROBE_W; e++)
            kp_col_elem(tab, mask, (int)(e % PROBE_W), idx, (size_t)e, steps,
                        v, ix);
        return;
    }
    std::vector<int32_t> col(2 * rows * KP_COLS);
    for (int p0 = 0; p0 < PROBE_W; p0 += 2 * KP_COLS) {
        for (int h = 0; h < 2; h++)
            for (uint32_t r = 0; r < (uint32_t)rows; r += KP_STAGE_UNROLL)
                kp_col_stage(tab, p0, h, (uint32_t)rows, r, 1,
                             (uint32_t)rows, col.data() + h * rows * KP_COLS);
        for (int h = 0; h < 2; h++)
            for (long long q = 0; q < Q; q++) {
                size_t e = (size_t)q * PROBE_W + p0 + h * KP_COLS;
                kp_col_chains(col.data() + h * rows * KP_COLS, (uint32_t)rows,
                              mask, idx + e, steps, v + e, ix + e);
            }
    }
}

void kp_lane_host(long long rows, const int32_t* tab, const int32_t* idx,
                  int steps, int32_t* v, int32_t* ix) {
    for (long long e = 0; e < rows * PROBE_W; e++)
        kp_lane_elem(tab + e / PROBE_W * PROBE_W, idx[e], steps, v + e,
                     ix + e);
}

// KQ as kq_*_launch runs it: blocks of KQ_ROWS rows, a warp a row (rows
// past B left alone), each lane's four columns read from x and written
// to out; the shared variant stages the row (its shared memory) and
// applies its lanes' passes one after another.
void kq_registers_host(long long B, const int32_t* x, const int32_t* pos,
                       int steps, int32_t* out) {
    for (long long blk = 0; blk * KQ_ROWS < B; blk++)
        for (int w = 0; w < KQ_ROWS; w++) {
            long long b = blk * KQ_ROWS + w;
            if (b >= B) continue;
            for (int lane = 0; lane < 32; lane++) {
                int32_t r[4];
                probe_load4(x + b * PROBE_W + 4 * lane, r);
                kq_lane(r, lane, pos[b], steps);
                probe_store4(out + b * PROBE_W + 4 * lane, r);
            }
        }
}

void kq_shared_host(long long B, const int32_t* x, const int32_t* pos,
                    int steps, int32_t* out) {
    for (long long blk = 0; blk * KQ_ROWS < B; blk++)
        for (int w = 0; w < KQ_ROWS; w++) {
            long long b = blk * KQ_ROWS + w;
            if (b >= B) continue;
            int32_t row[PROBE_W];
            for (int lane = 0; lane < 32; lane++)
                probe_load4(x + b * PROBE_W + 4 * lane, row + 4 * lane);
            for (int lane = 0; lane < 32; lane++)
                kq_pass(row, lane, pos[b], steps);
            for (int lane = 0; lane < 32; lane++)
                probe_store4(out + b * PROBE_W + 4 * lane, row + 4 * lane);
        }
}

// KR as kr_launch runs it, a query at a time on the eager route (lazy 0)
// or the lazy one (lazy 1).
void kr_host(long long Q, const int32_t* lo, const int32_t* hi, long long N,
             const int32_t* idx, int steps, int lazy, int32_t* v,
             int32_t* ix) {
    uint32_t mask = (uint32_t)(N - 1);
    for (long long q = 0; q < Q; q++)
        (lazy ? kr_lazy_query : kr_query)(lo, hi, mask, idx[q], steps, v + q,
                                          ix + q);
}

}  // extern "C"
