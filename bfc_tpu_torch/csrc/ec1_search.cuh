// KD per-read body: the whole correction of one read (bfc_ec1), and the
// persistent read loop a thread of the kernel runs.
//
// A direct translation of bfc_tpu/models/refmodel.py:ec1 (:818) and
// ec1dir (:579), which are the semantic spec (correct.c:63-472): the
// many-N gate, the greedy single-substitution seed when no solid island
// exists, the best-first penalty search in both directions with the
// ksort.h heap's exact tie order, the backtrack, and the direction merge.
//
// Laid out for the card:
// - The heap holds 4-byte keys (tot, pool slot), sifted by ks_heapup /
//   ks_heapdown on tot alone, so ties break as the reference's do.  On
//   the card the keys live in shared memory, interleaved across the
//   block's threads (key p of a thread at p * kstride): 512 bytes a
//   thread at heap_cap 128.  An entry's state (k-mer planes, position,
//   stack index, edit history) goes into a pool slot of the thread's
//   scratch and never moves.  The key array's unused tail keeps the free
//   slots: position p >= hn holds the slot that a push at p takes, and a
//   pop leaves its slot at the end of the heap, so the array stays a
//   permutation of the pool slots.  One entry lives in registers instead
//   of its pool slot: the step's cheapest push, written back only when a
//   cheaper push displaces it.  Along a clean stretch of a read each step
//   pushes one entry and the next pop takes it, so it never touches
//   scratch.
// - A search step probes together every k-mer the spec will probe: the
//   read's own base and, where its count cannot decide `fixed`, every
//   alternative the window checks let through.  It computes all their
//   slots, issues all their table loads (both slots each) and only then
//   applies the spec's decisions.  Where the own base's count can fix
//   the step (a high-quality base over solid coverage: nearly every step
//   of a read), the alternatives wait for it and are probed together in
//   a second round only if it does not, so every load is one the spec
//   makes and KD_PROBES stays the spec's probe count.  Probes and pushes
//   go by ordinal (a thread's j-th base), not by base, so a warp whose
//   threads each take a different base runs one hash and one push a
//   thread, not four.  The greedy repair issues the three substitutions
//   of a position together.  Probes are counted in a register and out[]
//   is written once.
// - A step reads one info byte of its read (base, quality and the two
//   coverage tests), which kd_read_cols packs once a read.
// - A thread takes reads from a global counter until the batch is done
//   (kd_worker).  Pass 1 gives a read a stack of `stack_cap` of its
//   scratch (KD_STACK1 on the card); a read that needs more is deferred,
//   and pass 2 runs it again from the start with the full cap.  A read
//   that fits the smaller stack runs exactly as it would with the full
//   one, so the results, and the reads that overflow the full caps to the
//   scalar fallback, are those of one pass at the full caps.
#pragma once
#include "cuckoo.cuh"

#define KD_EC_HIST 5
#define KD_EC_HIST_HIGH 2
#define KD_MAX_PATHS 4
#define KD_STACK1 512  // pass 1's stack a thread (a 100 bp read takes ~100)

struct KdParams {
    SpecParams sp;
    int min_cov, win_multi_ec, max_end_ext;
    int w_ec, w_ec_high, w_absent, w_absent_high;
    int max_path_diff, max_heap, mode;
    int heap_cap, stack_cap;
};

// A heap key: tot << KD_SLOT_BITS | pool slot (past the heap, a free
// slot).  The heap orders keys by tot alone (ks_heapup's lt(a, b) =
// a.tot > b.tot), never by slot.  The caller keeps heap_cap within
// 1 << KD_SLOT_BITS and every total below 1 << (31 - KD_SLOT_BITS)
// (search.py checks both).
typedef uint32_t KdKey;
#define KD_SLOT_BITS 7

BFC_HD int kd_tot(KdKey a) { return (int)(a >> KD_SLOT_BITS); }
BFC_HD int kd_slot(KdKey a) { return (int)(a & ((1u << KD_SLOT_BITS) - 1)); }
BFC_HD KdKey kd_key(int tot, int slot) {
    return (uint32_t)tot << KD_SLOT_BITS | (uint32_t)slot;
}

// A heap entry's state, written once into its pool slot.
struct KdEnt {
    uint64_t x[4];
    int32_t i;     // next position
    int32_t k;     // stack index of the last step, -1 for the root
    int32_t eph[KD_EC_HIST_HIGH];  // positions of recent high-q edits
    int32_t ep[KD_EC_HIST];        // positions of recent edits
};

struct KdStackEnt {
    int32_t parent;
    int32_t tot;
    int32_t i;
    uint8_t b, pen_ec, pen_absent, pad;
};

// One thread's scratch: heap_cap keys (kstride apart), heap_cap pool
// slots and a stack of stack_cap entries.
struct KdScratch {
    KdKey* keys;
    int kstride;
    KdEnt* pool;
    KdStackEnt* stack;
    int stack_cap;
};

// Output columns of one read.
// KD_PROBES counts the read's table probes (zero when it overflowed),
// which the roofline bound of the search needs.
enum { KD_EC_CODE, KD_BRUTE, KD_N_EC, KD_N_EC_HIGH, KD_N_ABSENT,
       KD_MAX_HEAP, KD_OVERFLOW, KD_PROBES, KD_N_OUT };

enum { KD_DONE, KD_DEFER };

// One read as bfc_ec1 sees it: bases after the greedy fix at fix_pos,
// read forward or (rev) reverse-complemented.  info holds a byte a base
// (kd_read_cols fills it): the base code, then the flags KD_Q (quality),
// KD_SOLID (lcov >= min_cov + 1) and KD_HIGH (hcov > 0.75 k), so a search
// step reads one byte where it would read four arrays.
struct KdRead {
    const uint8_t* info;
    int n, fix_pos, fix_b, rev;
};

#define KD_Q 8
#define KD_SOLID 16
#define KD_HIGH 32

BFC_HD int kd_idx(const KdRead& s, int i) { return s.rev ? s.n - 1 - i : i; }

// Bit counts of a base mask (bit b: base b).
BFC_HD int kd_popc(int m) {
#ifdef __CUDA_ARCH__
    return __popc(m);
#else
    return __builtin_popcount(m);
#endif
}

BFC_HD int kd_low_bit(int m) {  // index of the lowest set bit, m != 0
#ifdef __CUDA_ARCH__
    return __ffs(m) - 1;
#else
    return __builtin_ffs(m) - 1;
#endif
}

// The info byte of position i as the direction reads it: its base code
// after the fix and the reverse complement, and its flags.
BFC_HD int kd_at(const KdRead& s, int i) {
    int j = kd_idx(s, i);
    int v = s.info[j];
    int c = j == s.fix_pos ? s.fix_b : v & 7;
    if (s.rev) c = c < 4 ? 3 - c : 4;
    return (v & ~7) | c;
}

BFC_HD int kd_b(const KdRead& s, int i) { return kd_at(s, i) & 7; }

// ks_heapup with lt(a, b) = a.tot > b.tot (ksort.h:137-146).
BFC_HD void kd_heap_up(KdKey* h, int st, int hn) {
    int k = hn - 1;
    KdKey tmp = h[k * st];
    while (k) {
        int i = (k - 1) >> 1;
        KdKey p = h[i * st];
        if (kd_tot(tmp) > kd_tot(p)) break;
        h[k * st] = p;
        k = i;
    }
    h[k * st] = tmp;
}

// ks_heapdown from the root (ksort.h:125-136).
BFC_HD void kd_heap_down(KdKey* h, int st, int n) {
    int i = 0, k = 0;
    KdKey tmp = h[0];
    while (1) {
        k = (k << 1) + 1;
        if (k >= n) break;
        if (k != n - 1 && kd_tot(h[k * st]) > kd_tot(h[(k + 1) * st])) k++;
        KdKey c = h[k * st];
        if (kd_tot(c) > kd_tot(tmp)) break;
        h[i * st] = c;
        i = k;
    }
    h[i * st] = tmp;
}

struct KdStep {
    int b, pen_ec, pen_ec_high, pen_absent, pen_absent_high;
};

BFC_HD int kd_weight(const KdParams& P, const KdStep& a) {
    return P.w_ec * a.pen_ec + P.w_ec_high * a.pen_ec_high +
           P.w_absent * a.pen_absent + P.w_absent_high * a.pen_absent_high;
}

// The heap of one direction: the key and stack counts, and the entry
// kept in registers (cache_slot >= 0), whose pool slot is not written.
struct KdHeap {
    int hn, sn;
    int cache_slot;
    int cache_tot;
    KdEnt cache;
};

// buf_update (correct.c:198-230): push step a from state z (total ztot).
// Returns 0 when the heap or the stack is full.
BFC_HD int kd_push(const KdParams& P, const KdEnt& z, int ztot,
                   const KdStep& a, KdScratch& S, KdHeap& H) {
    if (H.sn >= S.stack_cap || H.hn >= P.heap_cap) return 0;
    int tot = ztot + kd_weight(P, a);
    KdStackEnt st;
    st.parent = z.k;
    st.tot = tot;
    st.i = z.i;
    st.b = (uint8_t)a.b;
    st.pen_ec = (uint8_t)a.pen_ec;
    st.pen_absent = (uint8_t)a.pen_absent;
    st.pad = 0;
    S.stack[H.sn] = st;
    KdEnt e;
    for (int t = 0; t < 4; t++) e.x[t] = z.x[t];
    kmer_append(e.x, a.b, P.sp.k);
    e.i = z.i + 1;
    e.k = H.sn;
    if (a.pen_ec_high) {
        e.eph[0] = z.i;
        for (int t = 1; t < KD_EC_HIST_HIGH; t++) e.eph[t] = z.eph[t - 1];
    } else {
        for (int t = 0; t < KD_EC_HIST_HIGH; t++) e.eph[t] = z.eph[t];
    }
    if (a.pen_ec) {
        e.ep[0] = z.i;
        for (int t = 1; t < KD_EC_HIST; t++) e.ep[t] = z.ep[t - 1];
    } else {
        for (int t = 0; t < KD_EC_HIST; t++) e.ep[t] = z.ep[t];
    }
    KdKey* key = S.keys + H.hn * S.kstride;
    int slot = kd_slot(*key);
    *key = kd_key(tot, slot);
    // keep the cheapest push in registers (a later push at an equal total
    // passes an earlier one in the sift-up); write back what it displaces
    if (H.cache_slot < 0 || tot <= H.cache_tot) {
        if (H.cache_slot >= 0) S.pool[H.cache_slot] = H.cache;
        H.cache_slot = slot;
        H.cache_tot = tot;
        H.cache = e;
    } else {
        S.pool[slot] = e;
    }
    H.sn++;
    H.hn++;
    kd_heap_up(S.keys, S.kstride, H.hn);
    return 1;
}

// Probes the k-mers x + b for every base b in mask together: every slot
// address first, then every load, then the picks.  The probes go by
// ordinal (the j-th base of the mask), not by base, so a warp whose
// threads probe one base each, all different, computes one hash a thread
// rather than four.  Returns the payloads packed 16 bits a base (b at bit
// 16 b; -1, absent, as 0xFFFF); kd_occ unpacks one.
BFC_HD uint64_t kd_probe_bases(const SpecParams& sp, const uint64_t x[4],
                               int mask) {
    const int n = kd_popc(mask);
    int bs[4];
    ProbeAddr pa[4];
    uint64_t e1[4], e2[4];
#pragma unroll
    for (int j = 0; j < 4; j++) {
        if (j < n) {
            bs[j] = kd_low_bit(mask);
            mask &= mask - 1;
            uint64_t x2[4] = {x[0], x[1], x[2], x[3]};
            kmer_append(x2, bs[j], sp.k);
            pa[j] = kmer_addr(sp, x2);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; j++) {
        if (j < n) {
            e1[j] = table_load(pa[j].p1);
            e2[j] = table_load(pa[j].p2);
        }
    }
    uint64_t occ = 0;
#pragma unroll
    for (int j = 0; j < 4; j++)
        if (j < n)
            occ |= (uint64_t)(cuckoo_pick(e1[j], e2[j], pa[j].qlow) & 0xFFFF)
                   << (16 * bs[j]);
    return occ;
}

BFC_HD int kd_occ(uint64_t occ, int b) {
    return (int)(int16_t)(uint16_t)(occ >> (16 * b));
}

// bfc_ec1dir (correct.c:249-386) over [start, n): fills ec[0, n) with the
// corrected bases (4 = masked), sets *max_heap, adds the spec's table
// probes to probes, and returns n_absent >= 0 or the reference failure
// code -1 / -2 / -3.  Sets *ovf and returns -1 when the scratch capacity
// is exceeded.
BFC_HD int kd_ec1dir(const KdParams& P, const KdRead& s, int start,
                     uint8_t* ec, KdScratch& S, int* max_heap, int* ovf,
                     int& probes) {
    const int k = P.sp.k, n = s.n, end = n;
    const int ks = S.kstride;
    int max_heap_seen = 0;
    int paths[KD_MAX_PATHS];
    int n_paths = 0, min_path = -1;
    long long min_path_pen = 1ll << 60;
    int n_failures = 0, rv = -1;
    KdHeap H;
    H.hn = H.sn = 0;

    // the root: the first k-1 valid bases rolled in, i at the k-th
    KdEnt z0;
    kmer_clear(z0.x);
    int zi = start, l = 0;
    while (zi < end) {
        int c = kd_b(s, zi);
        if (c < 4) {
            if (++l == k) break;
            kmer_append(z0.x, c, k);
        } else {
            l = 0;
            kmer_clear(z0.x);
        }
        zi++;
    }
    z0.i = zi;
    z0.k = -1;
    for (int t = 0; t < KD_EC_HIST_HIGH; t++) z0.eph[t] = -1;
    for (int t = 0; t < KD_EC_HIST; t++) z0.ep[t] = -1;
    H.cache_slot = kd_slot(S.keys[0]);
    H.cache_tot = 0;
    H.cache = z0;
    S.keys[0] = kd_key(0, H.cache_slot);
    H.hn = 1;
    for (int i = 0; i < n; i++) ec[i] = (uint8_t)kd_b(s, i);

    while (1) {
        if (H.hn > max_heap_seen) max_heap_seen = H.hn;
        if (H.hn == 0) { rv = -2; break; }
        // pop: the root's slot goes to the freed end of the heap
        KdKey top = S.keys[0];
        H.hn--;
        KdKey last = S.keys[H.hn * ks];
        S.keys[H.hn * ks] = kd_key(0, kd_slot(top));
        if (H.hn) {
            S.keys[0] = last;
            kd_heap_down(S.keys, ks, H.hn);
        }
        const int zslot = kd_slot(top);
        KdEnt z;
        if (zslot == H.cache_slot) {  // nearly every pop: no load
            z = H.cache;
            H.cache_slot = -1;
        } else {
            z = S.pool[zslot];
        }
        const int ztot = kd_tot(top);
        if (min_path >= 0 && ztot > min_path_pen + P.max_path_diff) break;
        int stop = z.i - end > P.max_end_ext;
        if (!stop) {
            const int has_c = z.i < n;
            const int v = has_c ? kd_at(s, z.i) : 4;
            const int cb = v & 7;
            const int cq = (v & KD_Q) != 0;
            const int own = has_c && cb < 4;
            // what decides `fixed` without a probe: past the end, or a
            // high-coverage base; else the own base's count may
            int fixed = z.i > end || (own && (v & KD_HIGH));
            const int own_may_fix = own && !fixed && cq && (v & KD_SOLID);
            // the window checks, the same for every alternative
            int win_ok = 1;
            if (has_c) {
                if (cq && z.eph[KD_EC_HIST_HIGH - 1] >= 0 &&
                    z.i - z.eph[KD_EC_HIST_HIGH - 1] < P.win_multi_ec)
                    win_ok = 0;
                if (z.ep[KD_EC_HIST - 1] >= 0 &&
                    z.i - z.ep[KD_EC_HIST - 1] < P.win_multi_ec)
                    win_ok = 0;
            }
            const int alt_try = !has_c || (win_ok && !fixed);
            // round 1: the own base, with the alternatives unless the own
            // count may fix the step; round 2: those alternatives if not
            const int alts = alt_try ? 0xF & ~(own << cb) : 0;
            uint64_t occ = kd_probe_bases(
                P.sp, z.x, (own ? 1 << cb : 0) | (own_may_fix ? 0 : alts));
            int os = -1;
            if (own) {
                os = kd_occ(occ, cb);
                probes++;
                // an absent k-mer (os == -1) reads as count 255 here, as
                // in the reference (correct.c:300)
                if (own_may_fix && (os & 0xFF) >= P.min_cov + 1) fixed = 1;
            }
            if (own_may_fix && !fixed) occ |= kd_probe_bases(P.sp, z.x, alts);
            // the steps to push, a bit a base, and their penalties
            int other_ext = 0, na = 0, amask = 0;
            int pe = 0, peh = 0, pa = 0, pah = 0;
#pragma unroll
            for (int b = 0; b < 4; b++) {
                if (fixed && has_c && b != cb) continue;
                if (!has_c || b != cb) {
                    if (has_c && !win_ok) continue;
                    int s_occ = kd_occ(occ, b);
                    probes++;
                    if (s_occ < 0 || (s_occ & 0xFF) < P.min_cov) continue;
                    pe |= (has_c && cb < 4) << b;
                    peh |= (has_c && cb < 4 && cq) << b;
                    pah |= (((s_occ >> 8) & 0xFF) < P.min_cov) << b;
                    other_ext++;
                } else {
                    pa |= (os < 0 || (os & 0xFF) < P.min_cov) << b;
                    pah |= (os < 0 || ((os >> 8) & 0xFF) < P.min_cov) << b;
                }
                amask |= 1 << b;
                na++;
            }
            if (!fixed && other_ext == 0) n_failures++;
            if (n_failures > n * 2) { rv = -3; break; }
            if (has_c || na == 1) {
                if (na > 1 && H.hn > P.max_heap) {
                    // heap-explosion guard: push only the cheapest step
                    // (the first of equal weights, in base order)
                    int min_b = -1, minv = 1 << 30;
#pragma unroll
                    for (int b = 0; b < 4; b++) {
                        if (!((amask >> b) & 1)) continue;
                        KdStep a = {b, (pe >> b) & 1, (peh >> b) & 1,
                                    (pa >> b) & 1, (pah >> b) & 1};
                        int w = kd_weight(P, a);
                        if (minv > w) { minv = w; min_b = b; }
                    }
                    amask = 1 << min_b;
                }
                // in base order, one push a trip, so the push's code runs
                // once for a warp whose threads push one base each
                while (amask) {
                    int b = kd_low_bit(amask);
                    amask &= amask - 1;
                    KdStep a = {b, (pe >> b) & 1, (peh >> b) & 1,
                                (pa >> b) & 1, (pah >> b) & 1};
                    if (!kd_push(P, z, ztot, a, S, H)) {
                        *ovf = 1;
                        return -1;
                    }
                }
            } else {
                if (na == 0)
                    S.stack[z.k].tot +=
                        P.w_absent * (P.max_end_ext - (z.i - end));
                stop = 1;
            }
        }
        if (stop) {
            if (S.stack[z.k].tot < min_path_pen) {
                min_path_pen = S.stack[z.k].tot;
                min_path = n_paths;
            }
            paths[n_paths++] = z.k;
            if (n_paths == KD_MAX_PATHS) break;
        }
    }
    *max_heap = max_heap_seen;
    if (n_paths == 0) return rv;
    // backtrack (buf_backtrack, correct.c:232-247)
    int n_absent = 0;
    for (int e = paths[min_path]; e >= 0; e = S.stack[e].parent) {
        KdStackEnt st = S.stack[e];
        if (st.i < n) {
            ec[st.i] = st.b;
            n_absent += st.pen_absent;
        }
    }
    for (int i = 0; i < n; i++)
        if (i < start + k || i >= end) ec[i] = 4;
    return n_absent;
}

// bfc_ec_first_kmer (correct.c:82-94): index of the last base of the
// first full k-mer at or after start (n when none), its planes in x.
BFC_HD int kd_first_kmer(const KdRead& s, int k, int start, uint64_t x[4]) {
    kmer_clear(x);
    int run = 0;
    for (int i = start; i < s.n; i++) {
        int c = kd_b(s, i);
        if (c < 4) {
            kmer_append(x, c, k);
            if (++run == k) return i;
        } else {
            run = 0;
            kmer_clear(x);
        }
    }
    return s.n;
}

// bfc_ec_greedy_k (correct.c:63-80): pos << 2 | base of the best single
// substitution (pos from the 3' end), or -1; the first maximum wins.  The
// three substitutions of a position are loaded together.
BFC_HD int kd_greedy_k(const KdParams& P, const uint64_t x[4], int& probes) {
    const int k = P.sp.k;
    int maxv = 0, max2 = 0, max_ec = -1;
    for (int i = 0; i < k; i++) {
        int c = (int)((((x[1] >> i) & 1) << 1) | ((x[0] >> i) & 1));
        ProbeAddr pa[3];
        uint64_t e1[3], e2[3];
#pragma unroll
        for (int t = 0; t < 3; t++) {
            int j = t + (t >= c);  // the bases other than c, in order
            uint64_t y[4] = {x[0], x[1], x[2], x[3]};
            kmer_change(y, i, j, k);
            pa[t] = kmer_addr(P.sp, y);
        }
#pragma unroll
        for (int t = 0; t < 3; t++) {
            e1[t] = table_load(pa[t].p1);
            e2[t] = table_load(pa[t].p2);
        }
#pragma unroll
        for (int t = 0; t < 3; t++) {
            int j = t + (t >= c);
            int ret = cuckoo_pick(e1[t], e2[t], pa[t].qlow);
            probes++;
            if (ret < 0) continue;
            if ((maxv & 0xFF) < (ret & 0xFF)) {
                max2 = maxv;
                maxv = ret;
                max_ec = i << 2 | j;
            } else if ((max2 & 0xFF) < (ret & 0xFF)) {
                max2 = ret;
            }
        }
    }
    return (maxv & 0xFF) * 3 > P.mode && (max2 & 0xFF) < 3 ? max_ec : -1;
}

BFC_HD int kd_code_of(int rv) { return rv == -2 ? 4 : rv == -3 ? 5 : 1; }

// bfc_ec1 (correct.c:388-472) for one read of n bases in a row of L into
// the KD_N_OUT columns o.  b/q are the base codes and quality flags (q
// already 0 on N), lcov/hcov and isl come from KC.  Writes packed[0, L) =
// final base | is_diff << 3 | q << 4 | original base << 5 (bfc_tpu's
// correct_core packing; a read that is not corrected keeps its input).
// Returns KD_DEFER, with o undefined, when the read needs more stack than
// this pass gives it; an overflow of the full caps is KD_OVERFLOW.
BFC_HD int kd_read_cols(const KdParams& P, int L, const uint8_t* b,
                        const uint8_t* q, const uint8_t* lcov,
                        const uint8_t* hcov, int n, const int32_t* isl,
                        uint8_t* ec0, uint8_t* ec1, uint8_t* info,
                        KdScratch& S, uint8_t* packed, int32_t o[KD_N_OUT]) {
    const int k = P.sp.k;
    for (int i = 0; i < L; i++)
        packed[i] = (uint8_t)(b[i] | q[i] << 4 | b[i] << 5);
    int n_n = 0;
    for (int i = 0; i < n; i++) {
        n_n += b[i] > 3;
        info[i] = (uint8_t)(b[i] | (q[i] ? KD_Q : 0) |
                            (lcov[i] >= P.min_cov + 1 ? KD_SOLID : 0) |
                            (hcov[i] > k * 0.75 ? KD_HIGH : 0));
    }
    if ((double)n_n > (double)n * 0.05) {  // the C double test
        o[KD_EC_CODE] = 2;
        return KD_DONE;
    }
    int probes = 0;
    KdRead s = {info, n, -1, 0, 0};
    int start, end;
    if (isl[2]) {
        start = isl[0];
        end = isl[1];
    } else {
        int ecv = -1;
        uint64_t x[4];
        start = 0;
        while (1) {
            end = kd_first_kmer(s, k, start, x);
            if (end >= n) break;
            ecv = kd_greedy_k(P, x, probes);
            if (ecv >= 0) break;
            if (end + (k >> 1) >= n) break;
            start = end - (k >> 1);
        }
        if (ecv < 0) {
            o[KD_EC_CODE] = 3;
            o[KD_PROBES] = probes;
            return KD_DONE;
        }
        s.fix_pos = end - (ecv >> 2);
        s.fix_b = ecv & 3;
        end += 1;
        start = end - k;
        o[KD_BRUTE] = 1;
    }
    int ovf = 0, mh0 = 0, mh1 = 0, rv1 = 0;
    int rv0 = kd_ec1dir(P, s, start, ec0, S, &mh0, &ovf, probes);
    if (!ovf && rv0 >= 0) {
        KdRead r = s;
        r.rev = 1;
        rv1 = kd_ec1dir(P, r, n - end, ec1, S, &mh1, &ovf, probes);
    }
    if (ovf) {
        if (S.stack_cap < P.stack_cap) return KD_DEFER;
        o[KD_BRUTE] = 0;
        o[KD_OVERFLOW] = 1;
        return KD_DONE;
    }
    o[KD_PROBES] = probes;
    if (rv0 < 0 || rv1 < 0) {
        o[KD_EC_CODE] = kd_code_of(rv0 < 0 ? rv0 : rv1);
        return KD_DONE;
    }
    int n_ec = 0, n_ec_high = 0;
    for (int i = 0; i < n; i++) {
        int e0 = ec0[i];
        int r1 = ec1[n - 1 - i];
        int e1 = r1 < 4 ? 3 - r1 : 4;
        int ob = b[i];
        int fb;
        if (e0 == e1)
            fb = e0 > 3 ? kd_b(s, i) : e0;
        else if (e1 > 3)
            fb = e0;
        else if (e0 > 3)
            fb = e1;
        else
            fb = ob;
        int diff = fb != ob;
        n_ec += diff;
        n_ec_high += diff && q[i];
        packed[i] = (uint8_t)(fb | diff << 3 | q[i] << 4 | ob << 5);
    }
    o[KD_N_EC] = n_ec;
    o[KD_N_EC_HIGH] = n_ec_high;
    o[KD_N_ABSENT] = rv0 + rv1;
    o[KD_MAX_HEAP] = mh0 > mh1 ? mh0 : mh1;
    return KD_DONE;
}

// One batch as the kernel's threads share it.
struct KdBatch {
    int B, L;
    const uint8_t* bases;
    const uint8_t* q;
    const int32_t* lens;
    const uint8_t* lcov;
    const uint8_t* hcov;
    const int32_t* isl;
    uint8_t* ec0;
    uint8_t* ec1;
    uint8_t* info;  // [B, L] kd_read_cols's info bytes
    uint8_t* packed;
    int32_t* out;
    int32_t* ctr;    // [0] next read of pass 1, [1] reads deferred, [2] next of pass 2
    int32_t* retry;  // [B] the deferred reads
};

#ifdef __CUDA_ARCH__
#define BFC_ATOMIC_ADD_I32(p, v) atomicAdd((int*)(p), (int)(v))
#else
#define BFC_ATOMIC_ADD_I32(p, v) bfc_add_i32((p), (v))
inline int32_t bfc_add_i32(int32_t* p, int32_t v) {
    int32_t old = *p;
    *p += v;
    return old;
}
#endif

// Read r of the batch into its row of out; defers it (pass 1) to the
// retry list.
BFC_HD void kd_batch_read(const KdParams& P, const KdBatch& bt, int r,
                          KdScratch& S) {
    size_t o = (size_t)r * bt.L;
    int32_t cols[KD_N_OUT];
    for (int t = 0; t < KD_N_OUT; t++) cols[t] = 0;
    int st = kd_read_cols(P, bt.L, bt.bases + o, bt.q + o, bt.lcov + o,
                          bt.hcov + o, bt.lens[r], bt.isl + 3 * (size_t)r,
                          bt.ec0 + o, bt.ec1 + o, bt.info + o, S,
                          bt.packed + o, cols);
    if (st == KD_DEFER) {
        bt.retry[BFC_ATOMIC_ADD_I32(bt.ctr + 1, 1)] = r;
        return;
    }
    int32_t* out = bt.out + (size_t)KD_N_OUT * r;
    for (int t = 0; t < KD_N_OUT; t++) out[t] = cols[t];
}

// The persistent read loop of one thread: pass 1 takes every read of the
// batch in turn from ctr[0]; pass 2 takes the deferred ones from ctr[2].
BFC_HD void kd_worker(const KdParams& P, const KdBatch& bt, KdScratch S,
                      int pass) {
    for (int p = 0; p < P.heap_cap; p++) S.keys[p * S.kstride] = kd_key(0, p);
    while (1) {
        int r;
        if (pass == 1) {
            r = BFC_ATOMIC_ADD_I32(bt.ctr, 1);
            if (r >= bt.B) break;
        } else {
            int j = BFC_ATOMIC_ADD_I32(bt.ctr + 2, 1);
            if (j >= bt.ctr[1]) break;
            r = bt.retry[j];
        }
        kd_batch_read(P, bt, r, S);
    }
}
