// KD per-read body: the whole correction of one read (bfc_ec1).
//
// A direct translation of bfc_tpu/models/refmodel.py:ec1 (:818) and
// ec1dir (:579), which are the semantic spec (correct.c:63-472): the
// many-N gate, the greedy single-substitution seed when no solid island
// exists, the best-first penalty search in both directions with the
// ksort.h heap's exact tie order, the backtrack, and the direction merge.
// The heap and stack live in per-read scratch of fixed capacity; a read
// that would exceed either sets `overflow`, and the caller corrects it
// with the scalar model instead (the same contract as bfc_tpu's).
#pragma once
#include "cuckoo.cuh"

#define KD_EC_HIST 5
#define KD_EC_HIST_HIGH 2
#define KD_MAX_PATHS 4

struct KdParams {
    SpecParams sp;
    int min_cov, win_multi_ec, max_end_ext;
    int w_ec, w_ec_high, w_absent, w_absent_high;
    int max_path_diff, max_heap, mode;
    int heap_cap, stack_cap;
};

struct KdHeapEnt {
    uint64_t x[4];
    int32_t tot;  // total penalty
    int32_t i;    // next position
    int32_t k;    // stack index of the last step, -1 for the root
    int32_t eph[KD_EC_HIST_HIGH];  // positions of recent high-q edits
    int32_t ep[KD_EC_HIST];        // positions of recent edits
};

struct KdStackEnt {
    int32_t parent;
    int32_t tot;
    int32_t i;
    uint8_t b, pen_ec, pen_absent, pad;
};

// Output columns of one read.
// KD_PROBES counts the read's table probes (zero when it overflowed),
// which the roofline bound of the search needs.
enum { KD_EC_CODE, KD_BRUTE, KD_N_EC, KD_N_EC_HIGH, KD_N_ABSENT,
       KD_MAX_HEAP, KD_OVERFLOW, KD_PROBES, KD_N_OUT };

// One read as bfc_ec1 sees it: bases after the greedy fix at fix_pos,
// read forward or (rev) reverse-complemented.
struct KdRead {
    const uint8_t* b;
    const uint8_t* q;
    const uint8_t* lcov;
    const uint8_t* hcov;
    int n, fix_pos, fix_b, rev;
};

BFC_HD int kd_idx(const KdRead& s, int i) { return s.rev ? s.n - 1 - i : i; }

BFC_HD int kd_b(const KdRead& s, int i) {
    int j = kd_idx(s, i);
    int c = j == s.fix_pos ? s.fix_b : s.b[j];
    return s.rev ? (c < 4 ? 3 - c : 4) : c;
}

BFC_HD int kd_q(const KdRead& s, int i) { return s.q[kd_idx(s, i)]; }
BFC_HD int kd_lcov(const KdRead& s, int i) { return s.lcov[kd_idx(s, i)]; }
BFC_HD int kd_hcov(const KdRead& s, int i) { return s.hcov[kd_idx(s, i)]; }

// ks_heapup with lt(a, b) = a.tot > b.tot (ksort.h:137-146).
BFC_HD void kd_heap_up(KdHeapEnt* heap, int hn) {
    int k = hn - 1;
    KdHeapEnt tmp = heap[k];
    while (k) {
        int i = (k - 1) >> 1;
        if (tmp.tot > heap[i].tot) break;
        heap[k] = heap[i];
        k = i;
    }
    heap[k] = tmp;
}

// ks_heapdown from the root (ksort.h:125-136).
BFC_HD void kd_heap_down(KdHeapEnt* heap, int n) {
    int i = 0, k = 0;
    KdHeapEnt tmp = heap[0];
    while (1) {
        k = (k << 1) + 1;
        if (k >= n) break;
        if (k != n - 1 && heap[k].tot > heap[k + 1].tot) k++;
        if (heap[k].tot > tmp.tot) break;
        heap[i] = heap[k];
        i = k;
    }
    heap[i] = tmp;
}

struct KdStep {
    int b, pen_ec, pen_ec_high, pen_absent, pen_absent_high;
};

BFC_HD int kd_weight(const KdParams& P, const KdStep& a) {
    return P.w_ec * a.pen_ec + P.w_ec_high * a.pen_ec_high +
           P.w_absent * a.pen_absent + P.w_absent_high * a.pen_absent_high;
}

// buf_update (correct.c:198-230): push step a from state z.  Returns 0
// when the heap or the stack is full.
BFC_HD int kd_push(const KdParams& P, const KdHeapEnt& z, const KdStep& a,
                   KdHeapEnt* heap, int* hn, KdStackEnt* stack, int* sn) {
    if (*sn >= P.stack_cap || *hn >= P.heap_cap) return 0;
    int tot = z.tot + kd_weight(P, a);
    KdStackEnt& st = stack[*sn];
    st.parent = z.k;
    st.tot = tot;
    st.i = z.i;
    st.b = (uint8_t)a.b;
    st.pen_ec = (uint8_t)a.pen_ec;
    st.pen_absent = (uint8_t)a.pen_absent;
    st.pad = 0;
    KdHeapEnt& e = heap[*hn];
    for (int t = 0; t < 4; t++) e.x[t] = z.x[t];
    kmer_append(e.x, a.b, P.sp.k);
    e.tot = tot;
    e.i = z.i + 1;
    e.k = *sn;
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
    (*sn)++;
    (*hn)++;
    kd_heap_up(heap, *hn);
    return 1;
}

// bfc_ec1dir (correct.c:249-386) over [start, n): fills ec[0, n) with the
// corrected bases (4 = masked), sets *max_heap, adds its table probes to
// *probes, and returns n_absent >= 0 or the reference failure code
// -1 / -2 / -3.  Sets *ovf and returns -1 when the scratch capacity is
// exceeded.
BFC_HD int kd_ec1dir(const KdParams& P, const KdRead& s, int start,
                     uint8_t* ec, KdHeapEnt* heap, KdStackEnt* stack,
                     int* max_heap, int* ovf, int* probes) {
    const int k = P.sp.k, n = s.n, end = n;
    int hn = 0, sn = 0, max_heap_seen = 0;
    int paths[KD_MAX_PATHS];
    int n_paths = 0, min_path = -1;
    long long min_path_pen = 1ll << 60;
    int n_failures = 0, rv = -1;

    // the root: the first k-1 valid bases rolled in, i at the k-th
    KdHeapEnt& z0 = heap[0];
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
    z0.tot = 0;
    z0.i = zi;
    z0.k = -1;
    for (int t = 0; t < KD_EC_HIST_HIGH; t++) z0.eph[t] = -1;
    for (int t = 0; t < KD_EC_HIST; t++) z0.ep[t] = -1;
    hn = 1;
    for (int i = 0; i < n; i++) ec[i] = (uint8_t)kd_b(s, i);

    while (1) {
        if (hn > max_heap_seen) max_heap_seen = hn;
        if (hn == 0) { rv = -2; break; }
        KdHeapEnt z = heap[0];
        hn--;
        if (hn) {
            heap[0] = heap[hn];
            kd_heap_down(heap, hn);
        }
        if (min_path >= 0 && z.tot > min_path_pen + P.max_path_diff) break;
        int stop = z.i - end > P.max_end_ext;
        if (!stop) {
            int has_c = z.i < n;
            int cb = has_c ? kd_b(s, z.i) : 4;
            int cq = has_c ? kd_q(s, z.i) : 0;
            int fixed = z.i > end, os = -1, other_ext = 0, na = 0;
            KdStep added[4];
            uint64_t x2[4];
            if (has_c && cb < 4) {
                for (int t = 0; t < 4; t++) x2[t] = z.x[t];
                kmer_append(x2, cb, k);
                os = kmer_occ(P.sp, x2);
                (*probes)++;
                // an absent k-mer (os == -1) reads as count 255 here, as
                // in the reference (correct.c:300)
                if (cq && (os & 0xFF) >= P.min_cov + 1 &&
                    kd_lcov(s, z.i) >= P.min_cov + 1)
                    fixed = 1;
                else if (kd_hcov(s, z.i) > k * 0.75)
                    fixed = 1;
            }
            for (int b = 0; b < 4; b++) {
                if (fixed && has_c && b != cb) continue;
                if (!has_c || b != cb) {
                    if (has_c) {
                        if (cq && z.eph[KD_EC_HIST_HIGH - 1] >= 0 &&
                            z.i - z.eph[KD_EC_HIST_HIGH - 1] < P.win_multi_ec)
                            continue;
                        if (z.ep[KD_EC_HIST - 1] >= 0 &&
                            z.i - z.ep[KD_EC_HIST - 1] < P.win_multi_ec)
                            continue;
                    }
                    for (int t = 0; t < 4; t++) x2[t] = z.x[t];
                    kmer_append(x2, b, k);
                    int s_occ = kmer_occ(P.sp, x2);
                    (*probes)++;
                    if (s_occ < 0 || (s_occ & 0xFF) < P.min_cov) continue;
                    KdStep a;
                    a.b = b;
                    a.pen_ec = has_c && cb < 4;
                    a.pen_ec_high = a.pen_ec ? cq : 0;
                    a.pen_absent = 0;
                    a.pen_absent_high = ((s_occ >> 8) & 0xFF) < P.min_cov;
                    added[na++] = a;
                    other_ext++;
                } else {
                    KdStep a;
                    a.b = b;
                    a.pen_ec = a.pen_ec_high = 0;
                    a.pen_absent = os < 0 || (os & 0xFF) < P.min_cov;
                    a.pen_absent_high =
                        os < 0 || ((os >> 8) & 0xFF) < P.min_cov;
                    added[na++] = a;
                }
            }
            if (!fixed && other_ext == 0) n_failures++;
            if (n_failures > n * 2) { rv = -3; break; }
            if (has_c || na == 1) {
                if (na > 1 && hn > P.max_heap) {
                    // heap-explosion guard: push only the cheapest step
                    int min_b = -1, minv = 1 << 30;
                    for (int t = 0; t < na; t++) {
                        int w = kd_weight(P, added[t]);
                        if (minv > w) { minv = w; min_b = t; }
                    }
                    if (!kd_push(P, z, added[min_b], heap, &hn, stack, &sn)) {
                        *ovf = 1;
                        return -1;
                    }
                } else {
                    for (int t = 0; t < na; t++)
                        if (!kd_push(P, z, added[t], heap, &hn, stack, &sn)) {
                            *ovf = 1;
                            return -1;
                        }
                }
            } else {
                if (na == 0)
                    stack[z.k].tot +=
                        P.w_absent * (P.max_end_ext - (z.i - end));
                stop = 1;
            }
        }
        if (stop) {
            if (stack[z.k].tot < min_path_pen) {
                min_path_pen = stack[z.k].tot;
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
    for (int e = paths[min_path]; e >= 0; e = stack[e].parent) {
        if (stack[e].i < n) {
            ec[stack[e].i] = stack[e].b;
            n_absent += stack[e].pen_absent;
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
// substitution (pos from the 3' end), or -1; the first maximum wins.
BFC_HD int kd_greedy_k(const KdParams& P, const uint64_t x[4], int* probes) {
    const int k = P.sp.k;
    int maxv = 0, max2 = 0, max_ec = -1;
    for (int i = 0; i < k; i++) {
        int c = (int)((((x[1] >> i) & 1) << 1) | ((x[0] >> i) & 1));
        for (int j = 0; j < 4; j++) {
            if (j == c) continue;
            uint64_t y[4] = {x[0], x[1], x[2], x[3]};
            kmer_change(y, i, j, k);
            int ret = kmer_occ(P.sp, y);
            (*probes)++;
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

// bfc_ec1 (correct.c:388-472) for one read of n bases in a row of L.
// b/q are the base codes and quality flags (q already 0 on N), lcov/hcov
// and isl come from KC.  Writes packed[0, L) = final base | is_diff << 3
// | q << 4 | original base << 5 (bfc_tpu's correct_core packing; a read
// that is not corrected keeps its input) and the KD_N_OUT columns of out.
BFC_HD void kd_read(const KdParams& P, int L, const uint8_t* b,
                    const uint8_t* q, const uint8_t* lcov,
                    const uint8_t* hcov, int n, const int32_t* isl,
                    uint8_t* ec0, uint8_t* ec1, KdHeapEnt* heap,
                    KdStackEnt* stack, uint8_t* packed, int32_t* out) {
    const int k = P.sp.k;
    for (int t = 0; t < KD_N_OUT; t++) out[t] = 0;
    for (int i = 0; i < L; i++)
        packed[i] = (uint8_t)(b[i] | q[i] << 4 | b[i] << 5);
    int n_n = 0;
    for (int i = 0; i < n; i++) n_n += b[i] > 3;
    if ((double)n_n > (double)n * 0.05) {  // the C double test
        out[KD_EC_CODE] = 2;
        return;
    }
    KdRead s = {b, q, lcov, hcov, n, -1, 0, 0};
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
            ecv = kd_greedy_k(P, x, &out[KD_PROBES]);
            if (ecv >= 0) break;
            if (end + (k >> 1) >= n) break;
            start = end - (k >> 1);
        }
        if (ecv < 0) {
            out[KD_EC_CODE] = 3;
            return;
        }
        s.fix_pos = end - (ecv >> 2);
        s.fix_b = ecv & 3;
        end += 1;
        start = end - k;
        out[KD_BRUTE] = 1;
    }
    int ovf = 0, mh0 = 0, mh1 = 0;
    int rv0 = kd_ec1dir(P, s, start, ec0, heap, stack, &mh0, &ovf,
                        &out[KD_PROBES]);
    if (ovf) {
        out[KD_BRUTE] = out[KD_PROBES] = 0;
        out[KD_OVERFLOW] = 1;
        return;
    }
    if (rv0 < 0) {
        out[KD_EC_CODE] = kd_code_of(rv0);
        return;
    }
    KdRead r = s;
    r.rev = 1;
    int rv1 = kd_ec1dir(P, r, n - end, ec1, heap, stack, &mh1, &ovf,
                        &out[KD_PROBES]);
    if (ovf) {
        out[KD_BRUTE] = out[KD_PROBES] = 0;
        out[KD_OVERFLOW] = 1;
        return;
    }
    if (rv1 < 0) {
        out[KD_EC_CODE] = kd_code_of(rv1);
        return;
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
    out[KD_N_EC] = n_ec;
    out[KD_N_EC_HIGH] = n_ec_high;
    out[KD_N_ABSENT] = rv0 + rv1;
    out[KD_MAX_HEAP] = mh0 > mh1 ? mh0 : mh1;
}
