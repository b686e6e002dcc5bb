// The block-local first-occurrence Bloom verdict of KF and KI.
//
// Replaces the verdict of bfc_tpu/ops/spectrum.py:adjudicate_sketch (:843)
// and adjudicate_first_occurrence (:217, _forward_fill :249).  Row i is a
// Bloom hit (fp) iff, at every one of its n_hashes probed bits, some row
// of the same 512-bit block with a strictly smaller first arrival probes
// that bit: the reference's inserts in stream order (count.c:71-87), where
// rows of one arrival do not see each other.  All of a row's bits lie in
// its own block (bloom.cuh), so the rows need only be grouped by block,
// in any order within a block, never sorted.  They are grouped in two
// levels: by superblock (2^S consecutive blocks) in global memory, then by
// block in shared memory:
//
//   1. count     a u32 histogram of the 2^(bf_shift-9-S) superblocks, one
//                atomicAdd a superblock a warp.  S (ops/spectrum.py:
//                verdict_shift, at most VD_MAX_SB) keeps a superblock at
//                1,024 rows or fewer on average, so the histogram stays in
//                L2 (256 KiB for 63M rows at -b33) where one a block would
//                not (64 MiB);
//   2. scan      its inclusive prefix sums in place (tile sums, a scan of
//                those in one CTA, each tile scanned from its offset);
//   3. scatter   each row's record (its first offset and stride, KF's
//                keep class, its block in the superblock; its arrival: 8
//                bytes for KF, 16 for KI) written at a slot of its
//                superblock's segment taken atomically (a warp's rows of
//                one superblock at once), counting each end down, so the
//                histogram ends as the segments' starts; each row's slot
//                kept (4 bytes);
//   4. verdict   persistent CTAs, a superblock at a time, a verdict byte
//                (fp, KF's keep) a record, in segment order.  A superblock
//                of at most VD_CAP rows and more than one block is staged
//                in shared memory and grouped by block there (counts,
//                scan, an index a row).  A block of at most VD_PAIR rows
//                (3.8 on average at -b33) is judged a thread a row against
//                the block's other rows, by arithmetic on the probe
//                progressions (vd_pair_fp); a larger one (24 at -b30) by a
//                warp on a 512-entry per-bit minimum of arrivals:
//                atomicMin of each row's arrival at its bits, then fp =
//                AND over its bits of min[bit] < arrival, then the touched
//                entries reset, each step closed by __syncwarp.  A
//                superblock of one block (S = 0: hot blocks) or of more
//                than VD_CAP rows is read from global memory by the whole
//                CTA, block by block, on one table;
//   5. gather    fp (and keep) of row i from the verdict byte at its slot:
//                random 1-byte reads, where writing fp and keep at random
//                rows cost a read-modify-write of a sector each.
//
// A is the arrival type: u32 for KF (arrivals below 2^32 - 1), u64 for KI.
// Scratch: 13 (KF) or 21 (KI) bytes a row and 4 bytes a superblock
// (verdict_bytes in ops/spectrum.py), not KF's former 4 bytes a Bloom bit
// nor KI's sorts.  Bit ids stay 64-bit in the block index and 9-bit inside
// it, so nothing aliases at bf_shift >= 33.
//
// The per-row bodies are __host__ __device__ so that csrc/host_shim.cpp
// can run the same steps on the CPU; the kernels are CUDA only.
#pragma once
#include "bloom.cuh"

#define VD_CLS_SHIFT 18  // a record's key: zh (18 bits), KF's keep class
#define VD_LB_SHIFT 20   // (2 bits), the block within its superblock
#define VD_MAX_SB 8      // at most 2^8 blocks a superblock
#define VD_CAP 2048      // rows of a superblock staged in shared memory
#define VD_THREADS 128   // a verdict CTA
#define VD_PAIR 8        // blocks of at most 8 rows: a thread a row, no table
#define VD_GROUP 32      // lanes a larger block: a warp on its own table

// One row in its superblock's segment: key = zh | cls << 18 | block in
// superblock << 20, and the arrival; one 8-byte (KF) or 16-byte (KI)
// store.
template <typename A>
struct VdRec;
template <>
struct alignas(8) VdRec<uint32_t> {
    uint32_t key, arr;
};
template <>
struct alignas(16) VdRec<uint64_t> {
    uint64_t key, arr;
};

BFC_HD void bfc_atomic_min(uint32_t* p, uint32_t v) {
#ifdef __CUDA_ARCH__
    atomicMin(p, v);
#else
    if (v < *p) *p = v;
#endif
}

BFC_HD void bfc_atomic_min(uint64_t* p, uint64_t v) {
#ifdef __CUDA_ARCH__
    atomicMin((unsigned long long*)p, (unsigned long long)v);
#else
    if (v < *p) *p = v;
#endif
}

BFC_HD int bfc_ctz(uint32_t x) {
#ifdef __CUDA_ARCH__
    return __ffs(x) - 1;
#else
    return __builtin_ctz(x);
#endif
}

// KF's keep class of a row with n occurrences: keep = n - 1 + fp >= 1 is
// never (n <= 0), fp (n == 1) or always (n >= 2).
BFC_HD uint32_t vd_keep_class(int32_t n) {
    return n >= 2 ? 2u : n == 1 ? 1u : 0u;
}

template <typename A>
BFC_HD uint32_t vd_zh(const VdRec<A>& v) {
    return (uint32_t)v.key & ((1u << VD_CLS_SHIFT) - 1u);
}

// The block of a record within its superblock.
template <typename A>
BFC_HD uint32_t vd_local_block(const VdRec<A>& v) {
    return (uint32_t)(v.key >> VD_LB_SHIFT) & ((1u << VD_MAX_SB) - 1u);
}

// A row's verdict byte: fp, and KF's keep = n - 1 + fp >= 1 at bit 1.
template <typename A>
BFC_HD uint8_t vd_flag(const VdRec<A>& v, int f) {
    uint32_t cls = (uint32_t)(v.key >> VD_CLS_SHIFT) & 3u;
    return (uint8_t)(f | (cls == 2u || (cls == 1u && f)) << 1);
}

// The superblock of ret.
BFC_HD uint32_t vd_superblock(uint64_t ret, int bf_shift, int sb) {
    return (uint32_t)(bloom_block(ret, bf_shift) >> sb);
}

// Row i's record.  n is KF's occurrence count (nullptr for KI).
template <typename A>
BFC_HD VdRec<A> vd_record(int64_t i, const int64_t* ret, const A* arr,
                          const int32_t* n, int bf_shift, int sb) {
    uint64_t r = (uint64_t)ret[i];
    VdRec<A> v;
    v.key = bloom_zh(r, bf_shift) |
            (n ? vd_keep_class(n[i]) : 0u) << VD_CLS_SHIFT |
            (uint32_t)(bloom_block(r, bf_shift) & bfc_mask(sb)) << VD_LB_SHIFT;
    v.arr = arr[i];
    return v;
}

// Count step, one row (the kernel counts a warp's rows of one superblock
// with one atomic).
BFC_HD void vd_count_row(int64_t i, const int64_t* ret, int bf_shift, int sb,
                         uint32_t* cnt) {
    cnt[vd_superblock((uint64_t)ret[i], bf_shift, sb)] += 1;
}

// Scatter step, one row: ends[superblock] counts down to the segment's
// start (the kernel takes a warp's slots of one superblock at once); the
// row's slot is kept for the gather.
template <typename A>
BFC_HD void vd_scatter_row(int64_t i, const int64_t* ret, const A* arr,
                           const int32_t* n, int bf_shift, int sb,
                           uint32_t* ends, VdRec<A>* rec, uint32_t* slot) {
    uint32_t pos = --ends[vd_superblock((uint64_t)ret[i], bf_shift, sb)];
    rec[pos] = vd_record(i, ret, arr, n, bf_shift, sb);
    slot[i] = pos;
}

// Table step 1, one row: its arrival into the block's per-bit minimum.
template <typename A>
BFC_HD void vd_min_row(const VdRec<A>& v, int n_hashes, A* mins) {
    bloom_offsets(vd_zh(v), n_hashes,
                  [&](uint32_t z) { bfc_atomic_min(mins + z, v.arr); });
}

// Table step 2, one row: fp = every probed bit has an earlier minimum.
template <typename A>
BFC_HD int vd_judge(const VdRec<A>& v, int n_hashes, const A* mins) {
    int f = 1;
    bloom_offsets(vd_zh(v), n_hashes,
                  [&](uint32_t z) { f &= mins[z] < v.arr; });
    return f;
}

// Table step 3, one row: its entries back to "never probed".
template <typename A>
BFC_HD void vd_reset_row(const VdRec<A>& v, int n_hashes, A* mins) {
    bloom_offsets(vd_zh(v), n_hashes,
                  [&](uint32_t z) { mins[z] = (A)~(A)0; });
}

// fp of record v from the other rows of its block (recs[perm[s..e)), no
// table.  v's offsets are z0 + t h2 (mod 512) at the steps t < T that
// bloom_offsets takes; an offset z of an earlier row is one of them iff
// z - z0 = t h2 (mod 512) for such a t.  With g the power-of-two part of
// h2 (at most 16, as h2 & 31 != 0), that t is unique below 512 / g (at
// least 32 > T): t = ((z - z0) / g) inv (mod 512 / g), inv the inverse of
// the odd h2 / g.  fp iff every step taken is hit.
template <typename A, typename I>
BFC_HD int vd_pair_fp(const VdRec<A>& v, const VdRec<A>* recs, const I* perm,
                      uint32_t s, uint32_t e, int n_hashes) {
    uint32_t zh = vd_zh(v), z0 = zh & BFC_BLK_MASK, h2 = zh >> 9;
    uint32_t taken = 0, hit = 0;
    int T = 0;   // bloom_offsets' walk: the steps taken, and how many
    for (int j = 0; j < n_hashes && T < n_hashes + 8; T++)
        if (((z0 + (uint32_t)T * h2) & BFC_BLK_MASK) >= 8) {
            taken |= 1u << T;
            j++;
        }
    int gs = bfc_ctz(h2);
    uint32_t o = h2 >> gs, inv = o, pm = BFC_BLK_MASK >> gs;
    inv *= 2u - o * inv;   // Newton's steps: 3, 6, then 12 correct bits
    inv *= 2u - o * inv;
    for (uint32_t x = s; x < e && hit != taken; x++) {
        const VdRec<A>& u = recs[perm[x]];
        if (!(u.arr < v.arr)) continue;
        bloom_offsets(vd_zh(u), n_hashes, [&](uint32_t z) {
            uint32_t d = (z - z0) & BFC_BLK_MASK;
            if (d & ((1u << gs) - 1u)) return;
            uint32_t t = ((d >> gs) * inv) & pm;
            if (t < (uint32_t)T) hit |= 1u << t;
        });
    }
    return hit == taken;
}

// Gather step, one row: its fp (and KF's keep) from the verdict byte at
// the slot it was scattered to.
BFC_HD void vd_gather_row(int64_t i, const uint32_t* slot,
                          const uint8_t* flags, uint8_t* fp, uint8_t* keep) {
    uint8_t f = flags[slot[i]];
    fp[i] = f & 1u;
    if (keep) keep[i] = f >> 1;
}

// Whether the verdict stages a superblock of n rows and 2^sb blocks in
// shared memory (else the whole CTA reads it from global memory).
BFC_HD bool vd_staged(uint32_t n, int sb) {
    return sb > 0 && n <= VD_CAP;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

#define VD_SCAN_THREADS 256
#define VD_SCAN_ITEMS 8
#define VD_SCAN_TILE (VD_SCAN_THREADS * VD_SCAN_ITEMS)  // 2048 entries
#define VD_ROW_THREADS 256
#define VD_NG (VD_THREADS / VD_GROUP)

// The lanes of this warp whose rows share superblock q (a lane past C
// gives q = ~0, no superblock), and this lane's rank among them.
__device__ unsigned vd_peers(uint32_t q, uint32_t* rank) {
    unsigned peers = __match_any_sync(0xFFFFFFFFu, q);
    *rank = __popc(peers & ((1u << (threadIdx.x & 31)) - 1u));
    return peers;
}

// One atomic a superblock a warp: a fold sorted by k-mer puts rows of one
// superblock side by side.
__global__ void vd_count_kernel(long long C, const int64_t* ret, int bf_shift,
                                int sb, uint32_t* cnt) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    uint32_t q = i < C ? vd_superblock((uint64_t)ret[i], bf_shift, sb)
                       : 0xFFFFFFFFu, rank;
    unsigned peers = vd_peers(q, &rank);
    if (i < C && rank == 0) atomicAdd(cnt + q, (uint32_t)__popc(peers));
}

// Exclusive scan of one value a thread across the CTA; *total gets the
// CTA's sum.  s holds VD_SCAN_THREADS / 32 words.
__device__ uint32_t vd_cta_scan(uint32_t v, uint32_t* s, uint32_t* total) {
    const int NW = VD_SCAN_THREADS / 32;
    int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    uint32_t x = v;
    for (int d = 1; d < 32; d <<= 1) {
        uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
        if (lane >= d) x += y;
    }
    if (lane == 31) s[w] = x;
    __syncthreads();
    if (w == 0) {
        uint32_t t = lane < NW ? s[lane] : 0u;
        for (int d = 1; d < NW; d <<= 1) {
            uint32_t y = __shfl_up_sync(0xFFFFFFFFu, t, d);
            if (lane >= d) t += y;
        }
        if (lane < NW) s[lane] = t;
    }
    __syncthreads();
    uint32_t out = (w ? s[w - 1] : 0u) + x - v;
    *total = s[NW - 1];
    __syncthreads();   // s is reused by the caller's next scan
    return out;
}

// Scan pass 1: each tile's sum.
__global__ void vd_tile_sum_kernel(uint32_t n, const uint32_t* cnt,
                                   uint32_t* sums) {
    __shared__ uint32_t s[VD_SCAN_THREADS / 32];
    uint32_t base = blockIdx.x * VD_SCAN_TILE, v = 0, total;
    for (int k = 0; k < VD_SCAN_ITEMS; k++) {
        uint32_t j = base + k * VD_SCAN_THREADS + threadIdx.x;
        if (j < n) v += cnt[j];
    }
    vd_cta_scan(v, s, &total);
    if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// Scan pass 2 (one CTA): the tile sums become exclusive tile offsets.
__global__ void vd_tile_offset_kernel(uint32_t n_tiles, uint32_t* sums) {
    __shared__ uint32_t s[VD_SCAN_THREADS / 32];
    uint32_t carry = 0, total;
    for (uint32_t b = 0; b < n_tiles; b += VD_SCAN_THREADS) {
        uint32_t j = b + threadIdx.x;
        uint32_t v = j < n_tiles ? sums[j] : 0u;
        uint32_t x = vd_cta_scan(v, s, &total);
        if (j < n_tiles) sums[j] = carry + x;
        carry += total;
    }
}

// Scan pass 3: each tile's inclusive sums in place, from its offset.
__global__ void vd_tile_scan_kernel(uint32_t n, uint32_t* cnt,
                                    const uint32_t* sums) {
    __shared__ uint32_t s[VD_SCAN_THREADS / 32];
    uint32_t base = blockIdx.x * VD_SCAN_TILE + threadIdx.x * VD_SCAN_ITEMS;
    uint32_t v[VD_SCAN_ITEMS], t = 0, total;
    for (int k = 0; k < VD_SCAN_ITEMS; k++) {
        v[k] = base + k < n ? cnt[base + k] : 0u;
        t += v[k];
    }
    uint32_t x = sums[blockIdx.x] + vd_cta_scan(t, s, &total);
    for (int k = 0; k < VD_SCAN_ITEMS; k++) {
        x += v[k];
        if (base + k < n) cnt[base + k] = x;
    }
}

// The lowest lane of each superblock's peers takes their slots at once.
template <typename A>
__global__ void vd_scatter_kernel(long long C, const int64_t* ret,
                                  const A* arr, const int32_t* n,
                                  int bf_shift, int sb, uint32_t* ends,
                                  VdRec<A>* rec, uint32_t* slot) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    uint32_t q = i < C ? vd_superblock((uint64_t)ret[i], bf_shift, sb)
                       : 0xFFFFFFFFu, rank;
    unsigned peers = vd_peers(q, &rank);
    uint32_t end = 0;
    if (i < C && rank == 0) end = atomicSub(ends + q, (uint32_t)__popc(peers));
    end = __shfl_sync(0xFFFFFFFFu, end, __ffs(peers) - 1);
    if (i < C) {
        rec[end - 1 - rank] = vd_record(i, ret, arr, n, bf_shift, sb);
        slot[i] = end - 1 - rank;
    }
}

// The verdict's shared memory: VD_NG per-bit minima, then the staged
// superblock's records, its blocks' starts and cursors, an index a row.
template <typename A>
constexpr size_t vd_smem_bytes() {
    return (size_t)VD_NG * 512 * sizeof(A) + (size_t)VD_CAP * sizeof(VdRec<A>)
           + (2 * (1 << VD_MAX_SB) + 1) * sizeof(uint32_t)
           + (size_t)VD_CAP * sizeof(uint16_t);
}

// A staged superblock: n records in recs, 2^sb blocks, verdict bytes to
// flags (one a record).  Groups the rows by block (perm: the rows of block
// b at bstart[b] .. bstart[b + 1]); a block of at most VD_PAIR rows is
// judged a thread a row (vd_pair_fp), a larger one by group g (blocks g,
// g + VD_NG, ...) on its table.
template <typename A>
__device__ void vd_staged_verdict(const VdRec<A>* recs, uint32_t n, int sb,
                                  uint32_t* bstart, uint32_t* cursor,
                                  uint16_t* perm, A* mins, int n_hashes,
                                  uint8_t* flags) {
    int tid = threadIdx.x, g = tid / VD_GROUP, lane = tid % VD_GROUP;
    uint32_t nb = 1u << sb;
    for (uint32_t b = tid; b <= nb; b += VD_THREADS) bstart[b] = 0;
    __syncthreads();
    for (uint32_t r = tid; r < n; r += VD_THREADS)
        atomicAdd(bstart + vd_local_block(recs[r]) + 1, 1u);
    __syncthreads();
    if (tid < 32) {   // inclusive sums of bstart[1..nb]: the blocks' starts
        uint32_t carry = 0;
        for (uint32_t b0 = 1; b0 <= nb; b0 += 32) {
            uint32_t b = b0 + tid, x = b <= nb ? bstart[b] : 0u;
            for (int d = 1; d < 32; d <<= 1) {
                uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, d);
                if (tid >= d) x += y;
            }
            if (b <= nb) bstart[b] = carry + x;
            carry += __shfl_sync(0xFFFFFFFFu, x, 31);
        }
    }
    __syncthreads();
    for (uint32_t b = tid; b < nb; b += VD_THREADS) cursor[b] = bstart[b];
    __syncthreads();
    for (uint32_t r = tid; r < n; r += VD_THREADS)
        perm[atomicAdd(cursor + vd_local_block(recs[r]), 1u)] = (uint16_t)r;
    __syncthreads();
    for (uint32_t x = tid; x < n; x += VD_THREADS) {
        uint32_t r = perm[x], b = vd_local_block(recs[r]);
        uint32_t s = bstart[b], e = bstart[b + 1];
        if (e - s <= VD_PAIR)
            flags[r] = vd_flag(
                recs[r], vd_pair_fp(recs[r], recs, perm, s, e, n_hashes));
    }
    unsigned mask = (unsigned)((1ull << VD_GROUP) - 1u)
                    << ((tid & 31) & ~(VD_GROUP - 1));
    mins += g * 512;
    for (uint32_t b = g; b < nb; b += VD_NG) {
        uint32_t s = bstart[b], e = bstart[b + 1];
        if (e - s <= VD_PAIR) continue;
        for (uint32_t x = s + lane; x < e; x += VD_GROUP)
            vd_min_row(recs[perm[x]], n_hashes, mins);
        __syncwarp(mask);
        for (uint32_t x = s + lane; x < e; x += VD_GROUP) {
            uint32_t r = perm[x];
            flags[r] = vd_flag(recs[r], vd_judge(recs[r], n_hashes, mins));
        }
        __syncwarp(mask);
        for (uint32_t x = s + lane; x < e; x += VD_GROUP)
            vd_reset_row(recs[perm[x]], n_hashes, mins);
        __syncwarp(mask);
    }
}

// A superblock read from global memory (records rec[0, n)): the whole CTA
// takes its blocks one at a time on one table (mins, left clear).
template <typename A>
__device__ void vd_global_verdict(const VdRec<A>* rec, uint32_t n, int sb,
                                  A* mins, int n_hashes, uint8_t* flags) {
    int tid = threadIdx.x;
    for (uint32_t b = 0; b < 1u << sb; b++) {
        for (uint32_t r = tid; r < n; r += VD_THREADS) {
            VdRec<A> v = rec[r];
            if (vd_local_block(v) == b) vd_min_row(v, n_hashes, mins);
        }
        __syncthreads();
        for (uint32_t r = tid; r < n; r += VD_THREADS) {
            VdRec<A> v = rec[r];
            if (vd_local_block(v) == b)
                flags[r] = vd_flag(v, vd_judge(v, n_hashes, mins));
        }
        __syncthreads();
        for (int j = tid; j < 512; j += VD_THREADS) mins[j] = (A)~(A)0;
        __syncthreads();
    }
}

// Copies n records to shared memory, four loads a thread in flight.
template <typename A>
__device__ void vd_stage(const VdRec<A>* rec, uint32_t n, VdRec<A>* recs) {
    const uint32_t K = 4;
    for (uint32_t r0 = threadIdx.x; r0 < n; r0 += K * VD_THREADS) {
        VdRec<A> v[K];
#pragma unroll
        for (uint32_t k = 0; k < K; k++)
            if (r0 + k * VD_THREADS < n) v[k] = rec[r0 + k * VD_THREADS];
#pragma unroll
        for (uint32_t k = 0; k < K; k++)
            if (r0 + k * VD_THREADS < n) recs[r0 + k * VD_THREADS] = v[k];
    }
}

// Persistent CTAs: superblocks blockIdx.x, + gridDim.x, ...  Every table
// is clear at the start of each superblock.  flags[j]: the verdict byte of
// record j.
template <typename A>
__global__ void __launch_bounds__(VD_THREADS)
vd_verdict_kernel(long long C, uint32_t n_super, int sb,
                  const uint32_t* starts, const VdRec<A>* rec, int n_hashes,
                  uint8_t* flags) {
    extern __shared__ __align__(16) unsigned char vd_smem[];
    A* mins = (A*)vd_smem;
    VdRec<A>* recs = (VdRec<A>*)(mins + VD_NG * 512);
    uint32_t* bstart = (uint32_t*)(recs + VD_CAP);
    uint32_t* cursor = bstart + (1 << VD_MAX_SB) + 1;
    uint16_t* perm = (uint16_t*)(cursor + (1 << VD_MAX_SB));
    for (int j = threadIdx.x; j < VD_NG * 512; j += VD_THREADS)
        mins[j] = (A)~(A)0;
    __syncthreads();
    for (uint32_t q = blockIdx.x; q < n_super; q += gridDim.x) {
        uint32_t s = starts[q];
        uint32_t e = q + 1 < n_super ? starts[q + 1] : (uint32_t)C;
        if (vd_staged(e - s, sb)) {
            vd_stage(rec + s, e - s, recs);
            vd_staged_verdict(recs, e - s, sb, bstart, cursor, perm, mins,
                              n_hashes, flags + s);
        } else if (s != e) {
            vd_global_verdict(rec + s, e - s, sb, mins, n_hashes, flags + s);
        }
        __syncthreads();   // recs, bstart and perm are the next one's
    }
}

__global__ void vd_gather_kernel(long long C, const uint32_t* slot,
                                 const uint8_t* flags, uint8_t* fp,
                                 uint8_t* keep) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < C) vd_gather_row(i, slot, flags, fp, keep);
}

// The whole verdict on stream st.  Scratch (ops/spectrum.py:
// verdict_scratch): rec and slot C entries, flags C bytes, cnt one word a
// superblock of 2^sb blocks, sums one word a VD_SCAN_TILE of them; n and
// keep are KF's (nullptr for KI).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an sb outside 0..min(VD_MAX_SB, bf_shift - 9).
template <typename A>
int vd_launch(long long C, const int64_t* ret, const A* arr, const int32_t* n,
              int bf_shift, int sb, int n_hashes, VdRec<A>* rec,
              uint32_t* slot, uint8_t* flags, uint32_t* cnt, uint32_t* sums,
              uint8_t* fp, uint8_t* keep, cudaStream_t st) {
    if (sb < 0 || sb > VD_MAX_SB || sb > bf_shift - BFC_BLK_SHIFT)
        return (int)cudaErrorInvalidValue;
    if (C <= 0) return (int)cudaGetLastError();
    uint32_t n_super = 1u << (bf_shift - BFC_BLK_SHIFT - sb);
    uint32_t n_tiles = (n_super + VD_SCAN_TILE - 1) / VD_SCAN_TILE;
    int row_grid = (int)((C + VD_ROW_THREADS - 1) / VD_ROW_THREADS);
    cudaError_t err = cudaMemsetAsync(cnt, 0, (size_t)n_super * 4, st);
    if (err != cudaSuccess) return (int)err;
    vd_count_kernel<<<row_grid, VD_ROW_THREADS, 0, st>>>(C, ret, bf_shift, sb,
                                                         cnt);
    vd_tile_sum_kernel<<<n_tiles, VD_SCAN_THREADS, 0, st>>>(n_super, cnt,
                                                            sums);
    vd_tile_offset_kernel<<<1, VD_SCAN_THREADS, 0, st>>>(n_tiles, sums);
    vd_tile_scan_kernel<<<n_tiles, VD_SCAN_THREADS, 0, st>>>(n_super, cnt,
                                                             sums);
    vd_scatter_kernel<A><<<row_grid, VD_ROW_THREADS, 0, st>>>(
        C, ret, arr, n, bf_shift, sb, cnt, rec, slot);
    // the shared-memory limit and the resident CTAs, once a device and
    // before any graph capture
    const size_t smem = vd_smem_bytes<A>();
    static int resident[64] = {0};
    int dev = 0;
    cudaGetDevice(&dev);
    if (!resident[dev & 63]) {
        err = cudaFuncSetAttribute(vd_verdict_kernel<A>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        int per_sm = 0, sms = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, vd_verdict_kernel<A>, VD_THREADS, smem);
        if (err != cudaSuccess) return (int)err;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
        if (err != cudaSuccess) return (int)err;
        resident[dev & 63] = per_sm * sms > 0 ? per_sm * sms : 1;
    }
    uint32_t grid = n_super < (uint32_t)resident[dev & 63]
                        ? n_super : (uint32_t)resident[dev & 63];
    vd_verdict_kernel<A><<<grid, VD_THREADS, smem, st>>>(
        C, n_super, sb, cnt, rec, n_hashes, flags);
    vd_gather_kernel<<<row_grid, VD_ROW_THREADS, 0, st>>>(C, slot, flags, fp,
                                                          keep);
    return (int)cudaGetLastError();
}
#endif  // __CUDACC__
