"""Host (numpy) finalization of the spectrum aggregate.

Copied from the JAX package's host finalize: the port pulls the counting
aggregate off the card once, adjudicates first occurrences against the
Bloom filter here, and builds the cuckoo lookup table on the host, then
copies it to the card.  merge_host_aggs merges the stream spans that the
counting tree spills to the host (ops/lsm.py).  Only the pieces the port
calls are kept.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..opts import BFC_BLK_SHIFT

# adjudicate_np switches to partitioned thread-pool sorting above this
# many packed keys (tests lower it to cover the parallel path)
_PAR_MIN = 1 << 22


class HostAgg(NamedTuple):
    """Host-resident per-distinct-k-mer aggregate (compact, sorted by
    (shard, keybody), no padding).  Field-for-field the dtype twin of
    ops.spectrum.Aggregate, so it feeds either finalize path."""

    shard: np.ndarray       # u32
    keybody: np.ndarray     # u64
    ret: np.ndarray         # u64 Bloom-addressing hash, or None when it
                            # is derivable from (shard, keybody): the
                            # merge chain then skips the column and
                            # finalize_host derives it once at the end
    n: np.ndarray           # u32 total occurrences (saturating)
    n_high: np.ndarray      # u32 high-quality occurrences (saturating)
    first_arr: np.ndarray   # u64 arrival of the first occurrence
    first_high: np.ndarray  # u32 is_high of the first occurrence
    bloom_min: object = None  # BloomMinSketch riding the FINAL aggregate
                            # only (AggBuilder.finish attaches it);
                            # always None on spans / through merges


def empty_host_agg() -> HostAgg:
    return HostAgg(
        shard=np.zeros(0, np.uint32), keybody=np.zeros(0, np.uint64),
        ret=np.zeros(0, np.uint64), n=np.zeros(0, np.uint32),
        n_high=np.zeros(0, np.uint32), first_arr=np.zeros(0, np.uint64),
        first_high=np.zeros(0, np.uint32),
    )


def merge_host_aggs(a: HostAgg, b: HostAgg, l_pre: int = None,
                    kb_bits: int = None, parallel: bool = True,
                    _ka: np.ndarray = None, _kb: np.ndarray = None) -> HostAgg:
    """Merge two sorted aggregates; `a` must cover the EARLIER stream span
    (bfc_tpu's spectrum_host.py:51-148; the counting spill's host merge,
    ops/lsm.py).

    Duplicate keys combine: occurrence counts add (saturating at u32),
    first-occurrence fields come from `a` (a-entries are placed before
    equal b-entries).  When l_pre/kb_bits are given and the identity
    fits 64 bits (k <= 32), both inputs being sorted lets a linear
    searchsorted merge replace the O(n log n) lexsort - the hot path of
    the LSM host spill at tens of millions of rows.  Big fast-path
    merges split into disjoint key ranges merged on a thread pool
    (equal keys land in the same range on both sides, so the
    a-before-b first-occurrence order is preserved range-locally)."""
    if len(a.shard) == 0:
        return b
    if len(b.shard) == 0:
        return a
    na, nb = len(a.shard), len(b.shard)
    fast = (
        l_pre is not None and kb_bits is not None
        and 64 - l_pre - kb_bits >= 0
    )
    if fast and parallel and na + nb >= _PAR_MIN:
        import os as _os

        nth = min(4, _os.cpu_count() or 1)
        if nth > 1:
            from concurrent.futures import ThreadPoolExecutor

            kbv = _kb if _kb is not None else posk64_np(
                b.shard, b.keybody, l_pre, kb_bits)
            ka = _ka if _ka is not None else posk64_np(
                a.shard, a.keybody, l_pre, kb_bits)
            splits = kbv[np.linspace(0, nb, nth, endpoint=False)[1:]
                         .astype(np.int64)]
            ao = np.concatenate(
                [[0], np.searchsorted(ka, splits, side="left"), [na]]
            ).astype(np.int64)
            bo = np.concatenate(
                [[0], np.searchsorted(kbv, splits, side="left"), [nb]]
            ).astype(np.int64)

            def _sl(f, lo, hi):
                return None if f is None else f[lo:hi]

            def part(i):
                return merge_host_aggs(
                    HostAgg(*(_sl(f, ao[i], ao[i + 1]) for f in a)),
                    HostAgg(*(_sl(f, bo[i], bo[i + 1]) for f in b)),
                    l_pre=l_pre, kb_bits=kb_bits, parallel=False,
                    _ka=ka[ao[i]:ao[i + 1]], _kb=kbv[bo[i]:bo[i + 1]],
                )

            with ThreadPoolExecutor(max_workers=nth) as pool:
                parts = list(pool.map(part, range(nth)))
            return HostAgg(
                *(None if any(c is None for c in cols)
                  else np.concatenate(cols) for cols in zip(*parts))
            )
    if fast:
        ka = _ka if _ka is not None else posk64_np(
            a.shard, a.keybody, l_pre, kb_bits)
        kbv = _kb if _kb is not None else posk64_np(
            b.shard, b.keybody, l_pre, kb_bits)
        # output slot per element: a before equal b (earlier span wins)
        out_a = np.searchsorted(kbv, ka, side="left") + np.arange(na)
        out_b = np.searchsorted(ka, kbv, side="right") + np.arange(nb)
        order = np.empty(na + nb, np.int64)
        order[out_a] = np.arange(na)
        order[out_b] = np.arange(na, na + nb)
    else:
        shard_cat = np.concatenate([a.shard, b.shard])
        keybody_cat = np.concatenate([a.keybody, b.keybody])
        order = np.lexsort((keybody_cat, shard_cat))  # stable: a first
    shard = np.concatenate([a.shard, b.shard])[order]
    keybody = np.concatenate([a.keybody, b.keybody])[order]
    first = np.empty(len(shard), bool)
    first[0] = True
    first[1:] = (shard[1:] != shard[:-1]) | (keybody[1:] != keybody[:-1])
    starts = np.flatnonzero(first)

    def pick(col_a, col_b):
        return np.concatenate([col_a, col_b])[order][starts]

    def addsum(col_a, col_b):
        v = np.concatenate([col_a, col_b])[order].astype(np.uint64)
        s = np.add.reduceat(v, starts)
        return np.minimum(s, 0xFFFFFFFF).astype(np.uint32)

    return HostAgg(
        shard=shard[starts], keybody=keybody[starts],
        ret=(None if a.ret is None or b.ret is None
             else pick(a.ret, b.ret)),
        n=addsum(a.n, b.n), n_high=addsum(a.n_high, b.n_high),
        first_arr=pick(a.first_arr, b.first_arr),
        first_high=pick(a.first_high, b.first_high),
    )


def bloom_probe_bits_np(ret: np.ndarray, bf_shift: int, n_hashes: int) -> np.ndarray:
    """Global probed bit ids per hash (bbf.c:27-37 addressing)."""
    x = bf_shift - BFC_BLK_SHIFT
    block = ret & np.uint64((1 << x) - 1)
    h1 = (ret >> np.uint64(x)) & np.uint64(511)
    h2 = (ret >> np.uint64(bf_shift)) & np.uint64(511)
    h2 = np.where((h2 & np.uint64(31)) == 0, (h2 + np.uint64(1)) & np.uint64(511), h2)
    H = n_hashes
    C = len(ret)
    # fast path: the first H steps of the z-walk are all valid (z >= 8),
    # true for ~(504/512)^H of rows; redo only the rest with the full
    # skip-walk (n_hashes+8 steps always suffice: an arithmetic
    # progression mod 512 with step not divisible by 32 has at most 8
    # consecutive terms below 8).
    out = np.empty((C, H), np.uint64)
    z = h1.copy()
    for j in range(H):
        out[:, j] = z
        z = (z + h2) & np.uint64(511)
    bad = np.flatnonzero((out < 8).any(axis=1))
    if bad.size:
        zb = h1[bad].copy()
        h2b = h2[bad]
        outb = np.zeros((bad.size, H), np.uint64)
        cnt = np.zeros(bad.size, np.int64)
        for _ in range(H + 8):
            take = np.flatnonzero((zb >= 8) & (cnt < H))
            outb[take, cnt[take]] = zb[take]
            cnt[take] += 1
            zb = (zb + h2b) & np.uint64(511)
        out[bad] = outb
    return (block[:, None] << np.uint64(BFC_BLK_SHIFT)) | out


def adjudicate_replay_np(ret: np.ndarray, first_arr: np.ndarray,
                         valid: np.ndarray, bf_shift: int,
                         n_hashes: int):
    """Arrival-ordered Bloom bit-array replay (C kernel): exact
    first-occurrence verdicts with 2^(bf_shift-3) BYTES of state - the
    human-scale adjudicate (bf_shift 33-34) where the min-arrival
    sketch's 4-bytes-per-bit table would be 32-64 GiB and the probe
    sort was the 738 s single-host finalize wall (round-3 rehearsal).
    Cost: one argsort of first_arr (unique: each first occurrence owns
    its stream slot) + one sequential C pass.  Returns None when the
    native library is unavailable (caller falls back to the sort)."""
    from ..native.build import get_lib

    lib = get_lib()
    if lib is None:
        return None
    import ctypes

    C = len(ret)
    out = np.zeros((C,), np.uint8)
    if C == 0:
        return out.astype(bool)
    retc = np.ascontiguousarray(ret)
    bitarr = np.zeros((1 << max(bf_shift - 6, 0),), np.uint64)

    def replay(order):
        lib.bloom_replay_verdict_u64(
            retc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(order), bf_shift, n_hashes,
            bitarr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        )

    # all n_hashes bits of a row live in ONE 512-bit Bloom block
    # (bit = block<<9 | z), so block-prefix partitions of the rows are
    # fully independent: replay them in parallel, each in its own
    # arrival order, over disjoint word ranges of the shared bit array
    import os as _os

    x = bf_shift - BFC_BLK_SHIFT
    nth = min(4, _os.cpu_count() or 1)
    if C >= (1 << 22) and nth > 1 and x >= 2:
        from concurrent.futures import ThreadPoolExecutor

        pb = 2
        pref = (retc & np.uint64((1 << x) - 1)) >> np.uint64(x - pb)

        def part(b):
            sel = np.flatnonzero(valid & (pref == b))
            order = sel[np.argsort(first_arr[sel], kind="stable")]
            replay(order.astype(np.int64))

        with ThreadPoolExecutor(max_workers=nth) as pool:
            list(pool.map(part, range(1 << pb)))
    else:
        sel = np.flatnonzero(valid)
        order = sel[np.argsort(first_arr[sel], kind="stable")]
        replay(order.astype(np.int64))
    return out.astype(bool) & valid


def adjudicate_np(ret: np.ndarray, first_arr: np.ndarray, valid: np.ndarray,
                  bf_shift: int, n_hashes: int) -> np.ndarray:
    """First-occurrence Bloom-hit verdicts (order-exact, vectorized).

    Fast path: pack (bit_id, arrival) into ONE u64 key so a single sort
    places each bit's probes in arrival order -- the segment minimum is
    then simply the segment's first element, which removes the
    reduceat/repeat/flatnonzero passes of the general path (measured
    ~3x on a 5M-row aggregate)."""
    C = len(ret)
    if C == 0:
        return np.zeros((0,), bool)
    bits = bloom_probe_bits_np(ret, bf_shift, n_hashes)      # [C,H]
    H = n_hashes
    sent = np.uint64(0xFFFFFFFFFFFFFFFF)
    a_max = int(first_arr.max()) if C else 0
    a_bits = max(1, a_max.bit_length())
    if bf_shift + a_bits <= 63:
        # key2d materializes directly from the broadcast (no np.repeat)
        key = np.where(
            valid[:, None],
            (bits << np.uint64(a_bits)) | first_arr[:, None],
            sent,
        ).reshape(-1)
        hit = np.empty(len(key), bool)

        def _verdict(keys, sel=None):
            order = np.argsort(keys, kind="stable")  # radix path for ints
            kv = keys[order]
            ka = kv & np.uint64((1 << a_bits) - 1)
            seg_first = np.empty(len(kv), bool)
            seg_first[0] = True
            seg_first[1:] = (
                (kv[1:] >> np.uint64(a_bits)) != (kv[:-1] >> np.uint64(a_bits))
            )
            # arrival at each element's segment start (the segment
            # minimum: arrivals sort ascending inside a fixed-bit segment)
            idx = np.arange(len(kv), dtype=np.int64)
            start_idx = np.maximum.accumulate(np.where(seg_first, idx, 0))
            was_set = (ka > ka[start_idx]) & (kv != sent)
            if sel is None:
                hit[order] = was_set
            else:
                hit[sel[order]] = was_set

        # big aggregates: partition by a bit-id prefix and sort the
        # partitions on a thread pool (numpy sorts release the GIL, and
        # four 1/4-size sorts beat one big one even serially).  Segments
        # are keyed by the full bit id, so a prefix partition never
        # splits one; sentinel keys (all-ones) land in the last bucket.
        import os as _os

        nth = min(4, _os.cpu_count() or 1)
        if len(key) >= _PAR_MIN and nth > 1:
            from concurrent.futures import ThreadPoolExecutor

            pb = 2
            # bit ids span exactly bf_shift bits, so keys occupy
            # a_bits + bf_shift bits; this shift spreads real keys
            # over all 1<<pb buckets (sentinels clamp into the last,
            # which stays correct: clamping is monotone in bit id)
            shift = np.uint64(a_bits + bf_shift - pb)
            bucket = np.minimum(key >> shift, np.uint64((1 << pb) - 1))
            with ThreadPoolExecutor(max_workers=nth) as pool:
                futs = []
                for b in range(1 << pb):
                    sel = np.flatnonzero(bucket == np.uint64(b))
                    if sel.size:
                        futs.append(pool.submit(_verdict, key[sel], sel))
                for f in futs:
                    f.result()
        else:
            _verdict(key)
        return hit.reshape(C, H).all(axis=1) & valid
    flat_bits = bits.reshape(-1)
    flat_arr = np.repeat(first_arr, H)
    flat_ok = np.repeat(valid, H)
    key = np.where(flat_ok, flat_bits, sent)
    order = np.argsort(key, kind="stable")  # radix path for ints
    kb = key[order]
    ka = flat_arr[order]
    first = np.empty(len(kb), bool)
    first[0] = True
    first[1:] = kb[1:] != kb[:-1]
    starts = np.flatnonzero(first)
    gmin = np.minimum.reduceat(ka, starts)
    counts = np.empty(len(starts), np.int64)
    np.subtract(starts[1:], starts[:-1], out=counts[:-1])
    counts[-1] = len(kb) - starts[-1]
    min_arr = np.repeat(gmin, counts)
    was_set = (min_arr < ka) & (kb != sent)
    hit = np.empty(len(kb), bool)
    hit[order] = was_set
    return hit.reshape(C, H).all(axis=1) & valid


class BloomMinSketch:
    """Incremental per-Bloom-bit minimum-arrival table.

    The adjudicate verdict (count.c:71-87 semantics) for each distinct
    k-mer only compares its first arrival against the GLOBAL minimum
    first arrival over every k-mer probing the same Bloom bit - and a
    global min is associative, so each LSM span can fold its partial
    minima in as it spills (bfc_tpu folds them on its spill worker; the
    port's AggBuilder scatters the whole aggregate once, spilled or not)
    instead of the finalize tail sorting every (bit, arrival) probe key
    at once.  Exactness argument: a span's first_arr for key
    x is the min arrival of x WITHIN the span, and min over spans of
    span-local minima equals x's global first arrival, so the dense
    array converges to exactly the per-bit minima adjudicate_np's sort
    computes.

    Arrivals are stored u32 INVERTED (dense = ~min_arrival, 0 = never
    probed): np.zeros allocates through calloc, so pages fault in
    lazily as probed - a 0xFF-filled init would commit the whole array
    (up to 8 GiB at the default max shift) on every AggBuilder
    construction (ADVICE r4).  scatter() marks the sketch invalid the
    moment an arrival exceeds 2^32-1 (full-human single-host streams),
    and finalize falls back to adjudicate_np - the sketch is a pure
    accelerator, never load-bearing.

    Exactness of the span folding additionally relies on arrivals being
    MONOTONE non-decreasing across spans (spans are contiguous stream
    slices pushed oldest-first; arrival counters never reset), so once
    any span overflows u32, no earlier span could have: the u32 check
    per span is therefore a global check.  A span carrying a
    0xFFFFFFFFFFFFFFFF padding sentinel trips the same guard; the
    invalidation is logged so the resulting finalize-sort slowdown is
    attributable."""

    def __init__(self, bf_shift: int, n_hashes: int):
        self.bf_shift = bf_shift
        self.n_hashes = n_hashes
        self.valid = True
        self.dense = np.zeros((1 << bf_shift,), np.uint32)

    # identity hash/eq (object default) are correct for register_static:
    # a HostAgg carrying a sketch can cross a jit boundary (the sketch
    # becomes a static aux value; device paths strip it first anyway)

    @staticmethod
    def create(bf_shift: int, n_hashes: int):
        import os

        if os.environ.get("BFC_TPU_INC_ADJ", "1") != "1":
            return None
        max_shift = int(os.environ.get("BFC_TPU_INC_ADJ_MAX_SHIFT", "31"))
        if bf_shift > max_shift:
            return None
        return BloomMinSketch(bf_shift, n_hashes)

    def scatter(self, ret: np.ndarray, first_arr: np.ndarray) -> None:
        """Fold one span's (ret, first_arr) partial minima in."""
        if not self.valid or len(ret) == 0:
            return
        if int(first_arr.max()) > 0xFFFFFFFF:
            from ..utils.log import log

            log("arrival exceeds u32: incremental adjudication sketch "
                "disabled (finalize falls back to the probe sort)",
                func="BloomMinSketch")
            self.valid = False
            self.dense = None
            return
        bits = bloom_probe_bits_np(ret, self.bf_shift, self.n_hashes)
        arr32 = first_arr.astype(np.uint32)
        from ..native.build import get_lib

        lib = get_lib()
        if lib is not None:
            import ctypes

            bits = np.ascontiguousarray(bits)
            lib.bloom_scatter_imin_u32(
                self.dense.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                arr32.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                len(ret), self.n_hashes,
            )
        else:
            np.maximum.at(self.dense, bits.reshape(-1),
                          np.repeat(~arr32, self.n_hashes))

    def verdict(self, ret: np.ndarray, first_arr: np.ndarray,
                valid: np.ndarray) -> np.ndarray:
        """Final verdicts from the converged minima (== adjudicate_np)."""
        assert self.valid
        C = len(ret)
        if C == 0:
            return np.zeros((0,), bool)
        bits = bloom_probe_bits_np(ret, self.bf_shift, self.n_hashes)
        arr32 = first_arr.astype(np.uint32)
        from ..native.build import get_lib

        lib = get_lib()
        if lib is not None:
            import ctypes

            bits = np.ascontiguousarray(bits)
            out = np.empty((C,), np.uint8)
            lib.bloom_gather_verdict_inv_u32(
                self.dense.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                arr32.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                C, self.n_hashes,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            )
            hit = out.astype(bool)
        else:
            # inverted storage: min < a  <=>  dense > ~a (0 = unset)
            hit = (self.dense[bits] > (~arr32)[:, None]).all(axis=1)
        return hit & valid


def posk64_np(shard, keybody, l_pre: int, kb_bits: int) -> np.ndarray:
    hi = shard.astype(np.uint64) << np.uint64(64 - l_pre)
    rem = 64 - l_pre - kb_bits
    if rem >= 0:
        lo = keybody << np.uint64(rem)
    else:
        lo = keybody >> np.uint64(-rem)
    return hi | lo


def _id_low_np(shard, keybody, l_pre: int, kb_bits: int, c_bits: int):
    nbits = l_pre + kb_bits - c_bits
    if nbits <= 0:
        return np.zeros(len(keybody), np.uint64)
    if nbits <= kb_bits:
        return keybody & np.uint64((1 << nbits) - 1)
    extra = nbits - kb_bits
    return ((shard.astype(np.uint64) & np.uint64((1 << extra) - 1))
            << np.uint64(kb_bits)) | keybody


def _cuckoo_place_np(s1, s2, S: int, max_rounds: int = 256):
    """Vectorized random-walk cuckoo placement: every unplaced key
    claims its currently-preferred slot (per-slot winner chosen by a
    RANDOMIZED write order -- a deterministic synchronous order can
    livelock in period-2 eviction cycles at scale); losers and evicted
    keys flip to their alternate slot and retry.  Converges in a few
    dozen rounds at load <= 0.4.  Returns (cur, pref, ok)."""
    n = len(s1)
    ids = np.arange(n, dtype=np.int64)
    pref = np.zeros(n, np.uint8)
    cur = s1.copy()
    occupant = np.full(S, -1, np.int64)
    rng = np.random.default_rng(0xBFC)  # seeded: reproducible layout
    for _ in range(max_rounds):
        pend = ids[occupant[cur] != ids]
        if pend.size == 0:
            break
        pend = pend[rng.permutation(pend.size)]
        occupant[cur[pend]] = pend
        pend2 = ids[occupant[cur] != ids]
        pref[pend2] ^= 1
        cur[pend2] = np.where(pref[pend2] == 0, s1[pend2], s2[pend2])
    else:
        if (occupant[cur] != ids).any():
            return cur, pref, False
    return cur, pref, True


def build_cuckoo_table_host(shard, keybody, payload, c_bits: int,
                            l_pre: int, kb_bits: int, max_rounds: int = 256):
    """Two-choice cuckoo placement (see spectrum.CuckooTable).

    Returns (entries u64[1<<c_bits], ok); ok False => caller falls back
    to the displacement layout."""
    n = len(shard)
    S = 1 << c_bits
    entries = np.zeros((S,), np.uint64)
    if n == 0:
        return entries, True
    from .spectrum import cuckoo_alt_np

    pk = posk64_np(shard, keybody, l_pre, kb_bits)
    s1 = (pk >> np.uint64(64 - c_bits)).astype(np.int64)
    qlow = _id_low_np(shard, keybody, l_pre, kb_bits, c_bits)
    # alt hash must match cuckoo_lookup/cuckoo_lookup32 bit-for-bit
    alt = cuckoo_alt_np(qlow, c_bits).astype(np.int64)
    cur, pref, ok = _cuckoo_place_np(s1, s1 ^ alt, S, max_rounds)
    if not ok:
        return entries, False
    entries[cur] = ((qlow << np.uint64(15))
                    | (pref.astype(np.uint64) << np.uint64(14))
                    | payload.astype(np.uint64))
    return entries, True


def in_key_order(shard: np.ndarray, keybody: np.ndarray) -> bool:
    """Whether rows are in strictly ascending (shard, keybody) order."""
    s_gt = shard[1:] > shard[:-1]
    s_eq = shard[1:] == shard[:-1]
    return bool(np.all(s_gt | (s_eq & (keybody[1:] > keybody[:-1]))))


def finalize_host(agg, bf_shift: int, n_hashes: int, k: int = None,
                  l_pre: int = None):
    """Numpy twin of spectrum.finalize_counts: payloads + hist.

    Returns (shard, keybody, payload) compact sorted arrays, hist,
    hist_high.  agg.ret may be None (derivable configs, see HostAgg):
    it is derived here, once, from (shard, keybody) - pass k/l_pre."""
    shard = np.asarray(agg.shard)
    keybody = np.asarray(agg.keybody)
    if agg.ret is None:
        from .spectrum_dense import derive_ret_np

        assert k is not None and l_pre is not None
        ret = derive_ret_np(shard, keybody.astype(np.uint64), k, l_pre)
    else:
        ret = np.asarray(agg.ret)
    n = np.asarray(agg.n)
    n_high = np.asarray(agg.n_high)
    first_arr = np.asarray(agg.first_arr)
    first_high = np.asarray(agg.first_high)
    valid = shard != 0xFFFFFFFF
    sketch = getattr(agg, "bloom_min", None)
    if (sketch is not None and sketch.valid
            and sketch.bf_shift == bf_shift and sketch.n_hashes == n_hashes):
        # incremental path: the per-bit minima converged span-by-span
        # during the stream; the verdict is one gather (see BloomMinSketch)
        fp = sketch.verdict(ret, first_arr, valid).astype(np.uint32)
    else:
        import os as _os

        fp = None
        if len(ret) >= int(_os.environ.get("BFC_TPU_REPLAY_MIN",
                                           str(1 << 25))):
            # big aggregates: the bit-array replay beats the probe sort
            # ~5x and uses 1 bit per Bloom slot (human-scale finalize)
            fp = adjudicate_replay_np(ret, first_arr, valid, bf_shift,
                                      n_hashes)
        if fp is None:
            fp = adjudicate_np(ret, first_arr, valid, bf_shift, n_hashes)
        fp = fp.astype(np.uint32)
    m = n - 1 + fp
    high = n_high - (1 - fp) * first_high
    keep = valid & (m >= 1)
    count = np.minimum(m, 255)
    high = np.minimum(high, 63)
    payload = (count | (high << 8)).astype(np.uint32)
    shard_c = shard[keep]
    keybody_c = keybody[keep]
    payload_c = payload[keep]
    # the device merge tree emits aggregates already sorted by
    # (shard, keybody); skip the O(n log n) lexsort when that holds
    # (one cheap monotonicity pass), keeping the sort for unsorted
    # producers (e.g. hash restore)
    if not in_key_order(shard_c, keybody_c):
        order = np.lexsort((keybody_c, shard_c))
        shard_c, keybody_c, payload_c = (
            shard_c[order], keybody_c[order], payload_c[order]
        )
    hist = np.bincount(payload_c & 0xFF, minlength=256)[:256]
    hist[0] = 0
    hist_high = np.bincount((payload_c >> 8) & 0x3F, minlength=64)[:64]
    return shard_c, keybody_c, payload_c, hist, hist_high
