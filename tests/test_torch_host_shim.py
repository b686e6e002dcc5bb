"""The CUDA kernels' per-read bodies, compiled for the CPU, against the
plain PyTorch versions.

csrc/*.cuh hold each kernel's per-slot and per-chunk (KA, KC, KH),
per-read (KD), per-row (KB, KE, KG, KJ, KK; the steps of KF's and KI's
block-local verdict), per-key (KL, KN), per-tile (KM) or per-query,
per-element and per-row (the probe
kernels KO-KR) body as __host__ __device__ functions; csrc/host_shim.cpp
wraps them in loops over the reads, rows or tiles that one CUDA thread
or block would take, and for KA, KC and KH over a warp's chunks and lanes,
building its ballot words lane by lane (KM: a block's warps and
threads one after another).  Here g++ builds
the shim (`-x c++ -D__host__= -D__device__=`) and ctypes loads it, so the
kernels' logic runs on a machine without a card.  Inputs are seeded
numpy batches and a tests/datagen.py dataset (a 12 kb genome, 100 bp
reads, 1% errors).  Every output is an integer: the tolerance is exact
equality."""

import ctypes
import functools
import itertools
import re
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from bfc_tpu_torch import kernels
from bfc_tpu_torch.models import counter as TC
from bfc_tpu_torch.models import refmodel as TM
from bfc_tpu_torch.models import trimmer as TT
from bfc_tpu_torch.ops import annotate as tann
from bfc_tpu_torch.ops import kmer as tk
from bfc_tpu_torch.ops import probe as tprobe
from bfc_tpu_torch.ops import route as troute
from bfc_tpu_torch.ops import search as tsrch
from bfc_tpu_torch.ops import spectrum as tspec
from bfc_tpu_torch.ops import spectrum_dense as tsdn
from bfc_tpu_torch.opts import Opts

from . import datagen

CSRC = Path(__file__).resolve().parents[1] / "bfc_tpu_torch" / "csrc"
P = ctypes.c_void_p


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    so = tmp_path_factory.mktemp("shim") / "libshim.so"
    subprocess.run(
        ["g++", "-x", "c++", "-D__host__=", "-D__device__=", "-std=c++17",
         "-O2", "-shared", "-fPIC", "-I", str(CSRC), "-o", str(so),
         str(CSRC / "host_shim.cpp")],
        check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    I, LL = ctypes.c_int, ctypes.c_longlong
    lib.ka_host.argtypes = [P, P, P, I, I, I, I, LL, P, P, P, P]
    lib.kb_host.argtypes = [LL, LL, I] + [P] * 14
    lib.kb_host.restype = LL
    lib.kc_host.argtypes = [P, P, I, I, I, I, I, I, P, P, I, I, P, P, P, P]
    lib.kd_host.argtypes = [P, P, I, I, I, I, I, P, I, I] + [P] * 8 + [I, P]
    lib.ke_host.argtypes = [LL] + [P] * 6
    lib.kf_host.argtypes = [LL, P, P, P, I, I, I, I, P, P]
    lib.kf_host.restype = LL
    lib.kg_host.argtypes = [LL, P, P, I, I, P]
    lib.kh_host.argtypes = [P, P, I, I, I, P, I, I, P]
    lib.probe_bits_host.argtypes = [LL, P, I, I, P]
    lib.ki_host.argtypes = [LL, P, P, I, I, I, I, P]
    lib.ki_host.restype = LL
    lib.kj_host.argtypes = [LL, P, P, I, I, P]
    lib.kk_host.argtypes = [LL] + [P] * 8 + [I]
    lib.kk_plan_host.argtypes = [LL] + [P] * 7
    lib.ck_host.argtypes = [LL, P, P, P, I, I, I, I, P, P, P, I, I]
    lib.subtable_slots_host.argtypes = [LL, P, P, I, I, I, I, P, P, P, P]
    lib.kh_steps_host.argtypes = [P, I, I]
    lib.kh_steps_host.restype = LL
    lib.km_count_host.argtypes = [LL, I, P, P, I, I, LL, P, P]
    lib.km_scatter_host.argtypes = [LL, I, P, P, I, I, LL] + [P] * 10
    lib.ko_host.argtypes = [LL, P, LL, P, I, P, P]
    lib.kp_row_host.argtypes = [LL, P, LL, P, I, P, P]
    lib.kp_column_host.argtypes = [LL, P, LL, P, I, I, P, P]
    lib.kp_lane_host.argtypes = [LL, P, P, I, P, P]
    lib.kq_registers_host.argtypes = [LL, P, P, I, P]
    lib.kq_shared_host.argtypes = [LL, P, P, I, P]
    lib.kr_host.argtypes = [LL, P, P, LL, P, I, I, P, P]
    for f in (lib.ko_host, lib.kp_row_host, lib.kp_column_host,
              lib.kp_lane_host, lib.kq_registers_host, lib.kq_shared_host,
              lib.kr_host):
        f.restype = None
    for f in (lib.ka_host, lib.kc_host, lib.kd_host, lib.ke_host,
              lib.kg_host, lib.kh_host, lib.probe_bits_host, lib.kj_host,
              lib.kk_host, lib.kk_plan_host, lib.km_count_host,
              lib.km_scatter_host,
              lib.subtable_slots_host, lib.ck_host):
        f.restype = None
    return lib


def _p(t):
    return None if t is None else t.data_ptr()


def _batch(seed, B=48, L=96):
    rng = np.random.default_rng(seed)
    genome = np.random.default_rng(0).integers(0, 4, 2000)
    starts = rng.integers(0, 2000 - L, B)
    bases = genome[starts[:, None] + np.arange(L)[None, :]].astype(np.uint8)
    bases = np.where(rng.random((B, L)) < 0.02, (bases + 1) % 4, bases)
    bases[rng.random((B, L)) < 0.01] = 4
    lens = rng.integers(5, L + 1, B).astype(np.int32)
    lens[:3] = [0, 1, L]
    qok = rng.random((B, L)) < 0.85
    return (torch.from_numpy(bases.astype(np.uint8)), torch.from_numpy(qok),
            torch.from_numpy(lens))


def _edge_batch(seed, L, B=48):
    """_batch at L slots with the warp's chunk edges placed: rows 3-5 all
    ACGT but an N at slot 31, 32 or 63, rows 6-8 all ACGT and quality-ok
    but a low-quality base there, and reads whose length ends mid-chunk."""
    bases, qok, lens = (t.numpy().copy() for t in _batch(seed, B, L))
    rng = np.random.default_rng(seed + 1)
    for row, slot in zip(range(3, 9), (31, 32, 63, 31, 32, 63)):
        bases[row] = rng.integers(0, 4, L)
        qok[row] = True
        lens[row] = L
        if slot < L:
            if row < 6:
                bases[row, slot] = 4
            else:
                qok[row, slot] = False
    lens[9:15] = [min(n, L) for n in (1, 31, 33, 45, 97, L - 1)]
    return (torch.from_numpy(bases), torch.from_numpy(qok),
            torch.from_numpy(lens))


CHUNK_LS = (31, 32, 33, 100, 600)
EDGE_KS = (17, 23, 32, 33, 63)
# (k, L): the first five at _batch's 96 slots keep their ids; then every
# k at slot counts around the warp's 32-slot chunks and at 600
KA_CASES = [pytest.param(k, None, id=str(k)) for k in EDGE_KS] + [
    pytest.param(k, L, id=f"k{k}-L{L}") for L in CHUNK_LS for k in EDGE_KS]


@pytest.mark.parametrize("k,L", KA_CASES)
def test_ka_body_matches_plain(shim, k, L):
    """KA's warp, emulated lane by lane, against the plain version."""
    bases, qok, lens = _batch(k) if L is None else _edge_batch(k, L)
    B, L = bases.shape
    o = Opts()
    o.k = k
    l_pre = o.effective_l_pre()
    want = tk.kmer_stream_plain(bases, qok, lens, k, l_pre, 777, True)
    got = [torch.empty((B, L), dtype=torch.int64) for _ in range(4)]
    shim.ka_host(_p(bases), _p(qok), _p(lens), B, L, k, l_pre, 777,
                 *(_p(g) for g in got))
    for name, w, g in zip(("shard", "keybody", "arrp", "ret"), want, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)


def _kb_host(shim, srt, tile, lazy=0):
    """KB's tile bodies in order over a sorted run: (Run, groups)."""
    N = len(srt)
    got = tsdn.Run(*(torch.full((N,), -7, dtype=torch.int64)
                     for _ in range(5)),
                   torch.full((N,), 9, dtype=torch.uint8),
                   None if srt.ret is None
                   else torch.full((N,), -7, dtype=torch.int64))
    C = shim.kb_host(N, tile, lazy, *(_p(f) for f in srt),
                     *(_p(f) for f in got))
    return tsdn.Run(*(None if f is None else f[:C] for f in got)), C


def _assert_runs_equal(got, want):
    assert len(got) == len(want)
    for name, w, g in zip(tsdn.Run._fields, want, got):
        assert (w is None) == (g is None), name
        if w is not None:
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)


def _merge_input(k):
    """The sorted [older, newer] input of a merge: a batch's run and the
    same reads again later in the stream, so every key repeats."""
    o = Opts()
    o.k = k
    l_pre = o.effective_l_pre()
    carry = not tsdn.ret_derivable(k, l_pre)
    bases, qok, lens = _batch(5)
    a = tsdn.chunk_run(bases, qok, lens, 0, k, l_pre, carry)
    b = tsdn.chunk_run(bases, ~qok, lens, bases.numel(), k, l_pre, carry)
    cat = tsdn.Run(*(None if x is None else torch.cat([x, y])
                     for x, y in zip(a, b)))
    return tsdn._gather(cat, tsdn.stable_order(cat.shard, cat.keybody))


@pytest.mark.parametrize("k", [23, 63])
def test_kb_body_matches_plain(shim, k):
    srt = _merge_input(k)
    want = tsdn.run_combine_plain(srt)
    got, C = _kb_host(shim, srt, 2048)
    assert C == len(want) < len(srt)
    _assert_runs_equal(got, want)


def _sorted_rows(rng, N, n_keys, invalid_tail, with_ret):
    """A sorted run of N rows over n_keys keys with random group lengths
    (keys repeat 1-6 times) and invalid_tail INVALID_SHARD rows last."""
    valid = N - invalid_tail
    shard = np.sort(rng.integers(0, n_keys, valid)).astype(np.int64)
    keybody = shard * 7 + 3
    shard = np.concatenate([shard, np.full(invalid_tail, 0xFFFFFFFF)])
    keybody = np.concatenate([keybody, rng.integers(0, 100, invalid_tail)])
    cols = [torch.from_numpy(c.astype(np.int64)) for c in
            (shard, keybody, rng.integers(0, 1 << 40, N),
             rng.integers(1, 5, N), rng.integers(0, 3, N))]
    fh = torch.from_numpy(rng.integers(0, 2, N).astype(np.uint8))
    ret = (torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, N))
           if with_ret else None)
    return tsdn.Run(*cols, fh, ret)


@pytest.mark.parametrize("with_ret", [False, True], ids=["no-ret", "ret"])
@pytest.mark.parametrize("lazy", [0, 1], ids=["prefix", "walk-back"])
@pytest.mark.parametrize("tile", [1, 2, 3, 7, 64])
def test_kb_tiles_across_groups_match_plain(shim, tile, lazy, with_ret):
    """Tiles shorter than most groups, so groups straddle one or more tile
    edges; an all-invalid tail; every look-back walking to tile 0."""
    rng = np.random.default_rng(tile * 10 + lazy)
    srt = _sorted_rows(rng, 400, 120, 37, with_ret)
    want = tsdn.run_combine_plain(srt)
    got, C = _kb_host(shim, srt, tile, lazy)
    assert 0 < C < 363
    _assert_runs_equal(got, want)


@pytest.mark.parametrize("with_ret", [False, True], ids=["no-ret", "ret"])
@pytest.mark.parametrize("N,invalid", [(0, 0), (1, 0), (1, 1), (65, 0),
                                       (65, 65), (65, 1)])
def test_kb_tile_edges_match_plain(shim, N, invalid, with_ret):
    """N = 0, 1 and one row past a 64-row tile; all rows invalid; one
    invalid row alone in the last tile."""
    rng = np.random.default_rng(N + invalid)
    srt = _sorted_rows(rng, N, 20, invalid, with_ret)
    want = tsdn.run_combine_plain(srt)
    for lazy in (0, 1):
        got, C = _kb_host(shim, srt, 64, lazy)
        _assert_runs_equal(got, want)


@functools.lru_cache(maxsize=None)
def _counted_spectrum(k):
    """A port spectrum (CPU, plain versions) of a small dataset, and an
    encoded batch of its reads."""
    with tempfile.TemporaryDirectory() as d:
        return _count_spectrum(k, d)


@pytest.fixture(scope="module", params=[21, 33])
def spectrum(request):
    return _counted_spectrum(request.param)


def _count_spectrum(k, d):
    genome = datagen.make_genome(12000, seed=61)
    reads = datagen.simulate_reads(genome, 1500, read_len=100,
                                   err_rate=0.01, seed=62)
    fq = f"{d}/reads.fq"
    datagen.write_fastq(fq, reads)
    opt = Opts()
    opt.k = k
    opt.bf_shift = 24
    ds = TC.count_file_device(fq, opt, "cpu", batch_reads=512)
    sub = reads[:160]
    bases, _, lens = tk.encode_batch([s for s, _ in sub], None, opt.q)
    qf = np.zeros(bases.shape, bool)
    for i, (_, q) in enumerate(sub):
        qf[i, :len(q)] = np.frombuffer(q.encode(), np.uint8) - 33 >= opt.q
    qf &= bases <= 3
    return opt, ds, torch.from_numpy(bases), torch.from_numpy(qf), \
        torch.from_numpy(lens)


def _table_args(t):
    """(table, subtables, db, keep-alive) as the host bodies take a
    SpecTable or a ShardedTable: the sub-tables' host addresses."""
    if isinstance(t, tspec.ShardedTable):
        ptrs = np.array([s.data_ptr() for s in t.subtables], np.uint64)
        return None, ptrs.ctypes.data, t.db, ptrs
    return _p(t.table), None, 0, None


def _kc_host(shim, t, bases, lens, min_cov):
    B, L = bases.shape
    occ = torch.empty((B, L), dtype=torch.int32)
    lcov = torch.empty((B, L), dtype=torch.uint8)
    hcov = torch.empty_like(lcov)
    isl = torch.empty((B, 3), dtype=torch.int32)
    table, subs, db, _keep = _table_args(t)
    shim.kc_host(table, subs, db, t.k, t.l_pre, t.kb_bits, t.c_bits,
                 min_cov, _p(bases), _p(lens), B, L, _p(occ), _p(lcov),
                 _p(hcov), _p(isl))
    return occ, lcov, hcov, isl


KD_STACK1 = 512  # csrc/ec1_search.cuh: pass 1's stack a thread on the card


def _kd_host(shim, t, opt, mode, bases, qf, lens, lcov, hcov, isl,
             heap_cap, stack_cap, stack1=KD_STACK1):
    """KD's two passes over the batch, each by one serial worker: (packed,
    out); the reads pass 1 deferred are in _kd_host.deferred."""
    B, L = bases.shape
    packed = torch.empty((B, L), dtype=torch.uint8)
    out = torch.full((B, tsrch.N_OUT), -9, dtype=torch.int32)
    deferred = ctypes.c_int32()
    ip = tsrch._iparams(opt, mode, heap_cap, stack_cap)
    table, subs, db, _keep = _table_args(t)
    shim.kd_host(table, subs, db, t.k, t.l_pre, t.kb_bits, t.c_bits,
                 ip.ctypes.data, B, L, _p(bases), _p(qf), _p(lens), _p(lcov),
                 _p(hcov), _p(isl), _p(packed), _p(out), stack1,
                 ctypes.byref(deferred))
    _kd_host.deferred = deferred.value
    return packed, out


MIN_COV = Opts().min_cov


def _kc_table(k, L, db=None, seed=5):
    """A table over _edge_batch(seed, L)'s own k-mers, with rows whose
    solid k-mer ends are placed: row 10 two equal longest runs (the first
    wins), row 11 the longest run reaching the read's end, row 12 equal
    runs of which the second reaches the end.  Other keys get random
    counts, a tenth none.  Replicated (db None) or 2^db sub-tables built
    by the plain KN.  Returns (table, bases, lens, expected islands of
    rows 10-12 or None where the read holds too few k-mers)."""
    bases, qok, lens = _edge_batch(seed, L)
    rng = np.random.default_rng(seed + L + k)
    b = bases.numpy()
    b[10:13] = rng.integers(0, 4, (3, L))
    lens[10:13] = L
    o = Opts()
    o.k = k
    l_pre = o.effective_l_pre()
    kb_bits = tk.keybody_bits(k, l_pre)
    shard, keybody, _, _ = tk.kmer_stream_plain(bases, qok, lens, k, l_pre)
    keys = np.stack([shard.numpy().ravel(), keybody.numpy().ravel()], 1)
    valid = keys[:, 0] != tk.INVALID_SHARD
    uniq, inv = np.unique(keys[valid], axis=0, return_inverse=True)
    inv = inv.ravel()
    payload = (rng.integers(1, 7, len(uniq))
               | rng.integers(0, 9, len(uniq)) << 8)
    payload[rng.random(len(uniq)) < 0.1] = 0
    slot_key = np.full(keys.shape[0], -1)
    slot_key[valid] = inv
    slot_key = slot_key.reshape(bases.shape)
    n = L - (k - 1)  # slots where a k-mer ends
    R = n // 4
    islands = None
    if R >= 1:
        a = k - 1
        runs = {10: [(a + 1, R), (a + R + 2, R)],
                11: [(a, R - 1), (L - R, R)],
                12: [(a, R), (L - R, R)]}
        for row, rs in runs.items():
            solid = np.zeros(L, bool)
            for start, m in rs:
                solid[start:start + m] = True
            ids = slot_key[row, a:]
            payload[ids] = np.where(solid[a:], MIN_COV + 1, 1) | 5 << 8
        islands = [[1, a + 1 + R, 1], [L - R - k + 1, L, 1],
                   [0, a + R, 1]]
    keep = payload != 0
    ks, kb = (torch.from_numpy(c.astype(np.int64))
              for c in (uniq[keep, 0], uniq[keep, 1]))
    pl = torch.from_numpy(payload[keep].astype(np.int32))
    if db is None:
        c_bits = TC.table_c_bits(len(ks), k, l_pre)
        table, ok = tspec.cuckoo_build_plain(ks, kb, pl, k, l_pre, kb_bits,
                                             c_bits)
        assert ok
        return (tspec.SpecTable(table, k, l_pre, kb_bits, c_bits), bases,
                lens, islands)
    owner = tspec.subtable_owner(ks, kb, l_pre, kb_bits, db)
    cb_local = TC.subtable_bits(int(torch.bincount(owner).max()), k, l_pre,
                                db)
    subs = []
    for r in range(1 << db):
        sel = owner == r
        t, ok = tspec.cuckoo_build_local_plain(ks[sel], kb[sel], pl[sel],
                                               l_pre, kb_bits, db + cb_local,
                                               db)
        assert ok
        subs.append(t)
    return (tspec.sharded_table(subs, k, l_pre, kb_bits, db), bases, lens,
            islands)


# the counted spectra at k 21 and 33 keep their ids; then tables over
# the reads' own k-mers at every k and slot count around the chunks, and
# sharded sub-tables
KC_CASES = [pytest.param(k, None, None, id=str(k)) for k in (21, 33)] + [
    pytest.param(k, L, None, id=f"k{k}-L{L}")
    for L in CHUNK_LS for k in EDGE_KS] + [
    pytest.param(k, L, db, id=f"k{k}-L{L}-sharded{db}")
    for k, L, db in ((23, 100, 1), (33, 600, 3), (63, 600, 1))]


@pytest.mark.parametrize("k,L,db", KC_CASES)
def test_kc_body_matches_plain(shim, k, L, db):
    """KC's warp, emulated lane by lane, against the plain version; the
    placed islands take the first of equal runs and end a run at the
    read's end."""
    if L is None:
        opt, ds, bases, _, lens = _counted_spectrum(k)
        t, min_cov, islands = ds.table, opt.min_cov, None
    else:
        t, bases, lens, islands = _kc_table(k, L, db)
        min_cov = MIN_COV
    want = tann.kcov_island_plain(t, bases, lens, min_cov)
    got = _kc_host(shim, t, bases, lens, min_cov)
    for name, w, g in zip(("occ", "lcov", "hcov", "isl"), want, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
    if L is None or islands is not None:
        assert bool((want[3][:, 2] == 1).any())
    if islands is not None:
        assert want[3][10:13].tolist() == islands


@pytest.mark.parametrize("caps", [(tsrch.HEAP_CAP, tsrch.STACK_CAP), (24, 120)],
                         ids=["main-caps", "tiny-caps"])
def test_kd_body_matches_plain(shim, spectrum, caps):
    """tiny-caps makes reads overflow, so both sides' overflow flags and
    the inputs kept for the fallback are compared too."""
    opt, ds, bases, qf, lens = spectrum
    t = ds.table
    _, lcov, hcov, isl = tann.kcov_island_plain(t, bases, lens, opt.min_cov)
    heap_cap, stack_cap = caps
    want_packed, want_out = tsrch.ec1_search_plain(
        t, opt, ds.mode, bases, qf, lens, lcov, hcov, isl, heap_cap,
        stack_cap)
    B = bases.shape[0]
    packed, out = _kd_host(shim, t, opt, ds.mode, bases, qf, lens, lcov,
                           hcov, isl, heap_cap, stack_cap)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(packed, want_packed, rtol=0, atol=0)
    n_ovf = int(want_out[:, tsrch.OVERFLOW].sum())
    if heap_cap == tsrch.HEAP_CAP:
        assert n_ovf == 0 and int((want_out[:, tsrch.N_EC] > 0).sum()) > 10
    else:
        assert 0 < n_ovf < B


@pytest.mark.parametrize("caps", [(tsrch.HEAP_CAP, tsrch.STACK_CAP), (24, 120)],
                         ids=["main-caps", "tiny-caps"])
def test_kd_deferred_reads_match_plain(shim, spectrum, caps):
    """Pass 1 with a 40-entry stack defers most reads (a 100 bp read
    pushes ~100 a direction); pass 2 runs them again with the full stack.
    The result, the overflow set and KD_PROBES read by read are the plain
    version's, as with no deferral."""
    opt, ds, bases, qf, lens = spectrum
    t = ds.table
    _, lcov, hcov, isl = tann.kcov_island_plain(t, bases, lens, opt.min_cov)
    want = tsrch.ec1_search_plain(t, opt, ds.mode, bases, qf, lens, lcov,
                                  hcov, isl, *caps)
    one_pass = _kd_host(shim, t, opt, ds.mode, bases, qf, lens, lcov, hcov,
                        isl, *caps, stack1=caps[1])
    assert _kd_host.deferred == 0
    got = _kd_host(shim, t, opt, ds.mode, bases, qf, lens, lcov, hcov, isl,
                   *caps, stack1=40)
    assert 20 < _kd_host.deferred <= bases.shape[0]
    for g in (one_pass, got):
        torch.testing.assert_close(g[1], want[1], rtol=0, atol=0)
        torch.testing.assert_close(g[0], want[0], rtol=0, atol=0)
    probes = got[1][:, tsrch.PROBES]
    assert torch.equal(probes, want[1][:, tsrch.PROBES])
    searched = want[1][:, tsrch.OVERFLOW] == 0
    assert int((probes[searched] > 0).sum()) > 100


def _refine_codes(bases, qf, seed):
    """The batch as -R gives it to KC and KD: in a third of the reads one
    to three bases become codes 4-7 (a quality of '!' to '&' substituted,
    Corrector.device_step), quality flag off there, within the many-N
    gate's 5%."""
    rng = np.random.default_rng(seed)
    b, q = bases.clone(), qf.clone()
    for i in range(0, b.shape[0], 3):
        for j in rng.choice(100, int(rng.integers(1, 4)), replace=False):
            b[i, j] = int(rng.integers(4, 8))
            q[i, j] = False
    return b, q


@pytest.mark.parametrize("caps", [(tsrch.HEAP_CAP, tsrch.STACK_CAP), (24, 120)],
                         ids=["main-caps", "tiny-caps"])
def test_kc_kd_bodies_match_plain_on_refine_codes(shim, spectrum, caps):
    """Codes 5-7 reach KC and KD only under -R.  KC takes every code above
    3 as an N; KD keeps a code of 5-7 where neither direction wrote the
    position, as its plain version now does, and assemble writes it as
    N (tests/test_torch_refine.py holds the records to the scalar model)."""
    opt, ds, bases, qf, lens = spectrum
    t = ds.table
    bases, qf = _refine_codes(bases, qf, seed=opt.k)
    want_kc = tann.kcov_island_plain(t, bases, lens, opt.min_cov)
    got_kc = _kc_host(shim, t, bases, lens, opt.min_cov)
    for name, w, g in zip(("occ", "lcov", "hcov", "isl"), want_kc, got_kc):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
    _, lcov, hcov, isl = want_kc
    want = tsrch.ec1_search_plain(t, opt, ds.mode, bases, qf, lens, lcov,
                                  hcov, isl, *caps)
    got = _kd_host(shim, t, opt, ds.mode, bases, qf, lens, lcov, hcov, isl,
                   *caps)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    packed, out = want
    kept = (packed & 7) > 4
    fixed = ((packed >> 5) > 4) & ((packed & 8) != 0)
    assert bool(kept.any()) and not bool((packed[kept] & 8).any())
    assert int(fixed.sum()) > 20


@pytest.fixture(scope="module")
def spectrum63(tmp_path_factory):
    """The spectrum fixture's reads at k = 63 (four u64 planes a state)."""
    d = tmp_path_factory.mktemp("shim63")
    genome = datagen.make_genome(12000, seed=61)
    reads = datagen.simulate_reads(genome, 1500, read_len=100,
                                   err_rate=0.01, seed=62)
    fq = f"{d}/reads.fq"
    datagen.write_fastq(fq, reads)
    opt = Opts()
    opt.k = 63
    opt.bf_shift = 24
    ds = TC.count_file_device(fq, opt, "cpu", batch_reads=512)
    sub = reads[:160]
    bases, _, lens = tk.encode_batch([s for s, _ in sub], None, opt.q)
    qf = np.zeros(bases.shape, bool)
    for i, (_, q) in enumerate(sub):
        qf[i, :len(q)] = np.frombuffer(q.encode(), np.uint8) - 33 >= opt.q
    qf &= bases <= 3
    return opt, ds, torch.from_numpy(bases), torch.from_numpy(qf), \
        torch.from_numpy(lens)


@pytest.mark.parametrize("stack1", [KD_STACK1, 40])
def test_kd_body_matches_plain_k63(shim, spectrum63, stack1):
    opt, ds, bases, qf, lens = spectrum63
    t = ds.table
    _, lcov, hcov, isl = tann.kcov_island_plain(t, bases, lens, opt.min_cov)
    caps = (tsrch.HEAP_CAP, tsrch.STACK_CAP)
    want = tsrch.ec1_search_plain(t, opt, ds.mode, bases, qf, lens, lcov,
                                  hcov, isl, *caps)
    got = _kd_host(shim, t, opt, ds.mode, bases, qf, lens, lcov, hcov, isl,
                   *caps, stack1=stack1)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    assert int((want[1][:, tsrch.PROBES] > 0).sum()) > 50
    assert int((want[1][:, tsrch.N_EC] > 0).sum()) > 0


@pytest.mark.parametrize("bf_shift", [20, 33, 37])
def test_bloom_probe_bits_body_matches_plain(shim, bf_shift):
    rng = np.random.default_rng(bf_shift)
    ret = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, 5000,
                                        dtype=np.int64))
    for H in (1, 4, 7):
        got = torch.empty((len(ret), H), dtype=torch.int64)
        shim.probe_bits_host(len(ret), _p(ret), bf_shift, H, _p(got))
        torch.testing.assert_close(
            got, tspec.bloom_probe_bits(ret, bf_shift, H), rtol=0, atol=0)


@pytest.fixture(scope="module", params=[21, 51])
def trim_agg(request, tmp_path_factory):
    """A port trim aggregate (CPU, plain versions) at -b20, its run on the
    host, and its KF inputs."""
    k = request.param
    d = tmp_path_factory.mktemp(f"trim{k}")
    genome = datagen.make_genome(12000, seed=63)
    reads = datagen.simulate_reads(genome, 1500, read_len=100,
                                   err_rate=0.01, seed=64)
    fq = f"{d}/reads.fq"
    datagen.write_fastq(fq, reads)
    opt = Opts()
    opt.k = k
    opt.bf_shift = 20
    b = TC.AggBuilder(opt, "cpu")
    for bases, qok, lens, _ in TC.padded_batches(fq, opt, 512):
        b.add(bases, qok, lens)
    run = b.fold()
    agg = b.pull(run)
    ret = torch.from_numpy(agg.ret.view(np.int64))
    arr = torch.from_numpy(agg.first_arr.astype(np.uint32).view(np.int32))
    n = torch.from_numpy(agg.n.astype(np.int32))
    return opt, run, ret, arr, n, [s for s, _ in reads[:300]]


def test_ke_body_matches_plain(shim, trim_agg):
    _, run, _, _, _, _ = trim_agg
    # counts and arrivals past the saturation and 2^32 points
    run = tsdn.Run(run.shard, run.keybody, run.arr + (5 << 32), run.n * 300,
                   run.n_high * 300, run.first_high, run.ret)
    want = tsdn.pack_pull_plain(run)
    C = len(run)
    a_lo = torch.empty((C,), dtype=torch.int32)
    nfh = torch.empty((C,), dtype=torch.int32)
    shim.ke_host(C, _p(run.arr), _p(run.n), _p(run.n_high),
                 _p(run.first_high), _p(a_lo), _p(nfh))
    torch.testing.assert_close(a_lo, want.a_lo, rtol=0, atol=0)
    torch.testing.assert_close(nfh, want.nfh, rtol=0, atol=0)


def _kf_host(shim, ret, arr, n, bf_shift, H, reverse=False, sb=None):
    """KF's verdict steps on the CPU (vd_host on u32 arrivals) with
    superblocks of 2^sb blocks (the wrapper's verdict_shift by default);
    the scatter takes the rows from the last with reverse."""
    C = len(ret)
    sb = tspec.verdict_shift(C, bf_shift) if sb is None else sb
    fp = torch.empty((C,), dtype=torch.bool)
    keep = torch.empty((C,), dtype=torch.bool)
    dirty = shim.kf_host(C, _p(ret), _p(arr), _p(n), bf_shift, sb, H,
                         int(reverse), _p(fp), _p(keep))
    assert dirty == 0   # every per-bit minimum was reset
    return fp, keep


def _ki_host(shim, ret, arr, bf_shift, H, reverse=False, sb=None):
    """KI's verdict steps on the CPU (vd_host on u64 arrivals)."""
    C = len(ret)
    sb = tspec.verdict_shift(C, bf_shift) if sb is None else sb
    fp = torch.empty((C,), dtype=torch.bool)
    assert shim.ki_host(C, _p(ret), _p(arr), bf_shift, sb, H, int(reverse),
                        _p(fp)) == 0
    return fp


def _shifts(C, bf_shift):
    """The wrapper's superblock shift (superblocks staged in shared
    memory), 0 (each block read whole) and the largest (superblocks past
    VD_CAP rows, read block by block)."""
    return (tspec.verdict_shift(C, bf_shift), 0,
            min(tspec.SB_MAX, bf_shift - tspec.BLK_SHIFT))


def _rows_a_block(ret, bf_shift):
    block = ret & ((1 << (bf_shift - tspec.BLK_SHIFT)) - 1)
    return torch.bincount(block, minlength=1 << (bf_shift - tspec.BLK_SHIFT))


def test_kf_body_matches_plain(shim, trim_agg):
    """KF's steps on the trim aggregate, with the scatter in the natural
    order and reversed (the verdict is free of the order in a block), at
    each superblock shift of _shifts."""
    opt, _, ret, arr, n, _ = trim_agg
    want = tspec.adjudicate_sketch_plain(ret, arr, n, opt.bf_shift,
                                         opt.n_hashes)
    for sb in _shifts(len(ret), opt.bf_shift):
        for reverse in (False, True):
            got = _kf_host(shim, ret, arr, n, opt.bf_shift, opt.n_hashes,
                           reverse, sb)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert int((want[0] & (n == 1)).sum()) > 0


def _kg_host(shim, opt, ret, keep):
    words = torch.zeros((1 << (opt.bf_shift - 5),), dtype=torch.int32)
    shim.kg_host(len(ret), _p(ret), _p(keep), opt.bf_shift, opt.n_hashes,
                 _p(words))
    return words


def test_kg_kh_bodies_match_plain(shim, trim_agg):
    opt, _, ret, arr, n, seqs = trim_agg
    _, keep = tspec.adjudicate_sketch_plain(ret, arr, n, opt.bf_shift,
                                            opt.n_hashes)
    words = _kg_host(shim, opt, ret, keep)
    torch.testing.assert_close(
        words, TT.bloom_build_plain(ret, keep, opt.bf_shift, opt.n_hashes),
        rtol=0, atol=0)
    seqs = seqs + ["ACGTN" * 30, "", seqs[0][:opt.k - 1]]
    bases, _, lens = tk.encode_batch(seqs, None, opt.q)
    bases, lens = torch.from_numpy(bases), torch.from_numpy(lens)
    B, L = bases.shape
    got = torch.empty((B,), dtype=torch.int64)
    shim.kh_host(_p(bases), _p(lens), B, L, opt.k, _p(words), opt.bf_shift,
                 opt.n_hashes, _p(got))
    want = TT.max_streak_plain(words, bases, lens, opt.k, opt.bf_shift,
                               opt.n_hashes)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (want[:300] >> 32 > 0).float().mean() > 0.75


KH_KS = (17, 31, 32, 33, 51, 63)
N_SLOTS = (31, 32, 63)    # an N there: a warp chunk's edges


def _kh_case(k, L, seed=40):
    """Bloom words (-b20, 4 hashes) holding every k-mer of a seeded 3 kb
    genome, and 40 rows of L slots: genome reads with 1% errors and 0.5%
    Ns, and edge rows: 0-2 clean reads with an N at slot 31, 32 or 63; 3 a
    read shorter than k; 4 random bases (no hit); 5 a clean read (all
    hits); 6 two runs of five hits split by an N (where 2k + 9 <= L), the
    rest random; 7-8 clean reads ending at L - 1 and L // 2 + 3 with
    genome bases after their length; 9 empty."""
    rng = np.random.default_rng(seed + 7 * k + L)
    G = 3000
    genome = rng.integers(0, 4, G).astype(np.uint8)
    opt = Opts()
    opt.k = k
    opt.bf_shift = 20
    gb = torch.from_numpy(genome[None, :])
    _, _, _, ret = tk.kmer_stream_plain(
        gb, torch.ones_like(gb, dtype=torch.bool),
        torch.tensor([G], dtype=torch.int32), k, opt.effective_l_pre(), 0,
        True)
    ret = ret.view(-1)[k - 1:]
    words = TT.bloom_build_plain(ret, torch.ones_like(ret, dtype=torch.bool),
                                 opt.bf_shift, opt.n_hashes)

    def clean(n):
        a = int(rng.integers(0, G - n))
        return genome[a:a + n]

    B = 40
    bases = np.stack([clean(L) for _ in range(B)])
    bases = np.where(rng.random((B, L)) < 0.01, (bases + 1) % 4, bases)
    bases[rng.random((B, L)) < 0.005] = 4
    lens = np.full((B,), L, np.int32)
    for row, slot in enumerate(N_SLOTS):
        bases[row] = clean(L)
        if slot < L:
            bases[row, slot] = 4
    bases[3] = clean(L)
    lens[3] = min(k - 1, L)
    # random bases, drawn again while the reference finds a hit in them
    probe = TT.WordsProbe(TT.DeviceBloom(words, opt.bf_shift, opt.n_hashes))
    while True:
        bases[4] = rng.integers(0, 4, L)
        if TM.max_streak(k, probe, "".join("ACGT"[c] for c in bases[4])) == L:
            break
    bases[5] = clean(L)
    bases[6] = rng.integers(0, 4, L)
    if 2 * k + 9 <= L:
        a, b = rng.integers(0, G - k - 5, 2)
        bases[6, :k + 4] = genome[a:a + k + 4]
        bases[6, k + 4] = 4
        bases[6, k + 5:2 * k + 9] = genome[b:b + k + 4]
        if 2 * k + 9 < L:  # the second run ends there too
            bases[6, 2 * k + 9] = (genome[b + k + 4] + 1) % 4
    for row, n in ((7, L - 1), (8, L // 2 + 3)):
        bases[row] = clean(L)
        lens[row] = n
    lens[9] = 0
    return (opt, words, torch.from_numpy(bases.astype(np.uint8)),
            torch.from_numpy(lens))


@pytest.mark.parametrize("L", CHUNK_LS)
@pytest.mark.parametrize("k", KH_KS)
def test_kh_warp_body_matches_plain_and_refmodel(shim, k, L):
    """KH's warp a read, emulated lane by lane, against max_streak_plain
    and refmodel.max_streak (the reference's max_streak) on _kh_case."""
    opt, words, bases, lens = _kh_case(k, L)
    B = bases.shape[0]
    got = torch.empty((B,), dtype=torch.int64)
    shim.kh_host(_p(bases), _p(lens), B, L, k, _p(words), opt.bf_shift,
                 opt.n_hashes, _p(got))
    want = TT.max_streak_plain(words, bases, lens, k, opt.bf_shift,
                               opt.n_hashes)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    probe = TT.WordsProbe(TT.DeviceBloom(words, opt.bf_shift, opt.n_hashes))
    seqs = ["".join("ACGTN"[c] for c in bases[r, :lens[r]].tolist())
            for r in range(B)]
    assert got.tolist() == [TM.max_streak(k, probe, q) for q in seqs]
    # the edge rows are what they claim
    m = got.tolist()
    assert m[3] == lens[3] and m[4] == L and m[9] == 0
    assert m[5] == ((L - k + 1) << 32 | (k - 1) if L >= k else L)
    if 2 * k + 9 <= L:
        assert m[6] == 5 << 32 | (2 * k + 4)  # the later of equal runs
    for row, slot in enumerate(N_SLOTS):
        if k <= slot < L - k:  # a run on each side of the N
            assert m[row] >> 32 == max(slot - k + 1, L - slot - k)
    assert sum(v >> 32 > 0 for v in m[10:]) > 5 or L < k


def _kh_scan(hits, n):
    """The reference's t scan (correct.c:478-497) over given hits: t gains
    1 << 32 at a hit and restarts at i + 1 elsewhere; the largest t over
    i < n."""
    t = best = 0
    for i in range(n):
        t = t + (1 << 32) if hits[i] else i + 1
        best = max(best, t)
    return best


@pytest.mark.parametrize("L", CHUNK_LS)
def test_kh_steps_match_the_scan(shim, L):
    """KH's steps alone, lane by lane, over seeded hit words (dense,
    sparse, all set; bits set past the read's length too) against the
    reference's scan, at lengths around the chunk edges and random ones."""
    rng = np.random.default_rng(500 + L)
    n_chunks = -(-L // 32)
    lens = sorted({0, 1, 31, 32, 33, 63, 64, L - 1, L} & set(range(L + 1)))
    lens += rng.integers(0, L + 1, 40).tolist()
    for n in lens:
        for p in (0.0, 0.3, 0.9, 1.0):
            hits = rng.random(n_chunks * 32) < p
            words = np.packbits(hits.reshape(-1, 32)[:, ::-1], axis=1)
            words = words.view(">u4").reshape(-1).astype(np.uint32)
            got = shim.kh_steps_host(words.ctypes.data, n_chunks, int(n))
            assert got == _kh_scan(hits, n), (n, p)


def test_ki_body_matches_plain(shim, trim_agg):
    """KI's steps with arrivals from 0 and from 2^33, the scatter in the
    natural order and reversed, at each superblock shift of _shifts,
    against the plain version."""
    opt, run, ret, _, _, _ = trim_agg
    sbs = _shifts(len(ret), opt.bf_shift)
    for shift in (0, 1 << 33):
        arr = run.arr + shift
        want = tspec.adjudicate_first_occurrence_plain(ret, arr, opt.bf_shift,
                                                       opt.n_hashes)
        for sb in sbs:
            for reverse in (False, True):
                fp = _ki_host(shim, ret, arr, opt.bf_shift, opt.n_hashes,
                              reverse, sb)
                torch.testing.assert_close(fp, want, rtol=0, atol=0)
        assert int((want & (run.n == 1)).sum()) > 0
    assert int(_rows_a_block(ret, opt.bf_shift).max()) > 8  # chunked blocks
    # the wrapper's shift stages superblocks; the largest overflows them
    assert 0 < sbs[0] < sbs[2]
    x = opt.bf_shift - tspec.BLK_SHIFT
    per_super = torch.bincount((ret & ((1 << x) - 1)) >> sbs[2])
    assert int(per_super.max()) > VD_CAP


def _tied_rows(seed=5, C=3000, bf_shift=14):
    """Rows in 32 blocks at -b14 with arrivals drawn from 400 values, so
    that many rows of one block share an arrival."""
    rng = np.random.default_rng(seed)
    ret = rng.integers(0, 1 << 62, C, dtype=np.int64)
    arr = rng.integers(0, 400, C).astype(np.int64)
    return torch.from_numpy(ret), torch.from_numpy(arr), bf_shift


def _crowded_rows(seed=7, C=3000, bf_shift=20):
    """Rows whose blocks all lie in the first 16 of 2,048 (-b20), ~190
    rows a block: one superblock of 2^8 blocks holds more than VD_CAP
    rows."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 1 << 51, C, dtype=np.int64) << 11
    ret = hi | rng.integers(0, 16, C, dtype=np.int64)
    arr = rng.permutation(C).astype(np.int64)
    return torch.from_numpy(ret), torch.from_numpy(arr), bf_shift


def _tiny_blocks(seed=8, bf_shift=24, n_blocks=4000):
    """Blocks of 1 to 12 rows at -b24 (most judged by vd_pair_fp, the rest
    on tables) whose probe walks overlap: a block's rows start k = 0..3
    strides along one walk (a few with a stride of their own), arrivals
    from 12 values, so that many rows are hits and many miss one bit."""
    rng = np.random.default_rng(seed)
    x = bf_shift - tspec.BLK_SHIFT
    rows = []
    for blk in rng.choice(1 << x, n_blocks, replace=False):
        m = int(rng.integers(1, 13))
        z0, h2 = rng.integers(0, 512), rng.integers(1, 512)
        k = rng.integers(0, 4, m)
        h = np.where(rng.random(m) < 0.15, rng.integers(1, 512, m), h2)
        z = (z0 + k * h2) % 512
        hi = rng.integers(0, 1 << 20, m)
        rows.append(blk | z << x | h << bf_shift | hi << (bf_shift + 9))
    ret = np.concatenate(rows).astype(np.int64)
    arr = rng.integers(0, 12, len(ret)).astype(np.int64)
    return torch.from_numpy(ret), torch.from_numpy(arr), bf_shift


VD_CAP = 2048  # csrc/verdict.cuh: a superblock's rows staged in shared memory
VD_PAIR = 8    # csrc/verdict.cuh: larger blocks are judged on tables
VERDICT_CASES = ["hot-block", "ties", "empty", "one-row", "crowded",
                 "tiny-blocks"]


@pytest.mark.parametrize("arrivals", ["u32", "u64"])
@pytest.mark.parametrize("case", VERDICT_CASES)
def test_verdict_body_cases(shim, trim_agg, case, arrivals):
    """KF's (u32) and KI's (u64) verdict steps against their plain
    versions, scatter forward and reversed: the trim aggregate at -b12,
    where a block holds over 1,000 rows (each block read whole by a CTA);
    rows of equal arrival in one block; C = 0; C = 1; a superblock of
    more rows than shared memory stages (read block by block).  KF takes
    arrivals from 0 and from 2^31 + 2^30 (u32 patterns past the int32
    sign), KI from 0 and from 2^33."""
    opt, run, ret, _, n, _ = trim_agg
    H = opt.n_hashes
    if case == "hot-block":
        arr, b = run.arr, 12
        assert int(_rows_a_block(ret, b).max()) >= 1000
    elif case == "ties":
        ret, arr, b = _tied_rows()
        n = torch.from_numpy(np.random.default_rng(6).integers(
            -1, 4, len(ret)).astype(np.int32))
        assert int(_rows_a_block(ret, b).max()) > 8
    elif case == "crowded":
        ret, arr, b = _crowded_rows()
        n = torch.ones((len(ret),), dtype=torch.int32)
        assert tspec.verdict_shift(len(ret), b) == 8 and len(ret) > VD_CAP
    elif case == "tiny-blocks":
        ret, arr, b = _tiny_blocks()
        n = torch.from_numpy(np.random.default_rng(9).integers(
            0, 3, len(ret)).astype(np.int32))
        per = _rows_a_block(ret, b)
        assert int((per[per > 0] <= VD_PAIR).sum()) > int(
            (per > VD_PAIR).sum()) > 0
    else:
        C = 0 if case == "empty" else 1
        ret, arr, n, b = ret[:C], run.arr[:C], n[:C], opt.bf_shift
    hashes = (1, H, tspec.MAX_HASHES) if case == "tiny-blocks" else (H,)
    for H, shift, reverse in itertools.product(
            hashes, (0, 3 << 30) if arrivals == "u32" else (0, 1 << 33),
            (False, True)):
        a = arr + shift
        if arrivals == "u32":
            got = _kf_host(shim, ret, tsdn.as_i32(a), n, b, H, reverse)
            want = tspec.adjudicate_sketch_plain(ret, tsdn.as_i32(a), n, b, H)
        else:
            got = (_ki_host(shim, ret, a, b, H, reverse),)
            want = (tspec.adjudicate_first_occurrence_plain(ret, a, b, H),)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        if case in ("ties", "crowded", "tiny-blocks"):
            assert 0 < int(want[0].sum()) < len(ret)


@pytest.mark.parametrize("k", [21, 32, 33])
def test_kj_body_matches_plain(shim, k):
    o = Opts()
    o.k = k
    l_pre = o.effective_l_pre()
    kb_bits = tk.keybody_bits(k, l_pre)
    rng = np.random.default_rng(k)
    shard = torch.from_numpy(rng.integers(0, 1 << l_pre, 5000))
    keybody = torch.from_numpy(
        rng.integers(0, 1 << kb_bits, 5000, dtype=np.uint64).view(np.int64))
    got = torch.empty((5000,), dtype=torch.int64)
    shim.kj_host(5000, _p(shard), _p(keybody), k, l_pre, _p(got))
    torch.testing.assert_close(
        got, tsdn.derive_ret_plain(shard, keybody, k, l_pre), rtol=0, atol=0)


def test_kk_body_matches_plain(shim, trim_agg):
    """On the aggregate's rows with counts raised past both payload caps,
    as one block and as five (a warp's tiles in turn, the rows after the
    last tile spread over the threads, five flushes)."""
    opt, run, ret, _, _, _ = trim_agg
    n, n_high = run.n * 100, run.n_high * 100
    fp = tspec.adjudicate_first_occurrence_plain(ret, run.arr, opt.bf_shift,
                                                 opt.n_hashes)
    C = len(ret)
    want = tspec.finalize_counts_plain(n, n_high, run.first_high, fp)
    for blocks in (1, 5):
        got = _kk_host(shim, n, n_high, run.first_high, fp, blocks)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert int(want[2][255]) > 0 and int(want[3][63]) > 0
    assert _kk_plan(shim, n, n_high, run.first_high, fp, *got[:2])[1] == (
        C // KK_TILE)


KK_TILE = 512   # csrc/finalize.cuh: rows of a warp's tile


def _kk_host(shim, n, n_high, first_high, fp, blocks, payload=None,
             keep=None):
    """KK's kernel as the shim runs it on `blocks` blocks: (payload, keep,
    hist, hist_high); payload and keep given as views to write into."""
    C = n.shape[0]
    if payload is None:
        payload = torch.empty((C,), dtype=torch.int32)
        keep = torch.empty((C,), dtype=torch.bool)
    hist = torch.zeros((256,), dtype=torch.int64)
    hist_high = torch.zeros((64,), dtype=torch.int64)
    shim.kk_host(C, _p(n), _p(n_high), _p(first_high), _p(fp), _p(payload),
                 _p(keep), _p(hist), _p(hist_high), blocks)
    return payload, keep, hist, hist_high


def _kk_plan(shim, n, n_high, first_high, fp, payload, keep):
    out = (ctypes.c_longlong * 2)()
    shim.kk_plan_host(n.shape[0], _p(n), _p(n_high), _p(first_high), _p(fp),
                      _p(payload), _p(keep), out)
    return tuple(out)


def _kk_cols(rng, C, pad):
    """Seeded KK inputs of C + pad rows, as bfc_tpu's fold holds them: n
    >= 1 (a single occurrence for 40% of the rows, so that a fifth are
    dropped; up to past the count cap), first_high <= n_high <= n (past
    the high cap), fp from a coin."""
    n = np.where(rng.random(C + pad) < 0.4, 1,
                 1 + rng.integers(0, 400, C + pad))
    first_high = rng.integers(0, 2, C + pad)
    n_high = np.minimum(n, first_high + rng.integers(0, 100, C + pad))
    fp = rng.random(C + pad) < 0.5
    return (torch.from_numpy(n).clone(), torch.from_numpy(n_high).clone(),
            torch.from_numpy(first_high.astype(np.uint8)).clone(),
            torch.from_numpy(fp).clone())


@pytest.mark.parametrize("offsets", [(0, 0), (3, 3), (5, 0)])
@pytest.mark.parametrize("C", [0, 1, 15, 16, 17, 511, 512, 513, 1041,
                               9 * KK_TILE + 300])
def test_kk_tiles_match_plain(shim, C, offsets):
    """KK's many-row body: tiles of 512 rows from the first row where every
    column lies on a 16-byte boundary, the unaligned head and the tail one
    a thread, per-warp sub-histograms merged a block at a time, on one
    block and on three, at C around a lane's 16 rows and a tile's 512.
    Offsets (inputs, outputs) in rows: (0, 0) aligned, tiles from row 0;
    (3, 3) a head of 13 rows; (5, 0) columns that never align together,
    every row one a thread."""
    rng = np.random.default_rng(1000 + C)
    i_off, o_off = offsets
    cols = tuple(x[i_off:i_off + C] for x in _kk_cols(rng, C, 16))
    payload = torch.empty((C + 16,), dtype=torch.int32)[o_off:o_off + C]
    keep = torch.empty((C + 16,), dtype=torch.bool)[o_off:o_off + C]
    head, tiles = _kk_plan(shim, *cols, payload, keep)
    h = -cols[3].data_ptr() % 16
    aligned = all((t.data_ptr() + h * t.element_size()) % 16 == 0
                  for t in (*cols, payload, keep))
    want_tiles = (C - h) // KK_TILE if aligned and h < C else 0
    assert (head, tiles) == ((h, want_tiles) if want_tiles else (C, 0))
    if offsets == (0, 0):
        assert tiles == C // KK_TILE
    want = tspec.finalize_counts_plain(*cols)
    for blocks in (1, 3):
        got = _kk_host(shim, *cols, blocks, payload, keep)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


CK_WIN_BITS = 12  # csrc/cuckoo.cuh: the card's window of slots
CK_MAX_STEPS = 1000  # KL_MAX_STEPS, KN_MAX_STEPS
CK_GAP = 64       # the most window starts one row of the count writes


def _ck_build(shim, shard, keybody, payload, l_pre, kb_bits, c_bits,
              cb_local=0, wmax=CK_WIN_BITS):
    """KL's (cb_local 0) or KN's window build, phase by phase by g++, into
    a table and scratch of garbage (every slot must be written, and the
    counters are cleared first): (table, ok, the windows' overflow
    counts, the out-of-order flag)."""
    n = shard.shape[0]
    tb = cb_local or c_bits
    nw = 1 << (tb - min(wmax, tb))
    rec = torch.full((n, 2), -7, dtype=torch.int64)
    meta = torch.full((tspec.CK_HDR + 3 * nw + 1,), -5, dtype=torch.int64)
    table = torch.full((1 << tb,), -1, dtype=torch.int64)
    shim.ck_host(n, _p(shard), _p(keybody), _p(payload), l_pre, kb_bits,
                 c_bits, cb_local, _p(meta), _p(rec), _p(table),
                 CK_MAX_STEPS, wmax)
    assert not bool((table == -1).any()), "a slot was not written"
    return (table, int(meta[0]) == 0, meta[tspec.CK_HDR + 2 * nw + 1:],
            (int(meta[1]), int(meta[2])))


def _ck_layout(k):
    o = Opts()
    o.k = k
    l_pre = o.effective_l_pre()
    return l_pre, tk.keybody_bits(k, l_pre)


def _ck_keys(k, n, seed):
    """n distinct seeded keys at k, sorted by (shard, keybody) as every
    caller passes them, with non-zero payloads."""
    l_pre, kb_bits = _ck_layout(k)
    rng = np.random.default_rng(seed)
    shard = rng.integers(0, 1 << l_pre, n)
    keybody = rng.integers(0, 1 << min(kb_bits, 63), n,
                           dtype=np.uint64)
    order = np.lexsort((keybody, shard))
    shard, keybody = shard[order], keybody[order]
    fresh = np.ones(n, bool)
    fresh[1:] = (shard[1:] != shard[:-1]) | (keybody[1:] != keybody[:-1])
    shard, keybody = shard[fresh], keybody[fresh]
    payload = rng.integers(1, 1 << 14, len(shard)).astype(np.int32)
    return (torch.from_numpy(shard), torch.from_numpy(keybody.view(
        np.int64)), torch.from_numpy(payload))


# case: (k, keys, kept share, c_bits or None for table_c_bits, window bits
# of the phases, the only windows of 2^12 slots whose keys are kept);
# c_bits 11-13 put the table's edge at the card's window minus one, at it
# and past it; "gap" leaves 196 windows empty between two
CK_CASES = {
    **{f"k{k}": (k, 3000, 0.7, None, CK_WIN_BITS, None)
       for k in (17, 21, 33, 51, 63)},
    "load0.4": (21, 4000, 0.8192, 13, CK_WIN_BITS, None),
    **{f"edge{cb}": (21, int(0.3 * (1 << cb)) + 40, 0.97, cb, CK_WIN_BITS,
                     None) for cb in (11, 12, 13)},
    "one-window": (21, 20000, 1.0, 14, CK_WIN_BITS, (1,)),
    "gap": (21, 20000, 1.0, 20, CK_WIN_BITS, (3, 200)),
    "min-table": (21, 120, 0.7, 8, CK_WIN_BITS, None),
    "small-windows": (21, 3000, 0.95, 13, 4, None),
    "empty": (21, 0, 1.0, 8, CK_WIN_BITS, None),
}


@functools.lru_cache(maxsize=None)
def _ck_case(case):
    """(keys, kept mask, c_bits, window bits, each key's expected lookup,
    the plain build's lookups of every key)."""
    k, n, share, c_bits, wmax, window = CK_CASES[case]
    l_pre, kb_bits = _ck_layout(k)
    shard, keybody, payload = _ck_keys(k, n, seed=n + k)
    if window is not None:  # only the keys whose first slot is in them
        sel = torch.isin(_first_slots(shard, keybody, l_pre, kb_bits, c_bits)
                         >> CK_WIN_BITS, torch.tensor(window))
        shard, keybody, payload = shard[sel], keybody[sel], payload[sel]
        shard, keybody, payload = (x[:1200] for x in (shard, keybody,
                                                       payload))
    keep = torch.from_numpy(np.random.default_rng(n).random(
        shard.shape[0]) < share)
    if c_bits is None:
        c_bits = TC.table_c_bits(int(keep.sum()), k, l_pre)
    want = torch.where(keep, payload, -1).to(torch.int64)
    plain, ok = tspec.cuckoo_build_plain(shard[keep], keybody[keep],
                                         payload[keep], k, l_pre, kb_bits,
                                         c_bits)
    assert ok
    got = tspec.cuckoo_lookup_plain(
        tspec.SpecTable(plain, k, l_pre, kb_bits, c_bits), shard, keybody)
    return (shard, keybody, payload), keep, c_bits, wmax, want, got


def _first_slots(shard, keybody, l_pre, kb_bits, c_bits):
    """Each key's first slot in a table of 2^c_bits."""
    return tspec.srl(tspec._posk64(shard, keybody, l_pre, kb_bits),
                     64 - c_bits)


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("case", sorted(CK_CASES))
def test_kl_phased_build_matches_plain_lookups(shim, case, order):
    """KL's window build by g++ (count, scatter, window by window with
    the overflow recorded, then the overflow inserts) from the kept keys,
    sorted or shuffled, writes every slot, and its lookups of every key
    equal the plain build's: a kept key its payload, every other -1 (the
    layouts differ).  Sorted keys never raise the flag; shuffled ones
    always do and are grouped by window."""
    (shard, keybody, payload), keep, c_bits, wmax, want, plain = \
        _ck_case(case)
    k = CK_CASES[case][0]
    l_pre, kb_bits = _ck_layout(k)
    torch.testing.assert_close(plain, want, rtol=0, atol=0)
    idx = torch.nonzero(keep).flatten()
    if order == "shuffled":
        idx = idx[torch.from_numpy(np.random.default_rng(3).permutation(
            idx.shape[0]))]
    table, ok, novf, (flag, gaps) = _ck_build(
        shim, shard[idx], keybody[idx], payload[idx], l_pre, kb_bits, c_bits,
        wmax=wmax)
    assert ok
    s1 = _first_slots(shard[idx], keybody[idx], l_pre, kb_bits, c_bits)
    win = s1 >> min(wmax, c_bits)
    assert flag == int(bool((win[1:] < win[:-1]).any()))
    assert flag == (order == "shuffled" and int(win.unique().numel()) > 1)
    # the starts come from the count unless a row would write more than
    # CK_GAP of them: then from the scan, as where the flag is up
    if win.numel():
        nw = 1 << (c_bits - min(wmax, c_bits))
        step = torch.cat([win[:1] + 1, (win[1:] - win[:-1]).clamp(min=0),
                          nw - win[-1:]])
        assert gaps == int(bool((step > CK_GAP).any()))
    if order == "sorted":  # only the gap case's starts need the scan
        assert gaps == (case == "gap")
    got = tspec.cuckoo_lookup_plain(
        tspec.SpecTable(table, k, l_pre, kb_bits, c_bits), shard, keybody)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # a key overflows where an earlier one took its first slot
    assert int(novf.sum()) == idx.shape[0] - int(s1.unique().numel())
    if case == "empty":
        assert not bool(table.any())


def test_kl_phased_build_reports_a_full_table(shim):
    """600 keys cannot sit in 512 slots: ok is False, as the plain
    build's."""
    shard, keybody, payload = _ck_keys(21, 600, seed=6)
    l_pre, kb_bits = _ck_layout(21)
    _, ok = tspec.cuckoo_build_plain(shard, keybody, payload, 21, l_pre,
                                     kb_bits, 9)
    assert not ok
    _, ok, novf, _ = _ck_build(shim, shard, keybody, payload, l_pre,
                               kb_bits, 9)
    assert not ok and int(novf.sum()) >= 600 - 512


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("db", [1, 2, 3])
def test_kn_phased_build_matches_plain_lookups(shim, db, order):
    """KN's window build by g++ into each rank's sub-table (the sub-table
    slot rule and alternate hash) from its kept keys, sorted or shuffled:
    the 2^db sub-tables answer every key as the plain sub-tables do."""
    (shard, keybody, payload), keep, _, _, want, _ = _ck_case("k21")
    k = 21
    l_pre, kb_bits = _ck_layout(k)
    owner = tspec.subtable_owner(shard, keybody, l_pre, kb_bits, db)
    counts = torch.bincount(owner[keep], minlength=1 << db)
    cb_local = TC.subtable_bits(int(counts.max()), k, l_pre, db)
    rng = np.random.default_rng(db)
    subs, plains = [], []
    for r in range(1 << db):
        idx = torch.nonzero(keep & (owner == r)).flatten()
        if order == "shuffled":
            idx = idx[torch.from_numpy(rng.permutation(idx.shape[0]))]
        cols = (shard[idx], keybody[idx], payload[idx])
        t, ok, _, _ = _ck_build(shim, *cols, l_pre, kb_bits, db + cb_local,
                                cb_local)
        assert ok
        subs.append(t)
        t, ok = tspec.cuckoo_build_local_plain(*cols, l_pre, kb_bits,
                                               db + cb_local, db)
        assert ok
        plains.append(t)
    for tabs in (subs, plains):
        got = tspec.cuckoo_lookup_plain(
            tspec.sharded_table(tabs, k, l_pre, kb_bits, db), shard, keybody)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["sorted", "shuffled", "empty"])
@pytest.mark.parametrize("kern", ["KL", "KN"])
def test_ck_wrapper_enqueues_one_build(shim, monkeypatch, kern, case):
    """The card path of cuckoo_build and cuckoo_build_local with the shim
    doing its launch: one entry point (five kernels, the build alone for
    no keys) into a table and scratch of garbage, then one read of the
    failure count; lookups as the plain version's."""
    (shard, keybody, payload), keep, c_bits, _, want, _ = _ck_case("k21")
    l_pre, kb_bits = _ck_layout(21)
    idx = torch.nonzero(keep).flatten()
    if case == "shuffled":
        idx = idx.flip(0)
    if case == "empty":
        idx = idx[:0]
        want = torch.full_like(want, -1)
    calls = []
    table = torch.full((1 << c_bits,), -1, dtype=torch.int64)
    geom = (l_pre, kb_bits, c_bits) if kern == "KL" else (
        l_pre, kb_bits, c_bits, c_bits)

    def launch(fn, *args, kernels=1):
        calls.append((fn, kernels))
        if kern == "KL":  # the shim takes cb_local, 0 for KL
            args = args[:7] + (0,) + args[7:]
        shim.ck_host(*args, CK_MAX_STEPS, CK_WIN_BITS)

    scratch = tspec.cuckoo_scratch
    monkeypatch.setattr(getattr(kernels, kern), "launch", launch)
    monkeypatch.setattr(tspec, "cuckoo_scratch", lambda *a: tuple(
        t.fill_(-3) for t in scratch(*a)))
    got_t, ok = tspec._window_build(getattr(kernels, kern), geom,
                                    shard[idx], keybody[idx], payload[idx],
                                    c_bits, out=table)
    assert ok and got_t is table
    assert calls == [(f"{kern.lower()}_launch", 1 if case == "empty" else 5)]
    st = (tspec.SpecTable(table, 21, l_pre, kb_bits, c_bits) if kern == "KL"
          else tspec.sharded_table([table], 21, l_pre, kb_bits, 0))
    torch.testing.assert_close(tspec.cuckoo_lookup_plain(st, shard, keybody),
                               want, rtol=0, atol=0)


def test_ck_constants_match_the_header():
    """The wrapper's window and header sizes are cuckoo.cuh's."""
    src = (CSRC / "cuckoo.cuh").read_text()
    for name, value in (("CK_WIN_BITS", tspec.WIN_BITS),
                        ("CK_HDR", tspec.CK_HDR), ("CK_GAP", CK_GAP)):
        assert re.search(rf"#define {name} {value}\b", src), name
    assert tspec.WIN_BITS == CK_WIN_BITS


def _subtables(shim, ds, db):
    """The spectrum's entries split by owner into 2^db sub-tables, each
    built by KN's window build (host bodies), half of them from their
    keys in reverse: a ShardedTable, and the cb_local."""
    k, l_pre, kb_bits = ds.k, ds.l_pre, ds.kb_bits
    shard, keybody, payload = (torch.from_numpy(np.asarray(c).astype(
        np.int64)) for c in ds.compact_entries())
    payload = payload.to(torch.int32)
    owner = tspec.subtable_owner(shard, keybody, l_pre, kb_bits, db)
    counts = torch.bincount(owner, minlength=1 << db)
    cb_local = TC.subtable_bits(int(counts.max()), k, l_pre, db)
    subs = []
    for r in range(1 << db):
        idx = torch.nonzero(owner == r).flatten()
        if r % 2:
            idx = idx.flip(0)
        t, ok, _, _ = _ck_build(shim, shard[idx], keybody[idx],
                                payload[idx], l_pre, kb_bits, db + cb_local,
                                cb_local)
        assert ok
        subs.append(t)
    return tspec.sharded_table(subs, k, l_pre, kb_bits, db), cb_local


@pytest.mark.parametrize("db", [0, 1, 3])
def test_subtable_rules_match_plain(shim, db):
    """Owner, s1, s2 and qlow by g++ against the plain version at k 21 and
    63 and cb_local 8 and 30; s2 is not cuckoo_alt's slot."""
    rng = np.random.default_rng(db)
    for k in (21, 63):
        o = Opts()
        o.k = k
        l_pre = o.effective_l_pre()
        kb_bits = tk.keybody_bits(k, l_pre)
        shard = torch.from_numpy(rng.integers(0, 1 << l_pre, 3000))
        keybody = torch.from_numpy(rng.integers(
            0, 1 << min(kb_bits, 63), 3000, dtype=np.uint64).view(np.int64))
        for cb_local in (8, 30):
            c_bits = db + cb_local
            if l_pre + kb_bits - c_bits > 49:
                c_bits = l_pre + kb_bits - 49
            got = [torch.empty((3000,), dtype=torch.int64) for _ in range(4)]
            shim.subtable_slots_host(3000, _p(shard), _p(keybody), l_pre,
                                     kb_bits, c_bits, db, *map(_p, got))
            want = tspec.subtable_slots(shard, keybody, l_pre, kb_bits,
                                        c_bits, db)
            for name, g, w in zip(("owner", "s1", "s2", "qlow"), got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
            replicated = want[1] ^ tspec.cuckoo_alt(want[3], c_bits - db)
            assert bool((replicated != want[2]).any())


@pytest.mark.parametrize("db", [1, 2, 3])
def test_kn_kc_kd_bodies_over_subtables(shim, spectrum, db):
    """KN's window build per owner gives sub-tables that answer as the plain
    sharded build's and the replicated table for every key of the batch;
    the KC and KD bodies reading them through the address array equal
    their plain versions and the replicated table's results."""
    opt, ds, bases, qf, lens = spectrum
    sharded, cb_local = _subtables(shim, ds, db)
    shard, keybody, payload = (torch.from_numpy(np.asarray(c).astype(
        np.int64)) for c in ds.compact_entries())
    owner = tspec.subtable_owner(shard, keybody, ds.l_pre, ds.kb_bits, db)
    plains = []
    for r in range(1 << db):
        sel = owner == r
        t, ok = tspec.cuckoo_build_local_plain(
            shard[sel], keybody[sel], payload[sel].to(torch.int32),
            ds.l_pre, ds.kb_bits, db + cb_local, db)
        assert ok
        plains.append(t)
    plain = tspec.sharded_table(plains, ds.k, ds.l_pre, ds.kb_bits, db)
    rng = np.random.default_rng(db)
    qs = torch.cat([shard, torch.from_numpy(rng.integers(
        0, 1 << ds.l_pre, 2000))])
    qk = torch.cat([keybody, torch.from_numpy(rng.integers(
        0, 1 << min(ds.kb_bits, 62), 2000))])
    want = tspec.cuckoo_lookup_plain(ds.table, qs, qk)
    for t in (sharded, plain):
        torch.testing.assert_close(tspec.cuckoo_lookup_plain(t, qs, qk),
                                   want, rtol=0, atol=0)
    kc = _kc_host(shim, sharded, bases, lens, opt.min_cov)
    for w, g in zip(tann.kcov_island_plain(ds.table, bases, lens,
                                           opt.min_cov), kc):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    torch.testing.assert_close(
        kc[0], tann.kcov_island_plain(plain, bases, lens, opt.min_cov)[0],
        rtol=0, atol=0)
    _, lcov, hcov, isl = kc
    caps = (tsrch.HEAP_CAP, tsrch.STACK_CAP)
    got = _kd_host(shim, sharded, opt, ds.mode, bases, qf, lens, lcov, hcov,
                   isl, *caps)
    deferred = _kd_host(shim, sharded, opt, ds.mode, bases, qf, lens, lcov,
                        hcov, isl, *caps, stack1=40)
    assert _kd_host.deferred > 20
    for want in (tsrch.ec1_search_plain(ds.table, opt, ds.mode, bases, qf,
                                        lens, lcov, hcov, isl, *caps),
                 tsrch.ec1_search_plain(plain, opt, ds.mode, bases, qf,
                                        lens, lcov, hcov, isl, *caps)):
        for g, w in zip(got + deferred, want + want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert int((got[1][:, tsrch.N_EC] > 0).sum()) > 10


def _km_rows(R: int, rule: int, seed: int = 9):
    """Rows over several KM tiles: shards of l_pre 20 (10% invalid), u64
    rets, and every row bound for rank 1 made invalid, so that rank 1
    receives nothing (for R = 3 the prefix rule leaves rank 2 empty too)."""
    rng = np.random.default_rng(seed + R)
    N = 3 * troute.TILE + 123
    shard = rng.integers(0, 1 << 20, N).astype(np.int64)
    ret = rng.integers(-(1 << 63), (1 << 63) - 1, N, dtype=np.int64)
    shard[rng.random(N) < 0.1] = 0xFFFFFFFF
    param = 20 if rule == troute.PREFIX else 22
    dest = _km_dest_np(shard, ret, rule, param, R)
    shard[dest == 1] = 0xFFFFFFFF
    cols = [torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, N))
            for _ in range(3)] + [None]
    return torch.from_numpy(shard), torch.from_numpy(ret), param, cols


def _km_dest_np(shard, ret, rule, param, R):
    """bfc_tpu's destinations in numpy: mesh.py:_dev_of_shard (int32,
    floor-mod) and the Bloom block's owner (mesh.py:217)."""
    if rule == troute.PREFIX:
        shift = max(param - int(np.log2(R)), 0)
        dest = (shard.astype(np.uint32) >> np.uint32(shift)).astype(
            np.int32) % R
    else:
        block = ret.view(np.uint64) & np.uint64((1 << (param - 9)) - 1)
        dest = (block % np.uint64(R)).astype(np.int64)
    return np.where(shard == 0xFFFFFFFF, R, dest).astype(np.int64)


@pytest.mark.parametrize("rule", [0, 1], ids=["prefix", "bloom"])
@pytest.mark.parametrize("R", [2, 3, 4, 8])
def test_km_plain_is_a_stable_partition(R, rule):
    """KM's plain version against a numpy stable partition by bfc_tpu's
    destination rules; invalid rows dropped, empty destinations kept."""
    shard, ret, param, cols = _km_rows(R, rule)
    got = troute.route_rows_plain(cols, R, rule, param, shard=shard, ret=ret)
    dest = _km_dest_np(shard.numpy(), ret.numpy(), rule, param, R)
    want_counts = np.bincount(dest, minlength=R + 1)[:R]
    assert got.counts == want_counts.tolist()
    assert got.counts[1] == 0 and min(got.counts[:1] + got.counts[2:]) >= 0
    order = np.argsort(dest, kind="stable")[:int(want_counts.sum())]
    np.testing.assert_array_equal(got.perm.numpy(), order)
    for g, c in zip(got.cols, cols):
        if c is not None:
            np.testing.assert_array_equal(g.numpy(), c.numpy()[order])
    assert got.cols[3] is None


def _km_host(shim, cols, R, rule, param, shard, ret):
    """KM's count, scan and scatter passes as the launches run them, into
    outputs of N rows: (off, totals, output columns, perm)."""
    N = (shard if rule == troute.PREFIX else ret).shape[0]
    n_tiles = (N + troute.TILE - 1) // troute.TILE
    off = torch.empty((R * n_tiles,), dtype=torch.int64)
    totals = torch.empty((R,), dtype=torch.int64)
    shim.km_count_host(N, rule, _p(shard), _p(ret), param, R, n_tiles,
                       _p(off), _p(totals))
    outs = [None if c is None else torch.empty((N,), dtype=torch.int64)
            for c in cols]
    perm = torch.empty((N,), dtype=torch.int64)
    pad = [None] * (troute.MAX_COLS - len(cols))
    shim.km_scatter_host(N, rule, _p(shard), _p(ret), param, R, n_tiles,
                         _p(off), *(_p(c) for c in cols), *pad,
                         *(_p(o) for o in outs), *pad, _p(perm))
    return off, totals, outs, perm


def _check_km(shim, cols, R, rule, param, shard, ret):
    """_km_host against route_rows_plain: the totals are the counts, off
    the exclusive scan of the tiles' counts (destination-major: each
    (destination, tile)'s first output slot), and the leading sum(counts)
    rows of each output the plain version's."""
    want = troute.route_rows_plain(cols, R, rule, param, shard=shard, ret=ret)
    off, totals, outs, perm = _km_host(shim, cols, R, rule, param, shard, ret)
    assert totals.tolist() == want.counts
    N = perm.shape[0]
    dest = troute.destinations(rule, param, R, shard, ret)
    n_tiles = (N + troute.TILE - 1) // troute.TILE
    tile = torch.arange(N) // troute.TILE
    kept = dest < R
    cnt = torch.zeros((R, n_tiles), dtype=torch.int64)
    cnt.view(-1).index_add_(0, (dest * n_tiles + tile)[kept],
                            torch.ones((int(kept.sum()),), dtype=torch.int64))
    flat = cnt.view(-1)
    torch.testing.assert_close(off, torch.cumsum(flat, 0) - flat, rtol=0,
                               atol=0)
    n = sum(want.counts)
    torch.testing.assert_close(perm[:n], want.perm, rtol=0, atol=0)
    for g, w in zip(outs, want.cols):
        assert (g is None) == (w is None)
        if w is not None:
            torch.testing.assert_close(g[:n], w, rtol=0, atol=0)
    return want


@pytest.mark.parametrize("rule", [0, 1], ids=["prefix", "bloom"])
@pytest.mark.parametrize("R", [1, 2, 3, 4, 8, 256])
def test_km_body_matches_plain(shim, R, rule):
    """KM's count pass (tile counts, totals), scan pass (a destination a
    block, thread parts) and scatter pass (warp ranks, per-warp counts,
    the (warp, destination) scan, the staged tile and its slots), against
    its plain version."""
    shard, ret, param, cols = _km_rows(R, rule)
    want = _check_km(shim, cols, R, rule, param, shard,
                     ret if rule == troute.BLOOM else None)
    assert want.counts[1 % R] == 0 or R == 1


def _km_edge(case: str, seed: int = 31):
    """Rows for an edge case: none, one, 2 tiles + 5 rows (not a multiple
    of the tile, the last one 5 rows), and 3 tiles whose middle one is all
    invalid shards."""
    N = {"empty": 0, "one": 1, "ragged": 2 * troute.TILE + 5,
         "dropped-tile": 3 * troute.TILE}[case]
    rng = np.random.default_rng(seed)
    shard = rng.integers(0, 1 << 20, N).astype(np.int64)
    shard[rng.random(N) < 0.1] = 0xFFFFFFFF
    if case == "dropped-tile":
        shard[troute.TILE:2 * troute.TILE] = 0xFFFFFFFF
    ret = rng.integers(-(1 << 63), (1 << 63) - 1, N, dtype=np.int64)
    cols = [torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, N))
            for _ in range(2)]
    return torch.from_numpy(shard), torch.from_numpy(ret), cols


@pytest.mark.parametrize("rule", [0, 1], ids=["prefix", "bloom"])
@pytest.mark.parametrize("R", [1, 3, 256])
@pytest.mark.parametrize("case", ["empty", "one", "ragged", "dropped-tile"])
def test_km_body_edges_match_plain(shim, case, R, rule):
    """KM's passes at the edges of its tiles against its plain version;
    under the Bloom rule shard drops the invalid rows too."""
    shard, ret, cols = _km_edge(case)
    param = 20 if rule == troute.PREFIX else 22
    want = _check_km(shim, cols + [None], R, rule, param, shard,
                     ret if rule == troute.BLOOM else None)
    if case == "dropped-tile":
        assert not bool(((want.perm >= troute.TILE)
                         & (want.perm < 2 * troute.TILE)).any())
    assert sum(want.counts) <= shard.shape[0]


@pytest.mark.parametrize("rule", [0, 1], ids=["prefix", "bloom"])
@pytest.mark.parametrize("case", ["empty", "one", "ragged"])
def test_km_wrapper_waits_once_behind_the_count(shim, monkeypatch, case,
                                                rule):
    """route_rows' card path with its launches run by the shim: it
    enqueues the count and the scan (whose totals reach the pinned
    counts), records its event, enqueues the scatter and only then waits,
    once; its buffers, counts and perm equal the plain version's."""
    calls = []

    class Event:
        def record(self):
            calls.append("record")

        def synchronize(self):
            calls.append("wait")

    pinned = torch.full((troute.MAX_RANKS,), -1, dtype=torch.int64)

    def launch(fn, *args):
        calls.append(fn)
        if fn == "km_count_launch":  # the count and scan passes
            shim.km_count_host(*args)
        elif fn == "km_scan_launch":
            R, _, _, totals, counts_host = args
            ctypes.memmove(counts_host, totals, 8 * R)
        else:
            shim.km_scatter_host(*args)

    monkeypatch.setattr(troute, "_state", lambda dev: (pinned, Event()))
    monkeypatch.setattr(kernels.KM, "launch", launch)
    shard, ret, cols = _km_edge(case)
    R, param = 3, (20 if rule == troute.PREFIX else 22)
    ret = ret if rule == troute.BLOOM else None
    got = troute._route(cols + [None], R, rule, param, shard, ret)
    want = troute.route_rows_plain(cols + [None], R, rule, param, shard, ret)
    assert calls == ([] if case == "empty" else [
        "km_count_launch", "km_scan_launch", "record", "km_scatter_launch",
        "wait"])
    assert got.counts == want.counts
    for g, w in zip(got.cols + [got.perm], want.cols + [want.perm]):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.is_contiguous()
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def _probe_idx(rng, shape, n):
    """Start indices in [0, n), with some outside it (taken modulo n)."""
    idx = rng.integers(0, n, shape).astype(np.int32)
    flat = idx.reshape(-1)
    edges = [-1, n, -(1 << 31), (1 << 31) - 1]
    flat[:len(edges)] = edges[:flat.size]
    return torch.from_numpy(idx)


def _empty_like(*ts):
    return [torch.empty_like(t) for t in ts]


@pytest.mark.parametrize("steps", [1, 3, 8])
def test_ko_body_matches_plain(shim, steps):
    rng = np.random.default_rng(60 + steps)
    N, Q = 1 << 10, 300
    tab = torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, N).astype(np.int32))
    idx = _probe_idx(rng, Q, N)
    want = tprobe.flat_gather_plain(tab, idx, steps)
    got = _empty_like(*want)
    shim.ko_host(Q, _p(tab), N, _p(idx), steps, *(_p(g) for g in got))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# one query; a table of 2 entries; tables of 2^10 to 2^20; steps 1, 4
# and 64; query counts off a multiple of the 256-thread block
@pytest.mark.parametrize("Q,n,steps", [
    (1, 10, 1), (1, 10, 64), (5, 1, 4), (257, 10, 64), (1000, 12, 4),
    (5000, 16, 64), (3000, 20, 1), (3000, 20, 4), (3000, 20, 64)])
def test_ko_body_at_shapes(shim, Q, n, steps):
    """ko_query over tables and chains of many sizes, start indices -1,
    N, -2^31 and 2^31 - 1 among them (taken modulo N)."""
    rng = np.random.default_rng(Q + n + steps)
    N = 1 << n
    tab = torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, N).astype(np.int32))
    idx = _probe_idx(rng, Q, N)
    want = tprobe.flat_gather_plain(tab, idx, steps)
    got = _empty_like(*want)
    shim.ko_host(Q, _p(tab), N, _p(idx), steps, *(_p(g) for g in got))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("target", ["first", "last"])
@pytest.mark.parametrize("steps", [1, 4, 64])
def test_ko_body_converging_chains(shim, target, steps):
    """Chains that all converge on one entry after their first step:
    tab[j] = -j sends every index to 0, tab[j] = N - 1 - j to N - 1."""
    rng = np.random.default_rng(steps)
    N, Q = 1 << 12, 9000
    j = np.arange(N)
    tab = torch.from_numpy(
        (-j if target == "first" else N - 1 - j).astype(np.int32))
    idx = _probe_idx(rng, Q, N)
    want = tprobe.flat_gather_plain(tab, idx, steps)
    assert bool((want[1] == (0 if target == "first" else N - 1)).all())
    got = _empty_like(*want)
    shim.ko_host(Q, _p(tab), N, _p(idx), steps, *(_p(g) for g in got))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["row", "column", "lane"])
@pytest.mark.parametrize("steps", [1, 16])
def test_kp_body_matches_plain(shim, mode, steps):
    """Each mode on the route the wrapper takes for 32 rows (tile_route:
    column mode the shared one at 16 steps and the global one at 1, row
    mode the global one)."""
    rng = np.random.default_rng(70 + steps)
    R = 32
    tab = torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, (R, 128)).astype(np.int32))
    shape = {"row": (200,), "column": (40, 128), "lane": (R, 128)}[mode]
    idx = _probe_idx(rng, shape, 128 if mode == "lane" else R)
    want = tprobe.tile_gather_plain(tab, idx, steps, mode)
    got = _kp_host(shim, tab, idx, steps, mode,
                   tprobe.tile_route(R, mode, steps, shape[0]))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _kp_host(shim, tab, idx, steps, mode, route):
    """KP's kernel as the shim runs it on this route: (out or v, ix)."""
    R, Q = tab.shape[0], idx.shape[0]
    if mode == "row":
        got = (torch.empty((Q, 128), dtype=torch.int32),
               torch.empty((Q,), dtype=torch.int32))
        shim.kp_row_host(Q, _p(tab), R, _p(idx), steps,
                         *(_p(g) for g in got))
        return got
    got = _empty_like(idx, idx)
    if mode == "column":
        shim.kp_column_host(Q, _p(tab), R, _p(idx), steps,
                            int(route == tprobe.SHARED),
                            *(_p(g) for g in got))
    else:
        shim.kp_lane_host(R, _p(tab), _p(idx), steps, *(_p(g) for g in got))
    return got


@pytest.mark.parametrize("steps", [1, 16])
@pytest.mark.parametrize("mode,rows,route", [
    ("column", 8192, "shared"), ("column", 8192, "global"),
    ("column", 16384, "global"), ("column", 4, "shared"),
    ("column", 1, "shared"), ("column", 2, "global"),
    ("row", 32768, "global"), ("row", 65536, "global"),
    ("row", 256, "global"), ("row", 2, "global"), ("row", 1, "global")])
def test_kp_routes_match_plain(shim, mode, rows, route, steps):
    """KP's column walk on both routes, staged (the columns of a group of
    four lanes, one after another) and in the table, on both sides of
    tile_route's boundary (8,192 and 16,384 rows); row mode's walk in the
    table at 32,768 and 65,536 rows; on tables of 1, 2 and 4 rows, at 1
    and 16 steps; indices at the table's edges
    and outside it, every group's edge lanes (4 c0 - 1, 4 c0) in each
    query."""
    rng = np.random.default_rng(rows + steps)
    tab = torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, (rows, 128)).astype(np.int32))
    shape = (40, 128) if mode == "column" else (200,)
    idx = _probe_idx(rng, shape, rows)
    idx.view(-1)[4:8] = torch.tensor([0, rows - 1, rows - 1, 0],
                                     dtype=torch.int32)
    want = tprobe.tile_gather_plain(tab, idx, steps, mode)
    got = _kp_host(shim, tab, idx, steps, mode, route)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["row", "column", "lane"])
@pytest.mark.parametrize("off", [(0, 0), (1, 0), (0, 3)])
def test_kp_wrapper_takes_views_off_16_bytes(shim, monkeypatch, mode, off):
    """tile_gather's card path, with the shim doing its launch, on views
    that start 4 or 12 bytes past a 16-byte boundary (tab, idx): one
    launch, equal to the plain version; column mode's shared route (16
    steps over 32 rows), which reads 16 bytes a load, gives way to the
    global one where either input is off the boundary; row mode, whose
    copy reads tab 16 bytes a load, raises on such a tab only."""
    calls = []

    def launch(fn, *args):
        calls.append((fn, args))
        getattr(shim, fn.replace("_launch", "_host"))(*args)

    monkeypatch.setattr(kernels.KP, "launch", launch)
    rng = np.random.default_rng(sum(off) + len(mode))
    R, steps = 32, 16
    tab = torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, R * 128 + off[0]).astype(np.int32))
    tab = tab[off[0]:].view(R, 128)
    shape = {"row": (200,), "column": (40, 128), "lane": (R, 128)}[mode]
    idx = _probe_idx(rng, (int(np.prod(shape)) + off[1],),
                     128 if mode == "lane" else R)[off[1]:].view(shape)
    assert (tab.data_ptr() % 16 != 0) == (off[0] != 0)
    assert (idx.data_ptr() % 16 != 0) == (off[1] != 0)
    want = tprobe.tile_gather_plain(tab, idx, steps, mode)
    if mode == "row" and off[0]:
        with pytest.raises(ValueError, match="16-byte"):
            tprobe._tile_gather_card(tab, idx, steps, mode)
        assert calls == []
        return
    got = tprobe._tile_gather_card(tab, idx, steps, mode)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert [fn for fn, _ in calls] == [f"kp_{mode}_launch"]
    if mode == "column":
        assert tprobe.tile_route(R, mode, steps, 40) == tprobe.SHARED
        assert calls[0][1][5] == int(off == (0, 0))


@pytest.mark.parametrize("variant", ["registers", "shared"])
@pytest.mark.parametrize("steps", [1, 2, 5])
def test_kq_body_matches_plain(shim, variant, steps):
    rng = np.random.default_rng(80 + steps)
    B = 70
    x = torch.from_numpy(
        rng.integers(-(1 << 20), 1 << 20, (B, 128)).astype(np.int32))
    pos = torch.from_numpy(rng.integers(0, 128, B).astype(np.int32))
    want = tprobe.onehot_passes_plain(x, pos, steps)
    got = torch.empty_like(x)
    getattr(shim, f"kq_{variant}_host")(B, _p(x), _p(pos), steps, _p(got))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("variant", ["registers", "shared"])
@pytest.mark.parametrize("steps", [1, 16, 32])
@pytest.mark.parametrize("B", [1, 8, 13, 2051])
def test_kq_lanes_match_plain(shim, variant, steps, B):
    """KQ's warps lane by lane (kq_lane: a lane's four columns; kq_pass:
    lane i's pass on the staged row) at the probes' 1, 16 and 32 steps,
    over B rows, not always a multiple of a block's KQ_ROWS (8): pos 127
    (a wrap after one column), 0, 97, 98 (the last whose passes do not
    wrap, 98 + 29 = 127), -1 and 2^31 - 1 (taken modulo 128), the rest at
    random; x is left as it was."""
    rng = np.random.default_rng(B + steps)
    x = torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, (B, 128)).astype(np.int32))
    pos = rng.integers(0, 128, B).astype(np.int32)
    edges = [127, 0, 97, 98, -1, (1 << 31) - 1]
    pos[:len(edges)] = edges[:B]
    pos = torch.from_numpy(pos)
    x0 = x.clone()
    want = tprobe.onehot_passes_plain(x, pos, steps)
    got = torch.full_like(x, 7)
    getattr(shim, f"kq_{variant}_host")(B, _p(x), _p(pos), steps, _p(got))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(x, x0)
    assert int((got - x0).sum()) == 30 * steps * B


@pytest.mark.parametrize("hi_bits", [17, 30])
@pytest.mark.parametrize("steps", [1, 4])
def test_kr_body_matches_plain(shim, hi_bits, steps):
    """The eager route.  hi from [-2^17, 2^17): both slots often match,
    negative values too; from [-2^30, 2^30): nearly every probe misses."""
    rng = np.random.default_rng(90 + steps + hi_bits)
    N, Q = 1 << 12, 300
    lo = torch.from_numpy(
        rng.integers(-(1 << 31), 1 << 31, N).astype(np.int32))
    hi = torch.from_numpy(
        rng.integers(-(1 << hi_bits), 1 << hi_bits, N).astype(np.int32))
    idx = _probe_idx(rng, Q, N)
    want = tprobe.two_plane_plain(lo, hi, idx, steps)
    got = _empty_like(*want)
    shim.kr_host(Q, _p(lo), _p(hi), N, _p(idx), steps, 0,
                 *(_p(g) for g in got))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _kr_planes(rng, N):
    """lo and hi as u32 bit patterns over the full range (a hi word with
    its top bit set makes hi ^ ix negative: a match), with a third of the
    keys j placed at their first slot (hi[j] = j ^ r, r < 2^16) and a
    third at their second (hi[j * -1640531527 & (N - 1)] = j ^ r)."""
    def u32(n):
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
            np.uint32)

    lo, hi = u32(N), u32(N)
    j = rng.permutation(N).astype(np.uint64)
    first, second = j[:N // 3], j[N // 3:2 * N // 3]
    r = rng.integers(0, 1 << 16, N).astype(np.uint64)
    hi[first] = (first ^ r[:len(first)]).astype(np.uint32)
    s2 = (second * np.uint64(tprobe.GOLD)) & np.uint64(N - 1)
    hi[s2] = (second ^ r[:len(second)]).astype(np.uint32)
    return (torch.from_numpy(lo.view(np.int32)),
            torch.from_numpy(hi.view(np.int32)))


@pytest.mark.parametrize("steps", [1, 4, 64])
@pytest.mark.parametrize("Q", [1, 301, 1024])
def test_kr_lazy_route_matches_plain(shim, steps, Q):
    """KR's lazy route (kr_lazy_query: hi at both slots, then lo at the
    slot that matched) over u32 bit patterns, where the chains' steps hit
    at the first slot, at the second and at neither; against
    two_plane_plain and the eager route."""
    rng = np.random.default_rng(Q + steps)
    N = 1 << 12
    lo, hi = _kr_planes(rng, N)
    idx = _probe_idx(rng, Q, N)
    want = tprobe.two_plane_plain(lo, hi, idx, steps)
    for lazy in (1, 0):
        got = [torch.full((Q,), 7, dtype=torch.int32) for _ in range(2)]
        shim.kr_host(Q, _p(lo), _p(hi), N, _p(idx), steps, lazy,
                     *(_p(g) for g in got))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_kr_planes_hit_both_slots_and_miss():
    """_kr_planes gives the lazy test every case: over one step from every
    slot, hits at the first slot (over half: a random hi word with its top
    bit set matches any key), at the second only, and at neither."""
    rng = np.random.default_rng(5)
    N = 1 << 12
    lo, hi = _kr_planes(rng, N)
    ix = torch.arange(N, dtype=torch.int64)
    s2 = (ix * tprobe.GOLD) & (N - 1)
    m1 = (hi.long()[ix] ^ ix) < tprobe.HIT
    m2 = (hi.long()[s2] ^ ix) < tprobe.HIT
    assert int(m1.sum()) > N // 2
    assert int((~m1 & m2).sum()) > N // 8
    assert int((~m1 & ~m2).sum()) > N // 64


@pytest.mark.parametrize("variant", ["registers", "shared"])
@pytest.mark.parametrize("off", [0, 1, 3])
def test_kq_wrapper_launches_once_out_of_place(shim, monkeypatch, variant,
                                               off):
    """onehot_passes' card path, with the shim doing its launch: one
    launch into a new tensor, x (also a view 4 or 12 bytes past a 16-byte
    boundary) not written, equal to the plain version."""
    calls = []

    def launch(fn, *args):
        calls.append(fn)
        getattr(shim, fn.replace("_launch", "_host"))(*args)

    monkeypatch.setattr(kernels.KQ, "launch", launch)
    rng = np.random.default_rng(off)
    B, steps = 37, 16
    x = torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, B * 128 + off).astype(np.int32))[off:]
    x = x.view(B, 128)
    assert (x.data_ptr() % 16 != 0) == (off != 0)
    pos = torch.from_numpy(rng.integers(0, 128, B).astype(np.int32))
    x0 = x.clone()
    got = tprobe._onehot_passes_card(x, pos, steps, variant)
    torch.testing.assert_close(
        got, tprobe.onehot_passes_plain(x0, pos, steps), rtol=0, atol=0)
    assert torch.equal(x, x0) and got.data_ptr() != x.data_ptr()
    assert calls == [f"kq_{variant}_launch"]


@pytest.mark.parametrize("Q", [300, tprobe.KR_LAZY_QUERIES])
def test_kr_wrapper_launches_its_route(shim, monkeypatch, Q):
    """two_plane's card path, with the shim doing its launch: one launch
    on the route two_plane_route gives (kr_launch's lazy 0 for the eager
    route, 1 for the lazy one), equal to the plain version."""
    calls = []

    def launch(fn, *args):
        calls.append(args[6])
        getattr(shim, fn.replace("_launch", "_host"))(*args)

    monkeypatch.setattr(kernels.KR, "launch", launch)
    rng = np.random.default_rng(Q)
    N, steps = 1 << 12, 4
    lo, hi = _kr_planes(rng, N)
    idx = _probe_idx(rng, Q, N)
    route = tprobe.two_plane_route(Q, steps)
    got = tprobe._two_plane_card(lo, hi, idx, steps, route)
    for g, w in zip(got, tprobe.two_plane_plain(lo, hi, idx, steps)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert calls == [int(route == tprobe.LAZY)]


def _c_param_types(params: str):
    out = []
    for p in params.split(","):
        p = p.strip()
        out.append(ctypes.c_void_p if "*" in p else
                   ctypes.c_longlong if p.startswith("long long") else
                   ctypes.c_int)
    return out


@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_launcher_bindings_match_c_signatures(name):
    """Every ctypes binding of kernels.py lists the C entry point's
    parameters, stream included: a missing one would pass a pointer
    through the default int conversion."""
    k = kernels.KERNELS[name]
    src = k.source.read_text()
    found = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert set(found) == set(k.signatures)
    for fn, argtypes in k.signatures.items():
        assert _c_param_types(found[fn]) == argtypes, fn
