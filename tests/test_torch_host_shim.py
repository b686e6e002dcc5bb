"""The CUDA kernels' per-read bodies, compiled for the CPU, against the
plain PyTorch versions.

csrc/*.cuh hold each kernel's per-read (KA, KC, KD, KH), per-row (KB,
KE, KF, KG, KJ, KK), per-block (KI) or per-key (KL) body as
__host__ __device__ functions; csrc/host_shim.cpp wraps them in loops
over the reads or rows that one CUDA thread would take.  Here g++ builds
the shim (`-x c++ -D__host__= -D__device__=`) and ctypes loads it, so the
kernels' logic runs on a machine without a card.  Inputs are seeded
numpy batches and a tests/datagen.py dataset (a 12 kb genome, 100 bp
reads, 1% errors).  Every output is an integer: the tolerance is exact
equality."""

import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from bfc_tpu_torch import kernels
from bfc_tpu_torch.models import counter as TC
from bfc_tpu_torch.models import trimmer as TT
from bfc_tpu_torch.ops import annotate as tann
from bfc_tpu_torch.ops import kmer as tk
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
    lib.kb_head_host.argtypes = [P, P, LL, P]
    lib.kb_combine_host.argtypes = [LL] + [P] * 16
    lib.kc_host.argtypes = [P, I, I, I, I, I, P, P, I, I, P, P, P, P]
    lib.kd_host.argtypes = [P, I, I, I, I, P, I, I] + [P] * 8
    lib.ke_host.argtypes = [LL] + [P] * 6
    lib.kf_host.argtypes = [LL, P, P, P, I, I, P, P, P]
    lib.kg_host.argtypes = [LL, P, P, I, I, P]
    lib.kh_host.argtypes = [P, P, I, I, I, P, I, I, P]
    lib.probe_bits_host.argtypes = [LL, P, I, I, P]
    lib.ki_host.argtypes = [LL, P, P, P, P, I, I, P]
    lib.kj_host.argtypes = [LL, P, P, I, I, P]
    lib.kk_host.argtypes = [LL] + [P] * 8
    lib.kl_host.argtypes = [LL, P, P, P, I, I, I, P, I]
    lib.kl_host.restype = ctypes.c_int
    for f in (lib.ka_host, lib.kb_head_host, lib.kb_combine_host,
              lib.kc_host, lib.kd_host, lib.ke_host, lib.kf_host,
              lib.kg_host, lib.kh_host, lib.probe_bits_host, lib.ki_host,
              lib.kj_host, lib.kk_host):
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


@pytest.mark.parametrize("k", [17, 23, 32, 33, 63])
def test_ka_body_matches_plain(shim, k):
    bases, qok, lens = _batch(k)
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


@pytest.mark.parametrize("k", [23, 63])
def test_kb_body_matches_plain(shim, k):
    o = Opts()
    o.k = k
    l_pre = o.effective_l_pre()
    carry = not tsdn.ret_derivable(k, l_pre)
    bases, qok, lens = _batch(5)
    a = tsdn.chunk_run(bases, qok, lens, 0, k, l_pre, carry)
    # the same reads again, later in the stream: every key repeats
    b = tsdn.chunk_run(bases, ~qok, lens, bases.numel(), k, l_pre, carry)
    cat = tsdn.Run(*(None if x is None else torch.cat([x, y])
                     for x, y in zip(a, b)))
    srt = tsdn._gather(cat, tsdn.stable_order(cat.shard, cat.keybody))
    want = tsdn.run_combine_plain(srt)
    N = len(srt)
    head = torch.empty((N,), dtype=torch.int32)
    shim.kb_head_host(_p(srt.shard), _p(srt.keybody), N, _p(head))
    cum = torch.cumsum(head, 0, dtype=torch.int64)
    C = int(cum[-1])
    assert C == len(want) < N
    got = tsdn.Run(*(torch.empty((C,), dtype=torch.int64) for _ in range(5)),
                   torch.empty((C,), dtype=torch.uint8),
                   torch.empty((C,), dtype=torch.int64) if carry else None)
    shim.kb_combine_host(N, _p(head), _p(cum), *(_p(f) for f in srt),
                         *(_p(f) for f in got))
    for name, w, g in zip(tsdn.Run._fields, want, got):
        if w is not None:
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)


@pytest.fixture(scope="module", params=[21, 33])
def spectrum(request, tmp_path_factory):
    """A port spectrum (CPU, plain versions) of a small dataset, and an
    encoded batch of its reads."""
    k = request.param
    d = tmp_path_factory.mktemp(f"shim{k}")
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


def _kc_host(shim, t, bases, lens, min_cov):
    B, L = bases.shape
    occ = torch.empty((B, L), dtype=torch.int32)
    lcov = torch.empty((B, L), dtype=torch.uint8)
    hcov = torch.empty_like(lcov)
    isl = torch.empty((B, 3), dtype=torch.int32)
    shim.kc_host(_p(t.table), t.k, t.l_pre, t.kb_bits, t.c_bits, min_cov,
                 _p(bases), _p(lens), B, L, _p(occ), _p(lcov), _p(hcov),
                 _p(isl))
    return occ, lcov, hcov, isl


def test_kc_body_matches_plain(shim, spectrum):
    opt, ds, bases, _, lens = spectrum
    want = tann.kcov_island_plain(ds.table, bases, lens, opt.min_cov)
    got = _kc_host(shim, ds.table, bases, lens, opt.min_cov)
    for name, w, g in zip(("occ", "lcov", "hcov", "isl"), want, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
    assert bool((want[3][:, 2] == 1).any())


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
    B, L = bases.shape
    packed = torch.empty((B, L), dtype=torch.uint8)
    out = torch.empty((B, tsrch.N_OUT), dtype=torch.int32)
    ip = tsrch._iparams(opt, ds.mode, heap_cap, stack_cap)
    shim.kd_host(_p(t.table), t.k, t.l_pre, t.kb_bits, t.c_bits,
                 ip.ctypes.data, B, L, _p(bases), _p(qf), _p(lens), _p(lcov),
                 _p(hcov), _p(isl), _p(packed), _p(out))
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(packed, want_packed, rtol=0, atol=0)
    n_ovf = int(want_out[:, tsrch.OVERFLOW].sum())
    if heap_cap == tsrch.HEAP_CAP:
        assert n_ovf == 0 and int((want_out[:, tsrch.N_EC] > 0).sum()) > 10
    else:
        assert 0 < n_ovf < B


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


def _kf_host(shim, opt, ret, arr, n):
    C = len(ret)
    dense = np.zeros((1 << opt.bf_shift,), np.uint32)
    fp = torch.empty((C,), dtype=torch.bool)
    keep = torch.empty((C,), dtype=torch.bool)
    shim.kf_host(C, _p(ret), _p(arr), _p(n), opt.bf_shift, opt.n_hashes,
                 dense.ctypes.data, _p(fp), _p(keep))
    return fp, keep


def test_kf_body_matches_plain(shim, trim_agg):
    opt, _, ret, arr, n, _ = trim_agg
    got = _kf_host(shim, opt, ret, arr, n)
    want = tspec.adjudicate_sketch_plain(ret, arr, n, opt.bf_shift,
                                         opt.n_hashes)
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


def test_ki_body_matches_plain(shim, trim_agg):
    """KI's block replay over the wrapper's (block, arrival) order, with
    arrivals from 0 and from 2^33."""
    opt, run, ret, _, _, _ = trim_agg
    for shift in (0, 1 << 33):
        arr = run.arr + shift
        perm, starts = tspec.block_order(ret, arr, opt.bf_shift)
        fp = torch.empty((len(ret),), dtype=torch.bool)
        shim.ki_host(len(starts) - 1, _p(starts), _p(perm), _p(ret),
                     _p(arr), opt.bf_shift, opt.n_hashes, _p(fp))
        want = tspec.adjudicate_first_occurrence_plain(ret, arr, opt.bf_shift,
                                                       opt.n_hashes)
        torch.testing.assert_close(fp, want, rtol=0, atol=0)
        assert int((want & (run.n == 1)).sum()) > 0
        assert int((starts[1:] - starts[:-1]).max()) > 32  # hot blocks


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
    """On the aggregate's rows with counts raised past both payload caps."""
    opt, run, ret, _, _, _ = trim_agg
    n, n_high = run.n * 100, run.n_high * 100
    fp = tspec.adjudicate_first_occurrence_plain(ret, run.arr, opt.bf_shift,
                                                 opt.n_hashes)
    C = len(ret)
    payload = torch.empty((C,), dtype=torch.int32)
    keep = torch.empty((C,), dtype=torch.bool)
    hist = torch.zeros((256,), dtype=torch.int64)
    hist_high = torch.zeros((64,), dtype=torch.int64)
    shim.kk_host(C, _p(n), _p(n_high), _p(run.first_high), _p(fp),
                 _p(payload), _p(keep), _p(hist), _p(hist_high))
    want = tspec.finalize_counts_plain(n, n_high, run.first_high, fp)
    for g, w in zip((payload, keep, hist, hist_high), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert int(hist[255]) > 0 and int(hist_high[63]) > 0


def test_kl_inserts_match_plain_lookups(shim, trim_agg):
    """KL's inserts, one key after another, build a table whose lookups
    equal the plain build's: every kept row its payload, every other row
    -1 (the layouts differ)."""
    opt, run, ret, _, _, _ = trim_agg
    k, l_pre = opt.k, opt.effective_l_pre()
    kb_bits = tk.keybody_bits(k, l_pre)
    fp = tspec.adjudicate_first_occurrence_plain(ret, run.arr, opt.bf_shift,
                                                 opt.n_hashes)
    payload, keep, _, _ = tspec.finalize_counts_plain(
        run.n, run.n_high, run.first_high, fp)
    shard, keybody, kept = run.shard[keep], run.keybody[keep], payload[keep]
    c_bits = TC.table_c_bits(len(shard), k, l_pre)
    assert c_bits <= 32
    table = torch.zeros((1 << c_bits,), dtype=torch.int64)
    assert shim.kl_host(len(shard), _p(shard), _p(keybody), _p(kept), l_pre,
                        kb_bits, c_bits, _p(table), 1000) == 0
    plain, ok = tspec.cuckoo_build_plain(shard, keybody, kept, k, l_pre,
                                         kb_bits, c_bits)
    assert ok
    want = tspec.cuckoo_lookup_plain(
        tspec.SpecTable(plain, k, l_pre, kb_bits, c_bits), run.shard,
        run.keybody)
    got = tspec.cuckoo_lookup_plain(
        tspec.SpecTable(table, k, l_pre, kb_bits, c_bits), run.shard,
        run.keybody)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got, torch.where(keep, payload, -1).to(
        torch.int64), rtol=0, atol=0)
    # a full table: 600 keys cannot sit in 512 slots
    small = torch.zeros((512,), dtype=torch.int64)
    assert shim.kl_host(600, _p(shard), _p(keybody), _p(kept), l_pre,
                        kb_bits, 9, _p(small), 1000) > 0


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
