"""The CUDA kernels' per-read bodies, compiled for the CPU, against the
plain PyTorch versions.

csrc/*.cuh hold each kernel's per-read (KA, KC, KD) or per-row (KB) body
as __host__ __device__ functions; csrc/host_shim.cpp wraps them in loops
over the reads or rows that one CUDA thread would take.  Here g++ builds
the shim (`-x c++ -D__host__= -D__device__=`) and ctypes loads it, so the
kernels' logic runs on a machine without a card.  Inputs are seeded
numpy batches and a tests/datagen.py dataset (a 12 kb genome, 100 bp
reads, 1% errors).  Every output is an integer: the tolerance is exact
equality."""

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from bfc_tpu_torch.models import counter as TC
from bfc_tpu_torch.ops import annotate as tann
from bfc_tpu_torch.ops import kmer as tk
from bfc_tpu_torch.ops import search as tsrch
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
    for f in (lib.ka_host, lib.kb_head_host, lib.kb_combine_host,
              lib.kc_host, lib.kd_host):
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
