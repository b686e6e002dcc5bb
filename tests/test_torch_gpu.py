"""The twelve CUDA kernels against their plain PyTorch versions on a card,
and the trim path and the device finalize on the card against the same
paths on the CPU.

Marked `gpu`: each test skips without a CUDA device.  The file imports
neither jax nor bfc_tpu, so it also runs where only the port is
installed:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py

Inputs: seeded numpy reads of a 20 kb genome (1% errors), counted on the
card into a spectrum.  Every output is an integer: the tolerance is
exact equality."""

import numpy as np
import pytest
import torch

from bfc_tpu_torch import kernels
from bfc_tpu_torch.models import counter as TC
from bfc_tpu_torch.models import device_pipeline as TDP
from bfc_tpu_torch.models import trimmer as TT
from bfc_tpu_torch.ops import annotate as ann
from bfc_tpu_torch.ops import kmer as kops
from bfc_tpu_torch.ops import search as srch
from bfc_tpu_torch.ops import spectrum as spec
from bfc_tpu_torch.ops import spectrum_dense as sdn
from bfc_tpu_torch.opts import Opts

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _reads(n=6000, glen=20000, rlen=100, seed=3):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, glen).astype(np.uint8)
    starts = rng.integers(0, glen - rlen, n)
    b = g[starts[:, None] + np.arange(rlen)[None, :]]
    err = rng.random((n, rlen)) < 0.01
    b = np.where(err, (b + 1) % 4, b).astype(np.uint8)
    q = np.where(err, 40, 70).astype(np.uint8)
    return b, q


def _write_fq(path, b, q):
    acgt = np.frombuffer(b"ACGT", np.uint8)
    path.write_bytes(b"".join(
        b"@r%d\n%s\n+\n%s\n" % (i, acgt[b[i]].tobytes(), q[i].tobytes())
        for i in range(len(b))))
    return path


@pytest.fixture(scope="module", params=[23, 33])
def spectrum(card, request, tmp_path_factory):
    k = request.param
    b, q = _reads()
    fq = _write_fq(tmp_path_factory.mktemp(f"gpu{k}") / "reads.fq", b, q)
    opt = Opts()
    opt.k = k
    opt.bf_shift = 24
    ds = TC.count_file_device(str(fq), opt, card, batch_reads=2048)
    return opt, ds, b, q


def _eq(got, want):
    for g, w in zip(got, want):
        if g is not None or w is not None:
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_ka_kb_match_plain(card, spectrum):
    opt, ds, b, q = spectrum
    k, l_pre = opt.k, opt.effective_l_pre()
    bases = torch.from_numpy(b[:1024]).to(card)
    qok = torch.from_numpy(q[:1024] >= 33 + opt.q).to(card)
    lens = torch.full((1024,), b.shape[1], dtype=torch.int32, device=card)
    got = kops.kmer_stream(bases, qok, lens, k, l_pre, 5, with_ret=True)
    _eq(got, kops.kmer_stream_plain(bases, qok, lens, k, l_pre, 5, True))
    shard, keybody, arrp = (t.view(-1) for t in got[:3])
    perm = sdn.stable_order(shard, keybody)
    arrp = arrp[perm]
    srt = sdn.Run(shard[perm], keybody[perm], arrp >> 1,
                  torch.ones_like(arrp), arrp & 1,
                  (arrp & 1).to(torch.uint8), got[3].view(-1)[perm])
    _eq(sdn.run_combine(srt), sdn.run_combine_plain(srt))


def test_kc_kd_match_plain(card, spectrum):
    opt, ds, b, q = spectrum
    t = ds.table
    bases = torch.from_numpy(b[:256]).to(card)
    qf = torch.from_numpy(q[:256] >= 33 + opt.q).to(card)
    lens = torch.full((256,), b.shape[1], dtype=torch.int32, device=card)
    kc = ann.kcov_island(t, bases, lens, opt.min_cov)
    _eq(kc, ann.kcov_island_plain(t, bases, lens, opt.min_cov))
    _, lcov, hcov, isl = kc
    kd = srch.ec1_search(t, opt, ds.mode, bases, qf, lens, lcov, hcov, isl)
    _eq(kd, srch.ec1_search_plain(t, opt, ds.mode, bases, qf, lens, lcov,
                                  hcov, isl))
    assert int((kd[1][:, srch.N_EC] > 0).sum()) > 50


def test_wrapper_refuses_cpu_table_for_card_reads(card, spectrum):
    opt, ds, b, _ = spectrum
    bases = torch.from_numpy(b[:8]).to(card)
    lens = torch.full((8,), b.shape[1], dtype=torch.int32, device=card)
    cpu_table = ds.table._replace(table=ds.table.table.cpu())
    with pytest.raises(ValueError):
        ann.kcov_island(cpu_table, bases, lens, opt.min_cov)


@pytest.mark.parametrize("k", [21, 51])
def test_ke_kf_kg_kh_match_plain(card, tmp_path, k):
    b, q = _reads()
    fq = _write_fq(tmp_path / "reads.fq", b, q)
    opt = Opts()
    opt.k = k
    opt.bf_shift = 24
    agg = TC.AggBuilder(opt, card)
    for bases, qok, lens, _ in TC.padded_batches(str(fq), opt, 2048):
        agg.add(bases, qok, lens)
    run = agg.fold()
    _eq(sdn.pack_pull(run), sdn.pack_pull_plain(run))
    ha = agg.pull(run)
    ret = torch.from_numpy(ha.ret.view(np.int64)).to(card)
    arr = torch.from_numpy(ha.first_arr.astype(np.uint32).view(np.int32)).to(card)
    n = torch.from_numpy(ha.n.astype(np.int32)).to(card)
    fp, keep = spec.adjudicate_sketch(ret, arr, n, opt.bf_shift, opt.n_hashes)
    _eq((fp, keep), spec.adjudicate_sketch_plain(ret, arr, n, opt.bf_shift,
                                                 opt.n_hashes))
    words = TT.bloom_build(ret, keep, opt.bf_shift, opt.n_hashes)
    _eq((words,), (TT.bloom_build_plain(ret, keep, opt.bf_shift,
                                        opt.n_hashes),))
    bases = torch.from_numpy(b[:1024]).to(card)
    lens = torch.full((1024,), b.shape[1], dtype=torch.int32, device=card)
    args = (words, bases, lens, k, opt.bf_shift, opt.n_hashes)
    got = TT.max_streak_batch(*args)
    _eq((got,), (TT.max_streak_plain(*args),))
    assert int((got >> 32 > 0).sum()) > 512


def test_trim_path_matches_cpu(card, tmp_path, monkeypatch):
    """-1 -k51 -b24 with the host sketch off, so the verdict is KF's."""
    monkeypatch.setenv("BFC_TPU_INC_ADJ", "0")
    b, q = _reads()
    fq = _write_fq(tmp_path / "reads.fq", b, q)
    opt = Opts()
    opt.k = 51
    opt.bf_shift = 24
    opt.filter_mode = True
    rep = {}
    got = TDP.run_device(opt, str(fq), device=card, report=rep)
    assert rep["verdict"] == "KF" and rep["reads_kept"] > 0
    assert got == TDP.run_device(opt, str(fq), device="cpu")


@pytest.mark.parametrize("k", [21, 51])
def test_ki_kj_kk_kl_match_plain(card, tmp_path, k):
    """The device finalize's kernels on a folded run: KJ (ret derived at
    k = 21, carried at 51), KI with arrivals from 0 and from 2^33 (equal
    to KF's verdicts), KK, and KL compared by lookups."""
    b, q = _reads()
    fq = _write_fq(tmp_path / "reads.fq", b, q)
    opt = Opts()
    opt.k = k
    opt.bf_shift = 24
    l_pre, H = opt.effective_l_pre(), opt.n_hashes
    agg = TC.AggBuilder(opt, card)
    for bases, qok, lens, _ in TC.padded_batches(str(fq), opt, 2048):
        agg.add(bases, qok, lens)
    run = agg.fold()
    ret = run.ret
    if ret is None:
        ret = sdn.derive_ret(run.shard, run.keybody, k, l_pre)
        _eq((ret,), (sdn.derive_ret_plain(run.shard, run.keybody, k, l_pre),))
    kf, _ = spec.adjudicate_sketch(ret, sdn.as_i32(run.arr),
                                   run.n.to(torch.int32), 24, H)
    for shift in (0, 1 << 33):
        arr = run.arr + shift
        fp = spec.adjudicate_first_occurrence(ret, arr, 24, H)
        _eq((fp,), (spec.adjudicate_first_occurrence_plain(ret, arr, 24, H),))
        _eq((fp,), (kf,))
    kk = spec.finalize_counts(run.n, run.n_high, run.first_high, fp)
    _eq(kk, spec.finalize_counts_plain(run.n, run.n_high, run.first_high, fp))
    payload, keep = kk[:2]
    shard, keybody, kept = run.shard[keep], run.keybody[keep], payload[keep]
    kb_bits = kops.keybody_bits(k, l_pre)
    c_bits = TC.table_c_bits(len(shard), k, l_pre)
    table, ok = spec.cuckoo_build(shard, keybody, kept, k, l_pre, kb_bits,
                                  c_bits)
    assert ok
    got = spec.cuckoo_lookup_plain(
        spec.SpecTable(table, k, l_pre, kb_bits, c_bits), run.shard,
        run.keybody)
    _eq((got,), (torch.where(keep, payload, -1).to(torch.int64),))


def test_device_finalize_matches_cpu(card, tmp_path):
    """Correction (k = 23) and trim (-1 -k51) with the device finalize on
    the card against the same runs on the CPU, and KE never launched."""
    b, q = _reads()
    fq = _write_fq(tmp_path / "reads.fq", b, q)
    for k, trim in ((23, False), (51, True)):
        opt = Opts()
        opt.k = k
        opt.bf_shift = 24
        opt.filter_mode = trim
        kernels.reset_launches()
        rep = {}
        got = TDP.run_device(opt, str(fq), device=card, report=rep,
                             device_finalize=True)
        assert rep["finalize"] == "device" and rep["verdict"] == "KF"
        assert kernels.KE.launches == 0
        assert kernels.KK.launches == (0 if trim else 1)
        assert got == TDP.run_device(opt, str(fq), device="cpu",
                                     device_finalize=True)
