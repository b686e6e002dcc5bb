"""The four CUDA kernels against their plain PyTorch versions on a card.

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

from bfc_tpu_torch.models import counter as TC
from bfc_tpu_torch.ops import annotate as ann
from bfc_tpu_torch.ops import kmer as kops
from bfc_tpu_torch.ops import search as srch
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


@pytest.fixture(scope="module", params=[23, 33])
def spectrum(card, request, tmp_path_factory):
    k = request.param
    b, q = _reads()
    fq = tmp_path_factory.mktemp(f"gpu{k}") / "reads.fq"
    acgt = np.frombuffer(b"ACGT", np.uint8)
    fq.write_bytes(b"".join(
        b"@r%d\n%s\n+\n%s\n" % (i, acgt[b[i]].tobytes(), q[i].tobytes())
        for i in range(len(b))))
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
