"""The eighteen CUDA kernels against their plain PyTorch versions on a
card (KA and KC also on rows of 600 slots and on a batch that is not a
multiple of a block's warps; KH also on 600 slots and on reads ending
short of their rows; KB and KM at their tile edges, KM at 1 to 256
ranks; KD with reads deferred to its second pass; KK at odd row counts
and unaligned inputs; KO over 2^20 and 2^26 entries and on chains that
converge on one entry; KP at the probe sites' shapes and on both routes),
the trim path and
the device finalize on the card against the same
paths on the CPU (also at -b35, KF's from arrival 0 and KI's from 2^33),
KF and KI on a fold whose hot blocks hold over 1,000 rows, and the mesh
path (one NCCL rank, two gloo ranks sharing the card), with the table
replicated and sharded, against the single-device run, and the counting
tree spilled to the host by a forced BFC_TPU_MAX_MERGE_CAP against the
CPU's aggregates.

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
from bfc_tpu_torch.ops import probe
from bfc_tpu_torch.ops import route
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


def _long_rows(b, q, n, seed=11):
    """n rows of 600 slots, six of the spectrum's reads end to end, with
    lengths from 550 to 600 (most ending mid-chunk) and a few Ns."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(b), (n, 6))
    lb = b[idx].reshape(n, -1).copy()
    lq = q[idx].reshape(n, -1)
    lb[rng.random(lb.shape) < 0.002] = 4
    lens = rng.integers(550, 601, n).astype(np.int32)
    return lb, lq, lens


def _batches(card, opt, b, q):
    """(bases, quality ok, lens) on the card: 1,024 reads of 100 slots,
    1,021 reads (not a multiple of a block's warps) and 333 rows of 600
    slots."""
    lb, lq, ll = _long_rows(b, q, 333)
    out = []
    for bb, qq, ln in ((b[:1024], q[:1024], None), (b[:1021], q[:1021], None),
                       (lb, lq, ll)):
        if ln is None:
            ln = np.full((len(bb),), bb.shape[1], np.int32)
        out.append((torch.from_numpy(np.ascontiguousarray(bb)).to(card),
                    torch.from_numpy(qq >= 33 + opt.q).to(card),
                    torch.from_numpy(ln).to(card)))
    return out


def test_ka_kb_match_plain(card, spectrum):
    opt, ds, b, q = spectrum
    k, l_pre = opt.k, opt.effective_l_pre()
    outs = []
    for bases, qok, lens in _batches(card, opt, b, q):
        outs.append(kops.kmer_stream(bases, qok, lens, k, l_pre, 5,
                                     with_ret=True))
        _eq(outs[-1], kops.kmer_stream_plain(bases, qok, lens, k, l_pre, 5,
                                             True))
    got = outs[0]
    shard, keybody, arrp = (t.view(-1) for t in got[:3])
    perm = sdn.stable_order(shard, keybody)
    arrp = arrp[perm]
    srt = sdn.Run(shard[perm], keybody[perm], arrp >> 1,
                  torch.ones_like(arrp), arrp & 1,
                  (arrp & 1).to(torch.uint8), got[3].view(-1)[perm])
    _eq(sdn.run_combine(srt), sdn.run_combine_plain(srt))


@pytest.mark.parametrize("N,invalid", [(1, 0), (1, 1), (2049, 0),
                                       (2049, 2049), (70000, 3000)])
def test_kb_tile_edges_match_plain(card, N, invalid):
    """One row, one row past a 2,048-row tile, all rows invalid, and many
    tiles with groups of 1-6 rows straddling their edges."""
    rng = np.random.default_rng(N + invalid)
    valid = N - invalid
    shard = np.sort(rng.integers(0, max(valid // 3, 1), valid))
    shard = np.concatenate([shard, np.full(invalid, 0xFFFFFFFF)])
    keybody = shard * 7 + 3
    cols = [torch.from_numpy(c.astype(np.int64)).to(card) for c in
            (shard, keybody, rng.integers(0, 1 << 40, N),
             rng.integers(1, 5, N), rng.integers(0, 3, N))]
    fh = torch.from_numpy(rng.integers(0, 2, N).astype(np.uint8)).to(card)
    for ret in (None, torch.from_numpy(rng.integers(0, 1 << 62, N)).to(card)):
        srt = sdn.Run(*cols, fh, ret)
        got = sdn.run_combine(srt)
        want = sdn.run_combine_plain(srt)
        assert len(got) == len(want)
        _eq(got, want)


def test_kd_long_reads_defer_to_pass_two(card, spectrum):
    """Reads of 700 bases push past pass 1's 512-entry stack, so pass 2
    corrects them; tiny caps make some overflow the full caps."""
    opt, ds, _, _ = spectrum
    n = 96
    long_b, long_q = _reads(n=n, rlen=700, seed=3)  # the spectrum's genome
    bases = torch.from_numpy(long_b).to(card)
    qf = torch.from_numpy(long_q >= 33 + opt.q).to(card)
    lens = torch.from_numpy(np.random.default_rng(5).integers(
        600, 701, n).astype(np.int32)).to(card)
    t = ds.table
    _, lcov, hcov, isl = ann.kcov_island(t, bases, lens, opt.min_cov)
    for caps in ((srch.HEAP_CAP, srch.STACK_CAP), (24, 600)):
        got = srch.ec1_search(t, opt, ds.mode, bases, qf, lens, lcov, hcov,
                              isl, *caps)
        _eq(got, srch.ec1_search_plain(t, opt, ds.mode, bases, qf, lens,
                                       lcov, hcov, isl, *caps))


def test_correct_file_device_default_batch(card, spectrum, tmp_path):
    """70,000 reads in default batches (as the reader cuts them) give the
    bytes of 8,192-read batches."""
    opt, ds, b, q = spectrum
    idx = np.random.default_rng(7).integers(0, len(b), 70000)
    fq = _write_fq(tmp_path / "many.fq", b[idx], q[idx])
    from bfc_tpu_torch.io.writer import OutputWriter

    outs = []
    for batch in (srch.CORRECT_BATCH, 8192):
        w = OutputWriter()
        TDP.correct_file_device(str(fq), opt, ds, w, batch_reads=batch)
        outs.append(w.getbytes())
    assert outs[0] == outs[1]


def test_kc_kd_match_plain(card, spectrum):
    opt, ds, b, q = spectrum
    t = ds.table
    for bases, _, lens in _batches(card, opt, b, q)[1:]:
        _eq(ann.kcov_island(t, bases, lens, opt.min_cov),
            ann.kcov_island_plain(t, bases, lens, opt.min_cov))
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
    # -b12: blocks of over 1,000 rows; arrivals past the int32 sign
    hot = torch.bincount(ret & ((1 << 3) - 1)).max()
    assert int(hot) >= 1000
    far = torch.from_numpy(ha.first_arr.astype(np.int64)) + (3 << 30)
    for a in (arr, sdn.as_i32(far).to(card)):
        _eq(spec.adjudicate_sketch(ret, a, n, 12, opt.n_hashes),
            spec.adjudicate_sketch_plain(ret, a, n, 12, opt.n_hashes))
    words = TT.bloom_build(ret, keep, opt.bf_shift, opt.n_hashes)
    _eq((words,), (TT.bloom_build_plain(ret, keep, opt.bf_shift,
                                        opt.n_hashes),))
    bases = torch.from_numpy(b[:1024]).to(card)
    lens = torch.full((1024,), b.shape[1], dtype=torch.int32, device=card)
    args = (words, bases, lens, k, opt.bf_shift, opt.n_hashes)
    got = TT.max_streak_batch(*args)
    _eq((got,), (TT.max_streak_plain(*args),))
    assert int((got >> 32 > 0).sum()) > 512
    # KH on 333 rows of 600 slots, and on reads ending short of their
    # rows (empty, shorter than k, at chunk edges) with bases after them
    lb, _, ll = _long_rows(b, q, 333)
    ll[:6] = [0, k - 1, 31, 32, 33, 599]
    args = (words, torch.from_numpy(lb).to(card),
            torch.from_numpy(ll).to(card), k, opt.bf_shift, opt.n_hashes)
    got = TT.max_streak_batch(*args)
    _eq((got,), (TT.max_streak_plain(*args),))
    assert int((got >> 32 > 0).sum()) > 300


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


def _trim_b35(card, tmp_path, monkeypatch, base):
    """-1 -k51 -b35 on the card with arrivals numbered from base: the
    report, the launches of KF and KI, and whether the output equals the
    CPU run's."""
    b, q = _reads()
    fq = _write_fq(tmp_path / "reads.fq", b, q)
    opt = Opts()
    opt.k = 51
    opt.bf_shift = 35
    opt.filter_mode = True
    init = TC.AggBuilder.__init__

    def shifted(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.arrival_base = base

    monkeypatch.setattr(TC.AggBuilder, "__init__", shifted)
    rep = {}
    kernels.reset_launches()
    got = TDP.run_device(opt, str(fq), device=card, report=rep)
    launches = (kernels.KF.launches, kernels.KI.launches)
    return rep, launches, got == TDP.run_device(opt, str(fq), device="cpu")


def test_trim_at_b35_takes_ki(card, tmp_path, monkeypatch):
    """-1 -k51 -b35 with arrivals from 2^33: the verdict is KI's, KF never
    launches, and the output equals the CPU run's."""
    rep, launches, same = _trim_b35(card, tmp_path, monkeypatch, 1 << 33)
    assert rep["verdict"] == "KI" and rep["reads_kept"] > 0
    assert launches == (0, 1) and same


def test_trim_at_b35_takes_kf(card, tmp_path, monkeypatch):
    """-1 -k51 -b35 from arrival 0: KF's 16 bytes a row and 4 a Bloom
    block are free, so the verdict is KF's, KI never launches, and the
    output equals the CPU run's."""
    rep, launches, same = _trim_b35(card, tmp_path, monkeypatch, 0)
    assert rep["verdict"] == "KF" and rep["reads_kept"] > 0
    assert launches == (1, 0) and same


def _probe_idx(rng, shape, n):
    idx = rng.integers(0, n, shape).astype(np.int32)
    idx.reshape(-1)[:3] = [-1, n, (1 << 31) - 1]   # taken modulo n
    return torch.from_numpy(idx)


@pytest.mark.parametrize("steps", [1, 4, 16])
def test_ko_kr_match_plain(card, steps):
    rng = np.random.default_rng(steps)
    N = 1 << 20
    tab, hi = (torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, N).astype(
        np.int32)) for _ in range(2))
    hi[::3] = torch.from_numpy(rng.integers(-(1 << 17), 1 << 17,
                                            len(hi[::3])).astype(np.int32))
    idx = _probe_idx(rng, 50_000, N)
    for fn, args in ((probe.flat_gather, (tab, idx)),
                     (probe.two_plane, (tab, hi, idx))):
        want = fn(*args, steps=steps)
        got = fn(*(a.to(card) for a in args), steps=steps)
        torch.cuda.synchronize()
        _eq([g.cpu() for g in got], want)


@pytest.fixture(scope="module")
def ko_tables(card):
    """KO's tables on the card: 2^20 and 2^26 (the hbm_KO sites' 256 MiB)
    random entries, and 2^20 entries that send every chain to entry 0
    after its first step (tab[j] = -j, so ix + tab[ix] = 0)."""
    gen = torch.Generator(device=card).manual_seed(5)
    tabs = {n: torch.randint(0, 1 << 32, (1 << n,), generator=gen,
                             dtype=torch.int64, device=card).to(torch.int32)
            for n in (20, 26)}
    tabs["converging"] = -torch.arange(1 << 20, dtype=torch.int32,
                                       device=card)
    return tabs


@pytest.mark.parametrize("table", [20, 26, "converging"])
@pytest.mark.parametrize("steps", [1, 4, 64])
@pytest.mark.parametrize("Q", [8192, 262144])
def test_ko_matches_plain_at_sizes(card, ko_tables, table, steps, Q):
    """KO on the card, one launch a call, equal to its plain version on
    the same card tensors."""
    tab = ko_tables[table]
    rng = np.random.default_rng(Q + steps)
    idx = _probe_idx(rng, Q, tab.shape[0]).to(card)
    kernels.reset_launches()
    got = probe.flat_gather(tab, idx, steps)
    torch.cuda.synchronize()
    assert kernels.KO.launches == 1
    _eq(got, probe.flat_gather_plain(tab, idx, steps))


@pytest.mark.parametrize("mode", [probe.ROW, probe.COLUMN, probe.LANE])
@pytest.mark.parametrize("steps", [1, 16])
def test_kp_matches_plain(card, mode, steps):
    rng = np.random.default_rng(steps)
    R = 8192 if mode != probe.LANE else 2000
    tab = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (R, 128)).astype(
        np.int32))
    shape = {probe.ROW: (5000,), probe.COLUMN: (700, 128),
             probe.LANE: (R, 128)}[mode]
    idx = _probe_idx(rng, shape, 128 if mode == probe.LANE else R)
    want = probe.tile_gather(tab, idx, steps, mode)
    got = probe.tile_gather(tab.to(card), idx.to(card), steps, mode)
    torch.cuda.synchronize()
    _eq([g.cpu() for g in got], want)


# the probe sites' shapes (chip_probe.py: rows, queries, steps; lane
# mode's queries are its rows), both sides of column mode's rule, one
# table above its shared route, and row walks of 24 to 64 steps
@pytest.mark.parametrize("mode,R,Q,steps", [
    (probe.ROW, 8192, 8192, 1), (probe.ROW, 8192, 8192, 16),
    (probe.ROW, 8192, 8192, 64), (probe.COLUMN, 8192, 8192, 1),
    (probe.COLUMN, 8192, 8192, 16), (probe.LANE, 2048, 2048, 16),
    (probe.COLUMN, 8192, 2048, 16), (probe.LANE, 2051, 2051, 3),
    (probe.COLUMN, 8192, 2048, 4), (probe.COLUMN, 8192, 2048, 5),
    (probe.ROW, 8192, 33, 24), (probe.ROW, 2, 70, 30),
    (probe.COLUMN, 16384, 700, 16), (probe.ROW, 65536, 5000, 64),
    (probe.COLUMN, 8192, 1, 16), (probe.COLUMN, 4, 300, 16)])
def test_kp_sites_match_plain(card, mode, R, Q, steps):
    rng = np.random.default_rng(R + Q + steps)
    tab = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (R, 128)).astype(
        np.int32))
    shape = {probe.ROW: (Q,), probe.COLUMN: (Q, 128),
             probe.LANE: (R, 128)}[mode]
    idx = _probe_idx(rng, shape, 128 if mode == probe.LANE else R)
    want = probe.tile_gather(tab, idx, steps, mode)
    kernels.reset_launches()
    got = probe.tile_gather(tab.to(card), idx.to(card), steps, mode)
    torch.cuda.synchronize()
    _eq([g.cpu() for g in got], want)
    assert kernels.KP.launches == 1


@pytest.mark.parametrize("mode", [probe.ROW, probe.COLUMN, probe.LANE])
@pytest.mark.parametrize("off", [(0, 1), (1, 0), (3, 3)])
def test_kp_views_off_16_bytes(card, mode, off):
    """KP on views that start 4 or 12 bytes past a 16-byte boundary (tab,
    idx): equal to the plain version, column mode's shared route (16 steps
    over 8,192 rows, 2,048 queries) giving way to the global one; row
    mode raises on such a tab."""
    rng = np.random.default_rng(7 + sum(off))
    R, Q, steps = 8192, 2048, 16
    tab = torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, R * 128 + off[0]).astype(np.int32))
    shape = {probe.ROW: (Q,), probe.COLUMN: (Q, 128),
             probe.LANE: (R, 128)}[mode]
    idx = _probe_idx(rng, (int(np.prod(shape)) + off[1],),
                     128 if mode == probe.LANE else R)
    tab_c = tab.to(card)[off[0]:].view(R, 128)
    idx_c = idx.to(card)[off[1]:].view(shape)
    tab, idx = tab[off[0]:].view(R, 128), idx[off[1]:].view(shape)
    if mode == probe.ROW and off[0]:
        with pytest.raises(ValueError, match="16-byte"):
            probe.tile_gather(tab_c, idx_c, steps, mode)
        return
    want = probe.tile_gather(tab, idx, steps, mode)
    kernels.reset_launches()
    got = probe.tile_gather(tab_c, idx_c, steps, mode)
    torch.cuda.synchronize()
    _eq([g.cpu() for g in got], want)
    assert kernels.KP.launches == 1


@pytest.mark.parametrize("variant", [probe.REGISTERS, probe.SHARED])
def test_kq_matches_plain(card, variant):
    """KQ at 1, 3, 16 and 32 steps over 2,050 rows (not a multiple of a
    block's 8): one launch a call into a new tensor, x not written."""
    rng = np.random.default_rng(7)
    B = 2050
    x = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (B, 128)).astype(
        np.int32))
    pos = rng.integers(0, 128, B).astype(np.int32)
    pos[:4] = [0, 97, 98, 127]
    pos = torch.from_numpy(pos)
    xc, pc = x.to(card), pos.to(card)
    for steps in (1, 3, 16, 32):
        want = probe.onehot_passes(x, pos, steps, variant)
        kernels.reset_launches()
        got = probe.onehot_passes(xc, pc, steps, variant)
        torch.cuda.synchronize()
        _eq((got.cpu(), xc.cpu()), (want, x))
        assert kernels.KQ.launches == 1


@pytest.mark.parametrize("variant", [probe.REGISTERS, probe.SHARED])
@pytest.mark.parametrize("off", [1, 3])
def test_kq_views_off_16_bytes(card, variant, off):
    """KQ on an x that starts 4 or 12 bytes past a 16-byte boundary (read
    4 bytes a load): equal to the plain version, x not written."""
    rng = np.random.default_rng(off)
    B, steps = 2048, 16
    flat = torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, B * 128 + off).astype(np.int32))
    pos = torch.from_numpy(rng.integers(0, 128, B).astype(np.int32))
    x = flat[off:].view(B, 128)
    xc = flat.to(card)[off:].view(B, 128)
    assert xc.data_ptr() % 16
    want = probe.onehot_passes(x, pos, steps, variant)
    got = probe.onehot_passes(xc, pos.to(card), steps, variant)
    torch.cuda.synchronize()
    _eq((got.cpu(), xc.cpu()), (want, x))


def _kr_planes(card, N, seed):
    """lo and hi over the full i32 range (a hi word with its top bit set
    matches any key), a third of the keys j at their first slot (hi[j] =
    j ^ r, r < 2^16) and a third at their second, made on the card."""
    gen = torch.Generator(device=card).manual_seed(seed)
    lo, hi = (torch.randint(-(1 << 31), 1 << 31, (N,), generator=gen,
                            dtype=torch.int64, device=card).to(torch.int32)
              for _ in range(2))
    j = torch.randperm(N, generator=gen, device=card)
    r = torch.randint(0, 1 << 16, (N,), generator=gen, device=card)
    first, second = j[:N // 3], j[N // 3:2 * N // 3]
    hi[first] = (first ^ r[:len(first)]).to(torch.int32)
    s2 = (second * probe.GOLD) & (N - 1)
    hi[s2] = (second ^ r[:len(second)]).to(torch.int32)
    return lo, hi


@pytest.mark.parametrize("Q", [8192, 32768, 1 << 20])
def test_kr_routes_match_plain(card, Q):
    """KR's eager and lazy routes, forced, over 2^25-slot planes (256
    MiB, beyond L2), at 1, 4 and 16 steps, against the plain version on
    the same card tensors; two_plane itself launches once, on its
    route."""
    N = 1 << 25
    lo, hi = _kr_planes(card, N, Q)
    idx = _probe_idx(np.random.default_rng(Q), Q, N).to(card)
    for steps in (1, 4, 16):
        want = probe.two_plane_plain(lo, hi, idx, steps)
        for route in (probe.EAGER, probe.LAZY):
            _eq(probe._two_plane_card(lo, hi, idx, steps, route), want)
        kernels.reset_launches()
        _eq(probe.two_plane(lo, hi, idx, steps), want)
        assert kernels.KR.launches == 1


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("C", [1, 17, 511, 513, 255 * 512 + 77,
                               3_000_001])
def test_kk_edges_match_plain(card, C, offset):
    """KK at odd row counts, one that leaves a block's warps part of a
    last round of tiles, and inputs that start 3 rows into their buffers
    (so that no tile aligns with the outputs: every row one a thread)."""
    rng = np.random.default_rng(C + offset)
    n = np.where(rng.random(C + offset) < 0.4, 1,
                 1 + rng.integers(0, 400, C + offset))
    first_high = rng.integers(0, 2, C + offset)
    n_high = np.minimum(n, first_high + rng.integers(0, 100, C + offset))
    fp = rng.random(C + offset) < 0.5
    cols = [torch.from_numpy(x).to(card)[offset:]
            for x in (n, n_high, first_high.astype(np.uint8), fp)]
    _eq(spec.finalize_counts(*cols), spec.finalize_counts_plain(*cols))


@pytest.mark.parametrize("k", [21, 51])
def test_ki_kj_kk_kl_match_plain(card, tmp_path, k):
    """The device finalize's kernels on a folded run: KJ (ret derived at
    k = 21, carried at 51), KI with arrivals from 0 and from 2^33 (equal
    to KF's verdicts), KK, and KL compared by lookups, also from shuffled
    keys and at load 0.4."""
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
        for b in (12, 35):   # blocks of over 1,000 rows; -b35
            _eq((spec.adjudicate_first_occurrence(ret, arr, b, H),),
                (spec.adjudicate_first_occurrence_plain(ret, arr, b, H),))
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
    # KL from shuffled keys, and at load 0.4 (c_bits forced below
    # table_c_bits' where qlow still fits, a seeded sample of the kept
    # keys filling 0.4 of the table) from sorted and shuffled keys, each
    # launching its five kernels
    rows = torch.nonzero(keep).flatten()
    n = len(rows)
    low = max(int(np.log2(n / 0.4)), 8, l_pre + kb_bits - 49)
    rng = np.random.default_rng(k)
    sample = np.sort(rng.choice(n, min(n, int(0.4 * (1 << low))),
                                replace=False))
    for cb, sel in ((c_bits, rng.permutation(n)), (low, sample),
                    (low, rng.permutation(sample))):
        sel = torch.from_numpy(sel).to(card)
        kernels.reset_launches()
        table, ok = spec.cuckoo_build(shard[sel], keybody[sel], kept[sel], k,
                                      l_pre, kb_bits, cb)
        assert ok and kernels.KL.launches == 5
        want = torch.full_like(got, -1)
        want[rows[sel]] = kept[sel].to(torch.int64)
        _eq((spec.cuckoo_lookup_plain(
            spec.SpecTable(table, k, l_pre, kb_bits, cb), run.shard,
            run.keybody),), (want,))


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


@pytest.mark.parametrize("R", [1, 2, 3, 4, 8, 256])
def test_km_matches_plain(card, spectrum, R):
    """KM by the prefix rule on a counting batch's KA rows, and by the
    Bloom-block rule on the same rows' ret; also on one row, on rows that
    end 5 into a tile, and with a tile of dropped rows."""
    opt, ds, b, q = spectrum
    k, l_pre = opt.k, opt.effective_l_pre()
    bases = torch.from_numpy(b[:2048]).to(card)
    qok = torch.from_numpy(q[:2048] >= 33 + opt.q).to(card)
    lens = torch.full((2048,), b.shape[1], dtype=torch.int32, device=card)
    rows = [t.view(-1) for t in kops.kmer_stream(bases, qok, lens, k, l_pre,
                                                 7, with_ret=True)]
    dropped = rows[0].clone()
    dropped[route.TILE:2 * route.TILE] = kops.INVALID_SHARD
    cases = [rows, [t[:1] for t in rows],
             [t[:2 * route.TILE + 5] for t in rows], [dropped] + rows[1:]]
    for cols in cases:
        for rule, param in ((route.PREFIX, l_pre), (route.BLOOM, 24)):
            args = (cols, R, rule, param)
            kw = dict(shard=cols[0], ret=cols[3])
            got = route.route_rows(*args, **kw)
            want = route.route_rows_plain(*args, **kw)
            assert got.counts == want.counts
            _eq(got.cols + [got.perm], want.cols + [want.perm])


def test_mesh_matches_single_device(card, tmp_path):
    """python -m bfc_tpu_torch.parallel.multihost on one NCCL rank and on
    two gloo ranks sharing the card: the same bytes as run_device."""
    import subprocess
    import sys
    from pathlib import Path

    b, q = _reads()
    fq = _write_fq(tmp_path / "reads.fq", b, q)
    args = ["-k23", "-b24", str(fq)]
    opt = Opts()
    opt.k = 23
    opt.bf_shift = 24
    want = TDP.run_device(opt, str(fq), device=card).encode()
    root = Path(__file__).resolve().parents[1]
    for n, backend in ((1, "nccl"), (2, "gloo")):
        r = subprocess.run(
            [sys.executable, "-m", "bfc_tpu_torch.parallel.multihost",
             "--launch", str(n), "--backend", backend, "--", *args],
            cwd=root, capture_output=True, check=True)
        assert r.stdout == want, backend


def _subtables(ds, db, card, kernel: bool, order: str = "sorted",
               load: str = "default"):
    """The spectrum's entries split by owner into 2^db sub-tables on the
    card, built by KN (kernel) or its plain version from each rank's
    keys in order or shuffled: (a ShardedTable, the entries built).  At
    load "0.4" cb_local is forced below subtable_bits' and each rank
    keeps a seeded sample of its keys, in order, filling 0.4 of a
    sub-table."""
    k, l_pre, kb_bits = ds.k, ds.l_pre, ds.kb_bits
    shard, keybody, payload = (torch.from_numpy(np.asarray(c).astype(
        np.int64)).to(card) for c in ds.compact_entries())
    payload = payload.to(torch.int32)
    owner = spec.subtable_owner(shard, keybody, l_pre, kb_bits, db)
    most = int(torch.bincount(owner).max())
    cb_local = TC.subtable_bits(most, k, l_pre, db)
    cap = None
    if load == "0.4":
        cb_local = max(int(np.log2(most / 0.4)), 8, l_pre + kb_bits - 49 - db)
        cap = int(0.4 * (1 << cb_local))
    rng = np.random.default_rng(db)
    built = torch.zeros_like(owner, dtype=torch.bool)
    subs = []
    for r in range(1 << db):
        idx = torch.nonzero(owner == r).flatten()
        if cap is not None and cap < len(idx):
            idx = idx[torch.from_numpy(np.sort(rng.choice(
                len(idx), cap, replace=False))).to(card)]
        built[idx] = True
        if order == "shuffled":
            idx = idx[torch.from_numpy(rng.permutation(len(idx))).to(card)]
        args = (shard[idx], keybody[idx], payload[idx], l_pre, kb_bits,
                db + cb_local, db)
        t, ok = (spec.cuckoo_build_local(*args) if kernel
                 else spec.cuckoo_build_local_plain(*args))
        assert ok, f"{'KN' if kernel else 'plain'}, rank {r} of {1 << db}"
        subs.append(t)
    return spec.sharded_table(subs, k, l_pre, kb_bits, db), built


@pytest.mark.parametrize("load", ["default", "0.4"])
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("db", [1, 3])
def test_kn_matches_plain(card, spectrum, db, order, load):
    """KN's sub-tables and its plain version's, from each rank's keys in
    order or shuffled, at subtable_bits' load or at 0.4, answer every
    entry built (others -1) and 100,000 seeded keys as the replicated
    table does; each KN call launches its five kernels."""
    opt, ds, b, q = spectrum
    kernels.reset_launches()
    got, built = _subtables(ds, db, card, True, order, load)
    assert kernels.KN.launches == 5 << db
    want_t, _ = _subtables(ds, db, card, False, order, load)
    shard, keybody, _ = (torch.from_numpy(np.asarray(c).astype(np.int64))
                         for c in ds.compact_entries())
    rng = np.random.default_rng(db)
    qs = torch.cat([shard, torch.from_numpy(rng.integers(
        0, 1 << ds.l_pre, 100_000))]).to(card)
    qk = torch.cat([keybody, torch.from_numpy(rng.integers(
        0, 1 << min(ds.kb_bits, 62), 100_000))]).to(card)
    want = spec.cuckoo_lookup_plain(ds.table, qs, qk)
    want[:len(shard)] = torch.where(built, want[:len(shard)], -1)
    for t in (got, want_t):
        _eq((spec.cuckoo_lookup_plain(t, qs, qk),), (want,))


@pytest.mark.parametrize("db", [1, 3])
def test_sharded_kc_kd_match_replicated(card, spectrum, db):
    """KC and KD reading R = 2^db sub-tables through the address array, in
    one process, against the replicated table and their plain versions."""
    opt, ds, b, q = spectrum
    t, _ = _subtables(ds, db, card, kernel=True)
    bases = torch.from_numpy(b[:256]).to(card)
    qf = torch.from_numpy(q[:256] >= 33 + opt.q).to(card)
    lens = torch.full((256,), b.shape[1], dtype=torch.int32, device=card)
    kc = ann.kcov_island(t, bases, lens, opt.min_cov)
    _eq(kc, ann.kcov_island(ds.table, bases, lens, opt.min_cov))
    _eq(kc, ann.kcov_island_plain(t, bases, lens, opt.min_cov))
    _, lcov, hcov, isl = kc
    kd = srch.ec1_search(t, opt, ds.mode, bases, qf, lens, lcov, hcov, isl)
    _eq(kd, srch.ec1_search(ds.table, opt, ds.mode, bases, qf, lens, lcov,
                            hcov, isl))
    _eq(kd, srch.ec1_search_plain(t, opt, ds.mode, bases, qf, lens, lcov,
                                  hcov, isl))
    assert int((kd[1][:, srch.N_EC] > 0).sum()) > 50


def test_sharded_mesh_matches_single_device(card, tmp_path):
    """BFC_TPU_SHARD_TABLE=1 over one NCCL rank and over two gloo ranks
    sharing the card, where each rank reads its peer's sub-table through
    an IPC mapping: the same bytes as run_device, and -r of its -d dump
    over the two ranks too."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    b, q = _reads()
    fq = _write_fq(tmp_path / "reads.fq", b, q)
    opt = Opts()
    opt.k = 23
    opt.bf_shift = 24
    want = TDP.run_device(opt, str(fq), device=card).encode()
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, BFC_TPU_SHARD_TABLE="1")
    dump = tmp_path / "s.dump"
    for n, backend, args in (
            (1, "nccl", ["-k23", "-b24", str(fq)]),
            (2, "gloo", ["-k23", "-b24", "-d", str(dump), str(fq)]),
            (2, "gloo", ["-r", str(dump), str(fq)])):
        r = subprocess.run(
            [sys.executable, "-m", "bfc_tpu_torch.parallel.multihost",
             "--launch", str(n), "--backend", backend, "--", *args],
            cwd=root, capture_output=True, check=True, env=env)
        assert r.stdout == want, (backend, args)
        assert f"sharded over {n} devices".encode() in r.stderr


@pytest.mark.parametrize("k", [21, 63])
def test_spilled_aggregate_on_card_matches_cpu(card, tmp_path, monkeypatch, k):
    """BFC_TPU_MAX_MERGE_CAP forced low: the card's tree spills (KE once a
    spilled span, on the counting thread) and its host aggregate equals the
    CPU's spilled and unspilled aggregates column by column."""
    b, q = _reads()
    fq = str(_write_fq(tmp_path / "reads.fq", b, q))
    opt = Opts()
    opt.k = k
    opt.bf_shift = 24
    monkeypatch.setenv("BFC_TPU_MAX_MERGE_CAP", str(1 << 15))
    kernels.reset_launches()
    got = TC.AggBuilder(opt, card)
    for bases, qok, lens, _ in TC.padded_batches(fq, opt, 256):
        got.add(bases, qok, lens)
    ha = got.finish()
    assert got.spills >= 1
    assert kernels.KERNELS["pack_pull"].launches == got.spills
    cpu, _ = TC.count_batches_aggregate(fq, opt, "cpu", batch_reads=256)
    monkeypatch.delenv("BFC_TPU_MAX_MERGE_CAP")
    plain, _ = TC.count_batches_aggregate(fq, opt, "cpu", batch_reads=256)
    for f in ("shard", "keybody", "ret", "n", "n_high", "first_arr",
              "first_high"):
        np.testing.assert_array_equal(getattr(ha, f), getattr(cpu, f), f)
        np.testing.assert_array_equal(getattr(ha, f), getattr(plain, f), f)
