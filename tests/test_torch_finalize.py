"""The device finalize of bfc_tpu_torch (BFC_TPU_DEVICE_FINALIZE=1: KJ, the
verdict KF or KI, KK and KL, here their plain versions on the CPU) against
bfc_tpu's device finalize on JAX-CPU.

bfc_tpu's AggBuilder returns its device aggregate (spec.Aggregate) under
BFC_TPU_DEVICE_FINALIZE=1, and its finalize_spectrum(..., host=False)
finalizes it; the port's AggBuilder returns its folded Run on the device.
Both count one tests/datagen.py dataset (a 12 kb genome, 1,500 reads of
100 bp, 1% errors) once per k, shared by the Bloom sizes.  Every output is
an integer: the tolerance is exact equality throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bfc_tpu.models import counter as JC
from bfc_tpu.ops import spectrum as jspec
from bfc_tpu.opts import Opts as JOpts
from bfc_tpu_torch.models import counter as TC
from bfc_tpu_torch.ops import kmer as tk
from bfc_tpu_torch.ops import spectrum as tspec
from bfc_tpu_torch.ops import spectrum_dense as tsdn
from bfc_tpu_torch.opts import Opts

from . import datagen


def _opts(cls, k, bf_shift):
    o = cls()
    o.k = k
    o.bf_shift = bf_shift
    return o


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the plain versions' many small ops only lose
    to thread start-up, most of all beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_finalize")
    genome = datagen.make_genome(12000, seed=91)
    reads = datagen.simulate_reads(genome, 1500, read_len=100,
                                   err_rate=0.01, seed=92)
    fq = f"{d}/reads.fq"
    datagen.write_fastq(fq, reads)
    return fq


@pytest.fixture(scope="module", params=[21, 33, 51])
def counted(request, fastq):
    """bfc_tpu's device aggregate and the port's folded Run at k (ret is
    carried at k = 51 and derived by KJ at 21 and 33)."""
    k = request.param
    mp = pytest.MonkeyPatch()
    mp.setenv("BFC_TPU_DEVICE_FINALIZE", "1")
    try:
        jagg, jn = JC.count_batches_aggregate(fastq, _opts(JOpts, k, 24),
                                              batch_reads=512)
    finally:
        mp.undo()
    assert isinstance(jagg, jspec.Aggregate) and jn == 1500
    run, tn = TC.count_batches_aggregate(fastq, _opts(Opts, k, 24), "cpu",
                                         batch_reads=512,
                                         device_finalize=True)
    assert isinstance(run, tsdn.Run) and tn == 1500
    assert (run.ret is None) == (k != 51)
    return k, jagg, run


def _absent_keys(shard, keybody, l_pre, kb_bits, n=2000, seed=5):
    """n seeded (shard, keybody) identities that are not entries."""
    rng = np.random.default_rng(seed)
    have = set(zip(shard.tolist(), keybody.tolist()))
    qs = rng.integers(0, 1 << l_pre, 2 * n).astype(np.uint32)
    qk = rng.integers(0, 1 << kb_bits, 2 * n, dtype=np.uint64)
    new = [i for i, key in enumerate(zip(qs.tolist(), qk.tolist()))
           if key not in have][:n]
    assert len(new) == n
    return qs[new], qk[new]


@pytest.mark.parametrize("bf_shift", [20, 24])
def test_device_finalize_matches_jax(counted, bf_shift):
    k, jagg, run = counted
    jo, to = _opts(JOpts, k, bf_shift), _opts(Opts, k, bf_shift)
    jds = JC.finalize_spectrum(jagg, jo, host=False)
    tds = TC.finalize_spectrum(run, to, "cpu")
    assert tds.verdict == "KF"
    shard, keybody, payload = tds.compact_entries()
    for got, want in zip((shard, keybody, payload), jds.compact_entries()):
        np.testing.assert_array_equal(got, want)
    assert tds.n_entries == jds.n_entries == len(shard)
    np.testing.assert_array_equal(tds.hist, jds.hist)
    np.testing.assert_array_equal(tds.hist_high, jds.hist_high)
    assert tds.mode == jds.mode > 0
    # the table: every kept entry gives its payload, every absent key -1
    l_pre, t = to.effective_l_pre(), tds.table
    a_shard, a_kb = _absent_keys(shard, keybody, l_pre, t.kb_bits)
    q_shard = np.concatenate([shard, a_shard])
    q_kb = np.concatenate([keybody, a_kb])
    got = tspec.cuckoo_lookup_plain(
        t, torch.from_numpy(q_shard.astype(np.int64)),
        torch.from_numpy(q_kb.view(np.int64))).numpy()
    np.testing.assert_array_equal(got[:len(shard)], payload)
    assert (got[len(shard):] == -1).all()
    if isinstance(jds.table, jspec.CuckooTable):
        want = np.asarray(jspec.cuckoo_lookup(
            jds.table, jnp.asarray(q_shard), jnp.asarray(q_kb), jds.s_bits,
            l_pre, t.kb_bits))
        np.testing.assert_array_equal(got, want)
    else:  # bfc_tpu's displacement layout (k > 32 at small tables)
        assert k > 32


def test_device_finalize_of_a_host_aggregate(counted):
    """finalize_spectrum(host=False) takes a HostAgg to the device and
    gives the host finalize's spectrum."""
    k, _, run = counted
    to = _opts(Opts, k, 20)
    l_pre = to.effective_l_pre()
    ha = tsdn.run_to_host_agg(*TC.pull_columns(run), k, l_pre)
    host = TC.finalize_spectrum(ha, to, "cpu", host=True)
    dev = TC.finalize_spectrum(ha, to, "cpu", host=False)
    assert host.verdict == "host sort" and dev.verdict == "KF"
    for a, b in zip(dev.compact_entries(), host.compact_entries()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(dev.hist, host.hist)
    np.testing.assert_array_equal(dev.hist_high, host.hist_high)
    assert dev.c_bits == host.c_bits
    with pytest.raises(ValueError):
        TC.finalize_spectrum(run, to, "cpu", host=True)


def test_finalize_counts_matches_jax():
    """KK's plain version against bfc_tpu's finalize_counts_fp on seeded
    rows past both caps (count 255, high 63), with rows dropped (n = 1,
    no Bloom hit) and padding rows on bfc_tpu's side."""
    rng = np.random.default_rng(3)
    C = 5000
    n = rng.integers(1, 400, C).astype(np.uint32)
    n[: C // 3] = 1
    n_high = (rng.random(C) * (n + 1)).astype(np.uint32)
    first_high = ((rng.random(C) < 0.7) & (n_high > 0)).astype(np.uint32)
    fp = rng.random(C) < 0.2
    got = tspec.finalize_counts(
        torch.from_numpy(n.astype(np.int64)),
        torch.from_numpy(n_high.astype(np.int64)),
        torch.from_numpy(first_high.astype(np.uint8)), torch.from_numpy(fp))
    pad = 1000
    shard = np.concatenate([np.zeros(C, np.uint32),
                            np.full(pad, 0xFFFFFFFF, np.uint32)])

    def padded(x):
        return jnp.asarray(np.concatenate([x, np.ones(pad, x.dtype)]))

    agg = jspec.Aggregate(
        shard=jnp.asarray(shard), keybody=padded(np.zeros(C, np.uint64)),
        ret=padded(np.zeros(C, np.uint64)), n=padded(n),
        n_high=padded(n_high), first_arr=padded(np.zeros(C, np.uint64)),
        first_high=padded(first_high))
    _, _, payload, keep, hist, hist_high = jspec.finalize_counts_fp(
        agg, padded(fp))
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(payload)[:C].astype(np.int32))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(keep)[:C])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(hist))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(hist_high))
    kept = got[1].numpy()
    assert 0 < kept.sum() < C and got[3][0] > 0
    assert (got[0].numpy()[kept] & 255).max() == 255
    assert (got[0].numpy()[kept] >> 8).max() == 63


def _entries(k, n, seed):
    """n distinct seeded identities at k and non-zero payloads."""
    o = Opts()
    o.k = k
    l_pre = o.effective_l_pre()
    kb_bits = tk.keybody_bits(k, l_pre)
    rng = np.random.default_rng(seed)
    shard = rng.integers(0, 1 << l_pre, n).astype(np.int64)
    keybody = rng.integers(0, 1 << kb_bits, n, dtype=np.uint64).view(np.int64)
    _, first = np.unique(np.stack([shard, keybody], 1), axis=0,
                         return_index=True)
    first = np.sort(first)
    payload = rng.integers(1, 1 << 14, n).astype(np.int32)
    return (torch.from_numpy(shard[first]), torch.from_numpy(keybody[first]),
            torch.from_numpy(payload[first]), l_pre, kb_bits)


@pytest.mark.parametrize("k", [21, 33])
def test_cuckoo_build_matches_jax(k):
    """KL's plain version is cuckoo_build_device's walk: the same table,
    entry for entry (rows of payload 0 skipped), and every key found."""
    shard, keybody, payload, l_pre, kb_bits = _entries(k, 3000, k)
    payload[::7] = 0
    c_bits = max(13, l_pre + kb_bits - 49)
    table, ok = tspec.cuckoo_build(shard, keybody, payload, k, l_pre,
                                   kb_bits, c_bits)
    assert ok
    if c_bits <= 31:
        lo, hi, jok = jspec.cuckoo_build_device(
            jnp.asarray(shard.numpy().astype(np.uint32)),
            jnp.asarray(keybody.numpy().view(np.uint64)),
            jnp.asarray(payload.numpy().astype(np.uint32)), c_bits, l_pre,
            kb_bits)
        assert bool(jok)
        want = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) \
            | np.asarray(lo)
        np.testing.assert_array_equal(table.numpy().view(np.uint64), want)
    t = tspec.SpecTable(table, k, l_pre, kb_bits, c_bits)
    got = tspec.cuckoo_lookup_plain(t, shard, keybody)
    present = payload != 0
    torch.testing.assert_close(got[present], payload[present].to(torch.int64),
                               rtol=0, atol=0)
    assert (got[~present] == -1).all()


def test_cuckoo_build_reports_a_full_table():
    shard, keybody, payload, l_pre, kb_bits = _entries(21, 600, 9)
    _, ok = tspec.cuckoo_build(shard, keybody, payload, 21, l_pre, kb_bits, 9)
    assert not ok  # 600 keys cannot fit 512 slots


def test_device_finalize_with_arrivals_past_2_32(fastq, monkeypatch):
    """The main path's count with arrivals from 2^33 takes KI and gives the
    same spectrum as the count from 0 (KF)."""
    to = _opts(Opts, 21, 20)
    want = TC.count_file_device(fastq, to, "cpu", batch_reads=512,
                                device_finalize=True)
    init = TC.AggBuilder.__init__

    def shifted(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.arrival_base = 1 << 33

    monkeypatch.setattr(TC.AggBuilder, "__init__", shifted)
    got = TC.count_file_device(fastq, to, "cpu", batch_reads=512,
                               device_finalize=True)
    assert (want.verdict, got.verdict) == ("KF", "KI")
    for a, b in zip(got.compact_entries(), want.compact_entries()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.hist, want.hist)
    np.testing.assert_array_equal(got.hist_high, want.hist_high)
