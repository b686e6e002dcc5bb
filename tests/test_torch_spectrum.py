"""Counting runs, merges, the packed pull (KE), the aggregate, finalize,
the Bloom first-occurrence verdicts (KF, KI), derive_ret (KJ) and the
cuckoo probe of bfc_tpu_torch against bfc_tpu on JAX-CPU.

Inputs come from tests/datagen.py (a 12 kb genome, 100 bp reads, 1%
errors) and from seeded numpy batches.  Every output is an integer, so
the tolerance is exact equality throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bfc_tpu.models import counter as JC
from bfc_tpu.models import trimmer as JT
from bfc_tpu.ops import spectrum as jspec
from bfc_tpu.ops import spectrum_dense as jsdn
from bfc_tpu.opts import Opts as JOpts
from bfc_tpu_torch.models import counter as TC
from bfc_tpu_torch.ops import kmer as tk
from bfc_tpu_torch.ops import spectrum as tspec
from bfc_tpu_torch.ops import spectrum_dense as tsdn
from bfc_tpu_torch.ops import spectrum_host as tsph
from bfc_tpu_torch.opts import Opts

from . import datagen


def _opts(cls, k, bf_shift=24):
    o = cls()
    o.k = k
    o.bf_shift = bf_shift
    return o


def _batch(seed, B=64, L=128, lo=60):
    rng = np.random.default_rng(seed)
    genome = np.random.default_rng(0).integers(0, 4, 3000)
    starts = rng.integers(0, 3000 - L, B)
    bases = genome[starts[:, None] + np.arange(L)[None, :]].astype(np.uint8)
    err = rng.random((B, L)) < 0.02
    bases = np.where(err, (bases + 1) % 4, bases).astype(np.uint8)
    bases[rng.random((B, L)) < 0.005] = 4
    lens = rng.integers(lo, L + 1, B).astype(np.int32)
    qok = rng.random((B, L)) < 0.9
    return bases, qok, lens


def _jax_run(planes, count, k, l_pre):
    return jsdn.run_to_host_agg([np.asarray(p) for p in planes], int(count),
                                k, l_pre)


def _assert_run_equal(run, ha, carry):
    np.testing.assert_array_equal(run.shard.numpy(), ha.shard.astype(np.int64))
    np.testing.assert_array_equal(run.keybody.numpy().view(np.uint64), ha.keybody)
    np.testing.assert_array_equal(run.arr.numpy().view(np.uint64), ha.first_arr)
    np.testing.assert_array_equal(run.n.numpy(), ha.n.astype(np.int64))
    np.testing.assert_array_equal(run.n_high.numpy(), ha.n_high.astype(np.int64))
    np.testing.assert_array_equal(run.first_high.numpy(), ha.first_high)
    if carry:
        np.testing.assert_array_equal(run.ret.numpy().view(np.uint64), ha.ret)


def _torch(*a):
    return tuple(torch.from_numpy(x) for x in a)


@pytest.mark.parametrize("k", [21, 33, 63])
def test_chunk_run_and_merge_match_jax(k):
    l_pre = _opts(JOpts, k).effective_l_pre()
    n_id, _, carry = jsdn.run_layout(k, l_pre)
    assert carry == (not tsdn.ret_derivable(k, l_pre))
    b1, q1, n1 = _batch(1)
    b2, q2, n2 = _batch(2)
    B, L = b1.shape
    pa, ca = jsdn.chunk_run(b1, q1, n1, jnp.uint64(0), k, l_pre)
    pb, cb = jsdn.chunk_run(b2, q2, n2, jnp.uint64(B * L), k, l_pre)
    ra = tsdn.chunk_run(*_torch(b1, q1, n1), 0, k, l_pre, carry)
    rb = tsdn.chunk_run(*_torch(b2, q2, n2), B * L, k, l_pre, carry)
    _assert_run_equal(ra, _jax_run(pa, ca, k, l_pre), carry)
    _assert_run_equal(rb, _jax_run(pb, cb, k, l_pre), carry)
    pm, cm = jsdn.merge_runs_sorted(list(pa), list(pb), n_id)
    rm = tsdn.merge_runs(ra, rb)
    assert len(rm) < len(ra) + len(rb)  # the batches share k-mers
    _assert_run_equal(rm, _jax_run(pm, cm, k, l_pre), carry)


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_spectrum")
    genome = datagen.make_genome(12000, seed=51)
    reads = datagen.simulate_reads(genome, 1500, read_len=100,
                                   err_rate=0.01, seed=52)
    fq = f"{d}/reads.fq"
    datagen.write_fastq(fq, reads)
    return fq


@pytest.fixture(scope="module", params=[21, 33])
def jax_counted(request, fastq):
    """bfc_tpu's aggregate and finalized spectrum of the dataset at k."""
    jo = _opts(JOpts, request.param)
    jagg, jn = JC.count_batches_aggregate(fastq, jo, batch_reads=512)
    assert jn == 1500
    return jo, jagg, JC.finalize_spectrum(jagg, jo)


def test_aggregate_and_finalize_match_jax(fastq, jax_counted):
    jo, jagg, jds = jax_counted
    to = _opts(Opts, jo.k)
    tagg, tn = TC.count_batches_aggregate(fastq, to, "cpu", batch_reads=512)
    assert tn == 1500
    for f in ("shard", "keybody", "first_arr", "first_high", "ret"):
        np.testing.assert_array_equal(getattr(tagg, f), getattr(jagg, f), f)
    # bfc_tpu's packed pull saturates n at 511 and n_high at 127
    np.testing.assert_array_equal(np.minimum(tagg.n, 511), jagg.n)
    np.testing.assert_array_equal(np.minimum(tagg.n_high, 127), jagg.n_high)
    tds = TC.finalize_spectrum(tagg, to, "cpu")
    for a, b in zip(tds.compact_entries(), jds.compact_entries()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tds.hist, jds.hist)
    np.testing.assert_array_equal(tds.hist_high, jds.hist_high)
    assert tds.mode == jds.mode and tds.mode > 0


def test_cuckoo_probe_matches_jax(jax_counted):
    jo, _, jds = jax_counted
    k = jo.k
    shard, keybody, payload = jds.compact_entries()
    l_pre = jo.effective_l_pre()
    tds = TC.spectrum_from_compact(shard, keybody, payload, k, l_pre, "cpu")
    t = tds.table
    assert l_pre + t.kb_bits - t.c_bits <= 49  # qlow fits the entry
    rng = np.random.default_rng(7)
    n_abs = 2000
    q_shard = np.concatenate([shard, rng.integers(0, 1 << l_pre, n_abs)]).astype(np.uint32)
    q_kb = np.concatenate([keybody, rng.integers(0, 1 << t.kb_bits, n_abs,
                                                 dtype=np.uint64)]).astype(np.uint64)
    jtab = jspec.cuckoo_from_u64(t.table.numpy().view(np.uint64))
    want = np.asarray(jspec.cuckoo_lookup(jtab, jnp.asarray(q_shard),
                                          jnp.asarray(q_kb), t.c_bits,
                                          l_pre, t.kb_bits))
    got = tspec.cuckoo_lookup_plain(t, torch.from_numpy(q_shard.astype(np.int64)),
                                    torch.from_numpy(q_kb.view(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:len(shard)], payload)
    assert (got[len(shard):] == -1).mean() > 0.99
    probe = tspec.IntProbe(t)
    for i in range(0, len(q_shard), 97):
        assert probe.get_identity(int(q_shard[i]), int(q_kb[i])) == got[i]


@pytest.mark.parametrize("c_bits", [12, 25, 32, 33, 40])
def test_cuckoo_alt_matches_jax(c_bits):
    rng = np.random.default_rng(c_bits)
    q = rng.integers(0, 1 << 49, 4096, dtype=np.uint64)
    want = np.asarray(jspec.cuckoo_alt_u64(jnp.asarray(q), c_bits))
    got = tspec.cuckoo_alt(torch.from_numpy(q.view(np.int64)), c_bits).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), want)
    np.testing.assert_array_equal(tspec.cuckoo_alt_np(q, c_bits), want)


def _u32_planes(x):
    return (x >> np.uint64(32)).astype(np.uint32), x.astype(np.uint32)


@pytest.mark.parametrize("k", [21, 51])
def test_pack_pull_matches_jax(k):
    """KE's plain version and its host twin against bfc_tpu's pack_pull and
    packed_run_to_host_agg, field for field, on rows with n > 511,
    n_high > 127 and arrivals past 2^32; ret is carried at k = 51 and
    derived at k = 21."""
    l_pre = _opts(JOpts, k).effective_l_pre()
    n_id, _, carry = jsdn.run_layout(k, l_pre)
    kb_bits = tk.keybody_bits(k, l_pre)
    rng = np.random.default_rng(k)
    C = 4000
    shard = rng.integers(0, 1 << l_pre, C).astype(np.uint32)
    keybody = rng.integers(0, 1 << kb_bits, C, dtype=np.uint64)
    arr = rng.integers(0, 1 << 46, C, dtype=np.uint64)
    arr[: C // 2] &= np.uint64(0xFFFFFFFF)
    n = rng.integers(1, 1500, C).astype(np.uint32)
    n[: C // 4] = 1
    n_high = (rng.random(C) * (n + 1)).astype(np.uint32)
    first_high = (rng.random(C) < 0.7).astype(np.uint32) & (n_high > 0)
    ret = rng.integers(0, 1 << 64, C, dtype=np.uint64) if carry else None
    assert (n > 511).any() and (n_high > 127).any()
    kb = list(_u32_planes(keybody)) if kb_bits > 32 else [keybody.astype(np.uint32)]
    planes = ([shard] + kb + list(_u32_planes(arr))
              + [n, n_high | (first_high << np.uint32(31))]
              + (list(_u32_planes(ret)) if carry else []))
    jp = jsdn.pack_pull(tuple(jnp.asarray(p) for p in planes), n_id=n_id)
    want = jsdn.packed_run_to_host_agg([np.asarray(p) for p in jp], C, k,
                                       l_pre)
    run = tsdn.Run(*(torch.from_numpy(x) for x in (
        shard.astype(np.int64), keybody.view(np.int64), arr.view(np.int64),
        n.astype(np.int64), n_high.astype(np.int64),
        first_high.astype(np.uint8))),
        None if ret is None else torch.from_numpy(ret.view(np.int64)))
    pk = tsdn.pack_pull(run)
    got = tsdn.packed_run_to_host_agg(
        *(None if f is None else f.numpy() for f in pk), k, l_pre)
    for f in ("shard", "keybody", "n", "n_high", "first_arr", "first_high"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    want_ret = want.ret if carry else tsdn.derive_ret_np(shard, keybody, k, l_pre)
    np.testing.assert_array_equal(got.ret, want_ret)
    assert got.n.max() == 511 and got.n_high.max() == 127
    assert (got.first_arr >> np.uint64(32)).max() > 0


@pytest.mark.parametrize("bf_shift", [20, 24, 33])
def test_bloom_adjudicate_matches_jax(fastq, bf_shift):
    """KF's plain version (a sort) against bfc_tpu's adjudicate_sketch,
    adjudicate_first_occurrence and filter_keep_rets on a counted
    aggregate, and against the host adjudicate_np.  At -b33 bfc_tpu's
    sketch needs a 32 GiB array and casts bit ids to u32, so only the host
    sort is compared there."""
    jo = _opts(JOpts, 21, bf_shift)
    jagg, _ = JC.count_batches_aggregate(fastq, jo, batch_reads=512)
    C = len(jagg.shard)
    fp, keep = tspec.adjudicate_sketch(
        torch.from_numpy(jagg.ret.view(np.int64)),
        torch.from_numpy(jagg.first_arr.astype(np.uint32).view(np.int32)),
        torch.from_numpy(jagg.n.astype(np.int32)), bf_shift, jo.n_hashes)
    fp, keep = fp.numpy(), keep.numpy()
    want = tsph.adjudicate_np(jagg.ret, jagg.first_arr, np.ones(C, bool),
                              bf_shift, jo.n_hashes)
    np.testing.assert_array_equal(fp, want)
    np.testing.assert_array_equal(keep, (jagg.n >= 2) | fp)
    if bf_shift <= 24:
        agg = jspec.Aggregate(*(jnp.asarray(getattr(jagg, f)) for f in
                                jspec.Aggregate._fields))
        for fn in (jspec.adjudicate_sketch, jspec.adjudicate_first_occurrence):
            np.testing.assert_array_equal(
                fp, np.asarray(fn(agg, bf_shift, jo.n_hashes)))
        _, jkeep = JT.filter_keep_rets(agg, bf_shift, jo.n_hashes, sketch=True)
        np.testing.assert_array_equal(keep, np.asarray(jkeep))
    if bf_shift == 20:
        assert 0 < int(fp.sum()) and int((fp & (jagg.n == 1)).sum()) > 0


@pytest.mark.parametrize("bf_shift", [20, 24, 33])
def test_first_occurrence_matches_jax(fastq, bf_shift):
    """KI's plain version on 64-bit arrivals against bfc_tpu's
    adjudicate_first_occurrence and the host adjudicate_np (only the host
    sort at -b33, as above), then with every arrival shifted by 2^33,
    which keeps their order: the verdicts must not change, and
    spec.adjudicate must take KI there and KF below 2^32."""
    jo = _opts(JOpts, 21, bf_shift)
    jagg, _ = JC.count_batches_aggregate(fastq, jo, batch_reads=512)
    C = len(jagg.shard)
    ret = torch.from_numpy(jagg.ret.view(np.int64))
    arr = torch.from_numpy(jagg.first_arr.view(np.int64))
    n = torch.from_numpy(jagg.n.astype(np.int64))
    fp = tspec.adjudicate_first_occurrence(ret, arr, bf_shift, jo.n_hashes)
    want = tsph.adjudicate_np(jagg.ret, jagg.first_arr, np.ones(C, bool),
                              bf_shift, jo.n_hashes)
    np.testing.assert_array_equal(fp.numpy(), want)
    if bf_shift <= 24:
        agg = jspec.Aggregate(*(jnp.asarray(getattr(jagg, f)) for f in
                                jspec.Aggregate._fields))
        np.testing.assert_array_equal(fp.numpy(), np.asarray(
            jspec.adjudicate_first_occurrence(agg, bf_shift, jo.n_hashes)))
    shifted = arr + (1 << 33)
    torch.testing.assert_close(
        tspec.adjudicate_first_occurrence(ret, shifted, bf_shift, jo.n_hashes),
        fp, rtol=0, atol=0)
    keep = (n >= 2) | fp
    for a, by in ((arr, "KF"), (shifted, "KI")):
        v = tspec.adjudicate(ret, a, n, bf_shift, jo.n_hashes)
        assert v.by == by
        torch.testing.assert_close(v.fp, fp, rtol=0, atol=0)
        torch.testing.assert_close(v.keep, keep, rtol=0, atol=0)


def test_first_occurrence_ties_do_not_see_each_other():
    """Rows of one arrival (which a stream never has, each first occurrence
    owning its slot) are judged against earlier arrivals only, as the sort
    formulation does."""
    ret = torch.tensor([5, 5, 5], dtype=torch.int64)
    fp = tspec.adjudicate_first_occurrence(
        ret, torch.tensor([7, 7, 9]), 20, 4)
    assert fp.tolist() == [False, False, True]


@pytest.mark.parametrize("k", [21, 32, 33])
def test_derive_ret_matches_jax(k):
    """KJ's plain version against bfc_tpu's derive_ret_device and
    derive_ret_np on seeded identities at every derivable width."""
    l_pre = _opts(Opts, k).effective_l_pre()
    kb_bits = tk.keybody_bits(k, l_pre)
    rng = np.random.default_rng(k)
    shard = rng.integers(0, 1 << l_pre, 4000).astype(np.uint32)
    keybody = rng.integers(0, 1 << kb_bits, 4000, dtype=np.uint64)
    want = np.asarray(jsdn.derive_ret_device(jnp.asarray(shard),
                                             jnp.asarray(keybody), k, l_pre))
    np.testing.assert_array_equal(tsdn.derive_ret_np(shard, keybody, k, l_pre),
                                  want)
    got = tsdn.derive_ret(torch.from_numpy(shard.astype(np.int64)),
                          torch.from_numpy(keybody.view(np.int64)), k, l_pre)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    assert (want >> np.uint64(63)).any() == (k >= 32)


_NEED = tspec.verdict_bytes(1000, 24, "KF")  # 13 a row, 4 a superblock
_NEED_KI = tspec.verdict_bytes(1000, 24, "KI")  # 21 a row
_FOLD = 63_109_113                         # the 3M-read -b33 trim fold


@pytest.mark.parametrize("arr_max,rows,bf_shift,free,want", [
    (10, 1000, 24, None, "KF"),                  # the CPU: no limit
    (10, 1000, 24, _NEED, "KF"),                 # exactly enough scratch
    (10, 1000, 24, _NEED - 1, None),             # one byte short: raises
    (10, _FOLD, 35, 80 * 10**9, "KF"),           # -b35 on an 80 GB card
    (10, _FOLD, 37, 80 * 10**9, "KF"),           # -s 3g sets -b37
    (10, _FOLD, 33, 80 * 10**9, "KF"),           # ~0.82 GB at -b33
    (tspec.ARRIVAL_LIMIT, 1000, 24, None, "KI"),  # arrivals past 2^32 - 1
    (tspec.ARRIVAL_LIMIT - 1, 1000, 24, None, "KF"),
    (tspec.ARRIVAL_LIMIT, 1000, 24, _NEED_KI - 1, None),  # KI one byte short
])
def test_verdict_route(arr_max, rows, bf_shift, free, want):
    """KF below 2^32 - 1 arrivals, KI from there; each needs its
    verdict_bytes, and a card without them free raises (no fallback to
    the other kernel or the plain version)."""
    by = "KF" if arr_max < tspec.ARRIVAL_LIMIT else "KI"
    if want is None:
        need = _NEED if by == "KF" else _NEED_KI
        with pytest.raises(RuntimeError, match=f"needs {need} bytes"):
            tspec.verdict_route(arr_max, rows, bf_shift, free)
    else:
        assert tspec.verdict_route(arr_max, rows, bf_shift, free) == want
    # superblocks of 2^S blocks: the most, up to 2^8, that keep 1,024
    # rows or fewer a superblock on average
    x = bf_shift - 9
    S = min(8, x, ((1024 << x) // rows).bit_length() - 1)
    assert tspec.verdict_shift(rows, bf_shift) == S
    n_super = 2 ** (x - S)
    # a record (8 bytes for KF, 16 for KI), a slot and a verdict byte a
    # row; a word a superblock and a scan tile
    assert tspec.verdict_bytes(rows, bf_shift, by) == (
        (13 if by == "KF" else 21) * rows + 4 * n_super
        + 4 * -(-n_super // 2048))
