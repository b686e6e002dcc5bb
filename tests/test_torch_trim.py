"""The trim mode's pieces of bfc_tpu_torch against bfc_tpu on JAX-CPU: the
Bloom probe addressing, the Bloom build (KG's plain version), the
longest-streak scan (KH's plain version) and the trimmer's verdicts.

Inputs are seeded numpy arrays and a tests/datagen.py dataset (a 12 kb
genome, 1,500 reads of 100 bp, 1% errors).  Every output is an integer,
so the tolerance is exact equality throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bfc_tpu.models import counter as JC
from bfc_tpu.models import trimmer as JT
from bfc_tpu.ops import spectrum as jspec
from bfc_tpu.opts import Opts as JOpts
from bfc_tpu_torch.models import counter as TC
from bfc_tpu_torch.models import refmodel as M
from bfc_tpu_torch.models import trimmer as TT
from bfc_tpu_torch.ops import kmer as tk
from bfc_tpu_torch.ops import spectrum as tspec
from bfc_tpu_torch.ops import spectrum_host as tsph
from bfc_tpu_torch.opts import Opts

from . import datagen


def probe_rets(bf_shift, n=4096, seed=0):
    """Seeded u64 hashes: half with bit 63 set, an eighth with h2 & 31 == 0
    (the stride bump) and an eighth starting inside byte 0 of the block
    (the skip walk)."""
    rng = np.random.default_rng(seed + bf_shift)
    ret = rng.integers(0, 1 << 63, n, dtype=np.uint64)
    ret[: n // 2] |= np.uint64(1 << 63)
    x = bf_shift - 9
    bump = rng.random(n) < 0.125
    ret[bump] &= ~np.uint64(31 << bf_shift)
    skip = rng.random(n) < 0.125
    ret[skip] &= ~np.uint64(511 << x)
    ret[skip] |= (rng.integers(0, 8, int(skip.sum())).astype(np.uint64)
                  << np.uint64(x))
    return ret


@pytest.mark.parametrize("n_hashes", [1, 4, 7])
@pytest.mark.parametrize("bf_shift", [20, 24, 33, 37])
def test_bloom_probe_bits_match_jax_and_numpy(bf_shift, n_hashes):
    ret = probe_rets(bf_shift)
    want = np.asarray(jspec.bloom_probe_bits(jnp.asarray(ret), bf_shift,
                                             n_hashes))
    got = tspec.bloom_probe_bits(torch.from_numpy(ret.view(np.int64)),
                                 bf_shift, n_hashes).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tsph.bloom_probe_bits_np(ret, bf_shift, n_hashes), want)
    assert (got >> np.uint64(bf_shift)).max() == 0
    assert ((got & np.uint64(511)) >= 8).all()
    # per hash, the scalar spec's (block, offsets)
    for i in range(0, len(ret), 257):
        block, offs = M.bloom_probes(bf_shift, n_hashes, int(ret[i]))
        assert [int(b) for b in got[i]] == [(block << 9) | z for z in offs]


def set_bits(words: np.ndarray) -> np.ndarray:
    """Sorted ids of the set bits of u32 words."""
    return np.flatnonzero(np.unpackbits(
        np.ascontiguousarray(words).view(np.uint8), bitorder="little"))


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_trim")
    genome = datagen.make_genome(12000, seed=81)
    reads = datagen.simulate_reads(genome, 1500, read_len=100,
                                   err_rate=0.01, seed=82)
    fq = f"{d}/reads.fq"
    datagen.write_fastq(fq, reads)
    return fq, genome, reads


@pytest.fixture(scope="module", params=[21, 51])
def counted(request, fastq):
    """The port's trim aggregate of the dataset at k, -b24, and its keep
    set (KF's plain version)."""
    fq, genome, reads = fastq
    opt = Opts()
    opt.k = request.param
    opt.bf_shift = 24
    agg, _ = TC.count_batches_aggregate(fq, opt, "cpu", batch_reads=512)
    ret = torch.from_numpy(agg.ret.view(np.int64))
    arr = torch.from_numpy(agg.first_arr.astype(np.uint32).view(np.int32))
    n = torch.from_numpy(agg.n.astype(np.int32))
    _, keep = tspec.adjudicate_sketch(ret, arr, n, opt.bf_shift,
                                      opt.n_hashes)
    return opt, ret, keep, genome, reads


def test_bloom_build_matches_jax(counted):
    opt, ret, keep, _, _ = counted
    assert 0 < int(keep.sum()) < len(keep)
    want = np.asarray(JT._bloom_build(jnp.asarray(ret.numpy().view(np.uint64)),
                                      jnp.asarray(keep.numpy()), opt.bf_shift,
                                      opt.n_hashes))
    got = TT.bloom_build(ret, keep, opt.bf_shift, opt.n_hashes)
    np.testing.assert_array_equal(set_bits(got.numpy()), set_bits(want))
    assert TT.popcount(got) == len(set_bits(want))


def trim_reads(genome, reads, k):
    """The dataset's first reads plus edge cases: N bases, shorter than k,
    empty, and one read holding two equal streaks split by an N."""
    seg = genome[1000:1000 + k + 9]
    g = genome[200:300]
    extra = [seg + "N" + seg, "ACGTN" * 3, genome[50:50 + k - 1], "",
             g[:40] + "N" + g[41:]]
    return [s for s, _ in reads[:200]] + extra


def test_max_streak_matches_jax_and_refmodel(counted):
    opt, ret, keep, genome, reads = counted
    k = opt.k
    bloom = TT.DeviceBloom.from_rets(ret, keep, opt.bf_shift, opt.n_hashes)
    seqs = trim_reads(genome, reads, k)
    bases, _, lens = tk.encode_batch(seqs, None, opt.q, pad_to=128)
    got = TT.max_streak_batch(bloom.words, torch.from_numpy(bases),
                              torch.from_numpy(lens), k, opt.bf_shift,
                              opt.n_hashes).numpy()
    jwords = jnp.asarray(bloom.words.numpy().view(np.uint32))
    want = np.asarray(JT.max_streak_batch(jwords, jnp.asarray(bases),
                                          jnp.asarray(lens), k, opt.bf_shift,
                                          opt.n_hashes))
    np.testing.assert_array_equal(got, want)
    probe = TT.WordsProbe(bloom)
    for i, s in enumerate(seqs):
        assert got[i] == M.max_streak(k, probe, s), i
    # the two equal streaks resolve to the later one; short reads have none
    one = M.max_streak(k, probe, seqs[-5][:k + 9])
    assert one >> 32 > 0
    assert got[-5] == one + k + 10
    assert (got[-4:-1] >> 32 == 0).all()
    assert (got[:200] >> 32 > 0).mean() > 0.75


def test_trimmer_keep_set_matches_jax(fastq, monkeypatch):
    """count_file_filter_device's Bloom against bfc_tpu's at k = 21, -b20,
    where first-occurrence collisions are common: the host sketch branch
    and KF's plain version (BFC_TPU_INC_ADJ=0) give the same bits."""
    fq, _, _ = fastq
    opt = Opts()
    opt.k = 21
    opt.bf_shift = 20
    jo = JOpts()
    jo.k, jo.bf_shift = 21, 20
    info = {}
    got = TT.count_file_filter_device(fq, opt, "cpu", batch_reads=512,
                                      info=info)
    assert info["verdict"] == "host sketch"
    want = JT.count_file_filter_device(fq, jo, batch_reads=512)
    bits = set_bits(np.asarray(want.words))
    np.testing.assert_array_equal(set_bits(got.words.numpy()), bits)
    monkeypatch.setenv("BFC_TPU_INC_ADJ", "0")
    got_kf = TT.count_file_filter_device(fq, opt, "cpu", batch_reads=512,
                                         info=info)
    assert info["verdict"] == "KF"
    np.testing.assert_array_equal(set_bits(got_kf.words.numpy()), bits)
    jagg, _ = JC.count_batches_aggregate(fq, jo, batch_reads=512)
    assert info["n_aggregated"] == len(jagg.shard)
