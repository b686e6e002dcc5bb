"""KC's plain version (bfc_tpu_torch.ops.annotate) against bfc_tpu's
kcov_batch + best_island_batch on JAX-CPU, on one spectrum.

The JAX package counts a tests/datagen.py dataset (a 12 kb genome, 1,500
reads of 100 bp, 1% errors); the port's cuckoo table is built from its
compact entries with spectrum_from_compact, so both sides probe the same
k-mer counts.  Every output is an integer: the tolerance is exact
equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bfc_tpu.models import counter as JC
from bfc_tpu.models import refmodel as JM
from bfc_tpu.ops import annotate as jann
from bfc_tpu.ops.kmer import encode_batch
from bfc_tpu.opts import Opts as JOpts
from bfc_tpu_torch.models import counter as TC
from bfc_tpu_torch.ops import annotate as tann

from . import datagen


@pytest.fixture(scope="module")
def setup(request, tmp_path_factory):
    k = request.param
    d = tmp_path_factory.mktemp(f"torch_annotate{k}")
    genome = datagen.make_genome(12000, seed=71)
    reads = datagen.simulate_reads(genome, 1500, read_len=100,
                                   err_rate=0.01, seed=72)
    fq = f"{d}/reads.fq"
    datagen.write_fastq(fq, reads)
    jo = JOpts()
    jo.k = k
    jo.bf_shift = 24
    jds = JC.count_file_device(fq, jo)
    tds = TC.spectrum_from_compact(*jds.compact_entries(), k, jds.l_pre, "cpu")
    seqs = [s for s, _ in reads[:256]]
    seqs[5] = seqs[5][:40]        # a short read
    seqs[6] = "N" * 100           # no k-mer at all
    bases, _, lens = encode_batch(seqs, None, jo.q, pad_to=128)
    return jo, jds, tds, bases, lens


# At k = 63 bfc_tpu's device lookup (its displacement table) disagrees
# with its own scalar spec (ROADMAP Queue 3), so k = 63 is held against
# the scalar spec only.
@pytest.mark.parametrize("setup", [21, 33], indirect=True)
def test_kcov_island_matches_jax(setup):
    jo, jds, tds, bases, lens = setup
    k = jo.k
    se, _, lcov, hcov, occ, ovf = jann.kcov_batch(
        jds.table, jnp.asarray(bases), jnp.asarray(lens), k, jds.l_pre,
        jds.s_bits, jds.kb_bits, jo.min_cov)
    start, end, found = jann.best_island_batch(se, jnp.asarray(lens), k)
    assert not bool(np.asarray(ovf).any())
    got_occ, got_lcov, got_hcov, got_isl = (
        t.numpy() for t in tann.kcov_island(
            tds.table, torch.from_numpy(bases), torch.from_numpy(lens),
            jo.min_cov))
    np.testing.assert_array_equal(got_occ, np.asarray(occ))
    inb = np.arange(bases.shape[1])[None, :] < lens[:, None]
    np.testing.assert_array_equal(got_lcov[inb], np.asarray(lcov)[inb])
    np.testing.assert_array_equal(got_hcov[inb], np.asarray(hcov)[inb])
    np.testing.assert_array_equal(
        got_isl, np.stack([np.asarray(start), np.asarray(end),
                           np.asarray(found).astype(np.int32)], 1))
    assert got_isl[:, 2].sum() > 200 and got_isl[6, 2] == 0
    assert (got_occ >= 0).sum() > 10000


@pytest.mark.parametrize("setup", [21, 33, 63], indirect=True)
def test_kcov_island_matches_refmodel(setup):
    """Read by read against bfc_tpu's scalar ec_kcov / ec_best_island on a
    CountHash mirror of the same entries."""
    jo, jds, tds, bases, lens = setup
    k = jo.k
    ch = JM.CountHash(k, jds.l_pre)
    for s, kb, p in zip(*jds.compact_entries()):
        ch.shards[int(s)][int(kb)] = int(p)
    occ, lcov, hcov, isl = (t.numpy() for t in tann.kcov_island(
        tds.table, torch.from_numpy(bases), torch.from_numpy(lens),
        jo.min_cov))
    for r in range(len(lens)):
        n = int(lens[r])
        s = [JM.EcBase(b=int(c), ob=int(c)) for c in bases[r, :n]]
        JM.ec_kcov(k, jo.min_cov, s, ch)
        assert [c.lcov for c in s] == lcov[r, :n].tolist(), r
        assert [c.hcov for c in s] == hcov[r, :n].tolist(), r
        v = JM.ec_best_island(k, s)
        assert (v >> 32, v & 0xFFFFFFFF, int(v != 0)) == tuple(isl[r]), r
        x, run = JM.kmer_null(), 0
        for i, c in enumerate(s):
            if c.b < 4:
                JM.kmer_append(k, x, c.b)
                run += 1
            else:
                x, run = JM.kmer_null(), 0
            assert occ[r, i] == (ch.kmer_occ(x) if run >= k else -1), (r, i)


@pytest.mark.parametrize("setup", [21], indirect=True)
def test_kcov_island_checks_inputs(setup):
    jo, _, tds, bases, lens = setup
    with pytest.raises(ValueError):
        tann.kcov_island(tds.table, torch.from_numpy(bases).to(torch.int32),
                         torch.from_numpy(lens), jo.min_cov)
    with pytest.raises(ValueError):
        tann.kcov_island(tds.table, torch.from_numpy(bases).t(),
                         torch.from_numpy(lens), jo.min_cov)
