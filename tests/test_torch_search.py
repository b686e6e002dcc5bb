"""KD's plain version (bfc_tpu_torch.ops.search) and the port's batch
corrector against bfc_tpu on JAX-CPU, on one spectrum.

The JAX package counts a tests/datagen.py dataset (a 12 kb genome, 1,500
reads of 100 bp, 1% errors); the port's cuckoo table is built from its
compact entries with spectrum_from_compact.  KD is held against
correct_core's outputs on a 512-read batch, and the port's Corrector
(KC + KD + assembly + scalar fallback) against bfc_tpu's refmodel.ec1
read by read.  Every output is an integer or a byte string: the
tolerance is exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bfc_tpu.io.fastq import pack_stats as jpack_stats
from bfc_tpu.models import corrector as JDC
from bfc_tpu.models import counter as JC
from bfc_tpu.models import refmodel as JM
from bfc_tpu.ops.kmer import encode_batch
from bfc_tpu.opts import Opts as JOpts
from bfc_tpu_torch.io import fast_reader as FR
from bfc_tpu_torch.io.fastq import pack_stats
from bfc_tpu_torch.models import corrector as TDC
from bfc_tpu_torch.models import counter as TC
from bfc_tpu_torch.ops import annotate as tann
from bfc_tpu_torch.ops import search as tsrch
from bfc_tpu_torch.opts import Opts

from . import datagen

K = 21


def _topts():
    o = Opts()
    o.k = K
    o.bf_shift = 24
    return o


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_search")
    genome = datagen.make_genome(12000, seed=31)
    reads = datagen.simulate_reads(genome, 1500, read_len=100,
                                   err_rate=0.01, seed=32)
    fq = f"{d}/reads.fq"
    datagen.write_fastq(fq, reads)
    jo = JOpts()
    jo.k = K
    jo.bf_shift = 24
    jds = JC.count_file_device(fq, jo)
    tds = TC.spectrum_from_compact(*jds.compact_entries(), K, jds.l_pre, "cpu")
    assert tds.mode == jds.mode
    return fq, reads, jo, jds, tds


def test_ec1_search_matches_correct_core(setup):
    _, reads, jo, jds, tds = setup
    sub = reads[:512]
    bases, _, lens = encode_batch([s for s, _ in sub], None, jo.q, pad_to=128)
    qf = np.zeros(bases.shape, bool)
    for i, (_, q) in enumerate(sub):
        qf[i, :len(q)] = np.frombuffer(q.encode(), np.uint8) - 33 >= jo.q
    qf &= bases <= 3
    cfg = JDC.Corrector(jo, jds).cfg
    want = {k: np.asarray(v) for k, v in JDC.correct_core(
        jds.table, cfg, jnp.asarray(bases), jnp.asarray(qf),
        jnp.asarray(lens), jnp.int32(jds.mode)).items()}

    b_t, q_t, l_t = (torch.from_numpy(a) for a in (bases, qf, lens))
    _, lcov, hcov, isl = tann.kcov_island(tds.table, b_t, l_t, jo.min_cov)
    packed, out = tsrch.ec1_search(tds.table, _topts(), tds.mode,
                                   b_t, q_t, l_t, lcov, hcov, isl)
    packed, out = packed.numpy(), out.numpy()
    assert out[:, tsrch.OVERFLOW].sum() == 0
    ok = ~want["overflow"]
    assert ok.sum() > 500
    inb = np.arange(bases.shape[1])[None, :] < lens[:, None]
    np.testing.assert_array_equal(np.where(inb, packed, 0)[ok],
                                  np.where(inb, want["packed_bq"], 0)[ok])
    for col, name in ((tsrch.EC_CODE, "ec_code"), (tsrch.BRUTE, "brute"),
                      (tsrch.N_EC, "n_ec"), (tsrch.N_EC_HIGH, "n_ec_high"),
                      (tsrch.N_ABSENT, "n_absent"),
                      (tsrch.MAX_HEAP, "max_heap")):
        np.testing.assert_array_equal(out[ok, col], want[name][ok], name)
    assert (out[:, tsrch.N_EC] > 0).sum() > 100


def _ec1_mirror(jds):
    ch = JM.CountHash(jds.k, jds.l_pre)
    for s, kb, p in zip(*jds.compact_entries()):
        ch.shards[int(s)][int(kb)] = int(p)
    return ch


@pytest.mark.parametrize("caps", [(tsrch.HEAP_CAP, tsrch.STACK_CAP), (24, 120)],
                         ids=["main-caps", "tiny-caps"])
def test_corrector_matches_refmodel_ec1(setup, caps):
    """tiny-caps sends many reads through the port's scalar fallback."""
    fq, reads, jo, jds, tds = setup
    corr = TDC.Corrector(_topts(), tds, *caps)
    ch = _ec1_mirror(jds)
    n = 0
    for rb in FR.iter_batches_prefetch(fq, 400):
        res = corr.correct_arrays(rb.bases, rb.quals, rb.lens, rb.has_qual(),
                                  lambda i, rb=rb: (rb.seq(i), rb.qual(i)))
        for i in range(rb.n):
            st, s2, q2 = res.tuple_of(i)
            jst, js2, jq2 = JM.ec1(jo, ch, jds.mode, rb.seq(i), rb.qual(i))
            assert (s2, q2) == (js2, jq2), n + i
            assert pack_stats(st) == jpack_stats(jst), n + i
        n += rb.n
    assert n == len(reads)
    assert (corr.n_fallback > 10) == (caps[0] < tsrch.HEAP_CAP)
