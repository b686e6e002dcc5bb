"""KA's plain version against bfc_tpu.ops.kmer.kmer_stream on JAX-CPU.

Inputs: a seeded numpy batch with N bases, low-quality bases and short
reads.  Tolerance: exact equality on every integer output, compared at
the positions where a full k-mer ends (bfc_tpu leaves the others
arbitrary), and the arrival planes everywhere."""

import numpy as np
import pytest
import torch

from bfc_tpu.ops import kmer as jk
from bfc_tpu.opts import Opts as JOpts
from bfc_tpu_torch.ops import kmer as tk


def _batch(seed=5, B=48, L=96):
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, (B, L)).astype(np.uint8)
    bases[rng.random((B, L)) < 0.02] = 4
    qok = rng.random((B, L)) < 0.85
    lens = rng.integers(5, L + 1, B).astype(np.int32)
    lens[:4] = [0, 1, 16, L]
    return bases, qok, lens


@pytest.mark.parametrize("k", [17, 23, 25, 31, 32, 33, 63])
def test_kmer_stream_matches_jax(k):
    bases, qok, lens = _batch()
    jo = JOpts()
    jo.k = k
    l_pre = jo.effective_l_pre()
    ref = jk.kmer_stream(bases, qok, lens, k, l_pre)
    shard, keybody, arrp, ret = tk.kmer_stream(
        torch.from_numpy(bases), torch.from_numpy(qok),
        torch.from_numpy(lens), k, l_pre, arrival_base=1000, with_ret=True)
    shard, keybody, arrp, ret = (t.numpy() for t in (shard, keybody, arrp, ret))
    valid = np.asarray(ref["valid"])
    assert valid.any()
    np.testing.assert_array_equal(shard != tk.INVALID_SHARD, valid)
    np.testing.assert_array_equal(
        shard[valid], np.asarray(ref["shard"]).astype(np.int64)[valid])
    np.testing.assert_array_equal(
        keybody[valid], np.asarray(ref["keybody"]).view(np.int64)[valid])
    np.testing.assert_array_equal(
        ret[valid], np.asarray(ref["ret"]).view(np.int64)[valid])
    np.testing.assert_array_equal((arrp & 1) == 1, np.asarray(ref["is_high"]))
    B, L = bases.shape
    np.testing.assert_array_equal(arrp >> 1,
                                  1000 + np.arange(B * L).reshape(B, L))
    assert tk.keybody_bits(k, l_pre) == jk.keybody_bits(k, l_pre)


def test_kmer_stream_checks_inputs():
    bases, qok, lens = _batch()
    with pytest.raises(ValueError):
        tk.kmer_stream(torch.from_numpy(bases).to(torch.int32),
                       torch.from_numpy(qok), torch.from_numpy(lens), 21, 20)
    with pytest.raises(ValueError):
        tk.kmer_stream(torch.from_numpy(bases), torch.from_numpy(qok),
                       torch.from_numpy(lens[:-1]), 21, 20)
