"""The human-scale rehearsal (bfc_tpu_torch/tools/human_scale.py) on the
CPU, at a tiny size, against bfc_tpu on JAX-CPU.

The tool's gen_batch batches (a 200 kb genome, batches of 1,024 reads of
100 bp, 1% errors, k = 27) go through bfc_tpu's AggBuilder and
finalize_spectrum and through the port's, both spilling under a low
BFC_TPU_MAX_MERGE_CAP: the kept entries must be equal, in each of the
port's finalize modes.  The tool's own check (Tally, against the final
aggregate, apart from the spill chain) must pass on a spilled tree and
catch a row whose n was changed and a dropped span.  main(["--cpu", ...])
must exit 0 with its report as the last line, spilled or not, its
check's KA calls kept out of the path's launches.  And the device finalize
of a spilled aggregate must raise before its upload where the card lacks
the bytes (counter.check_upload, device_free_bytes patched).  Tolerance:
exact equality throughout."""

import json

import numpy as np
import pytest
import torch

from bfc_tpu.models import counter as JC
from bfc_tpu.opts import Opts as JOpts
from bfc_tpu_torch import kernels
from bfc_tpu_torch.models import counter as TC
from bfc_tpu_torch.ops import kmer as kops
from bfc_tpu_torch.ops import spectrum as tspec
from bfc_tpu_torch.ops import spectrum_host as sph
from bfc_tpu_torch.opts import Opts
from bfc_tpu_torch.tools import human_scale as HS

GLEN, B, N_BATCHES, K = 200_000, 1024, 4, 27
CAP = 1 << 12  # BFC_TPU_MAX_MERGE_CAP: every batch's run spills


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's plain versions beside the
    suite's other workers; no result depends on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opts(O):
    o = O()
    o.k = K
    o.apply_genome_size(GLEN)
    o.k = K
    return o


@pytest.fixture(scope="module")
def genome():
    return np.random.default_rng(7).integers(0, 4, GLEN).astype(np.uint8)


@pytest.fixture(scope="module")
def batches(genome):
    return [HS.gen_batch(genome, 1000 + bi, B, 100, 0.01, Opts().q)
            for bi in range(N_BATCHES)]


def _port_count(batches, monkeypatch, device_finalize=False, tally=None):
    """The port's builder over the batches, the tally beside it; returns
    (builder, finish's aggregate)."""
    monkeypatch.setenv("BFC_TPU_MAX_MERGE_CAP", str(CAP))
    b = TC.AggBuilder(_opts(Opts), "cpu")
    for mat, qok, lens, _ in batches:
        base = b.arrival_base
        b.add(mat, qok, lens)
        if tally is not None:
            tally.add(mat, qok, lens, base)
    return b, b.finish(device_finalize)


@pytest.fixture(scope="module")
def jax_entries(batches):
    """bfc_tpu's kept entries of the batches, counted under the cap."""
    mp = pytest.MonkeyPatch()
    mp.setenv("BFC_TPU_MAX_MERGE_CAP", str(CAP))
    mp.delenv("BFC_TPU_DEVICE_FINALIZE", raising=False)
    try:
        jo = _opts(JOpts)
        jb = JC.AggBuilder(jo)
        for mat, qok, lens, _ in batches:
            jb.add(mat, qok, lens)
        agg = jb.finish()
        assert "pull" in jb.tree.timings  # bfc_tpu's tree spilled too
        return JC.finalize_spectrum(agg, jo).compact_entries()
    finally:
        mp.undo()


@pytest.mark.parametrize("device_finalize", [False, True],
                         ids=["host", "device"])
def test_spilled_spectrum_matches_jax(batches, jax_entries, monkeypatch,
                                      device_finalize):
    b, agg = _port_count(batches, monkeypatch, device_finalize)
    assert b.spills >= N_BATCHES
    ds = TC.finalize_spectrum(agg, _opts(Opts), "cpu",
                              host=not device_finalize)
    got = ds.compact_entries()
    assert len(got[0]) > 10_000
    for g, w in zip(got, jax_entries):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.fixture
def tallied(genome, batches, monkeypatch):
    """A spilled port tree and the tool's tally of the same batches."""
    o = _opts(Opts)
    keys = HS.sample_keys(genome, batches[0], K, o.effective_l_pre(),
                          np.random.default_rng(8), "cpu")
    tally = HS.Tally(*keys, K, o.effective_l_pre(), "cpu")
    b, agg = _port_count(batches, monkeypatch, tally=tally)
    assert b.spills >= N_BATCHES
    return tally, agg


FIELDS = ("presence", "n", "n_high", "first_arr", "first_high")


def test_tally_check_passes_on_a_spilled_tree(tallied):
    tally, agg = tallied
    got = tally.check(agg)
    assert all(got[f] == 0 for f in FIELDS), got
    assert got["tallied"] > 3000 and got["untallied"] > 0
    assert sph.in_key_order(agg.shard, agg.keybody)


def test_tally_check_catches_a_changed_count(tallied):
    """One sampled key's row gets n + 1 where its n is below 255."""
    tally, agg = tallied
    found, n, *_ = HS.host_lookup(agg, tally.shard.numpy(),
                                  tally.keybody.numpy())
    q = int(np.nonzero(found & (n < 255))[0][0])
    at = HS.lower_bound(agg.shard, agg.keybody,
                        tally.shard.numpy()[q:q + 1].astype(np.uint32),
                        tally.keybody.numpy()[q:q + 1].astype(np.uint64))[0]
    n2 = agg.n.copy()
    n2[at] += 1
    got = tally.check(agg._replace(n=n2))
    assert got["n"] == 1 and got["presence"] == 0


def test_tally_check_catches_a_dropped_span(genome, batches, monkeypatch):
    """The host tree's first merge keeps only its newer span."""
    merge = TC.AggBuilder._host_merge
    dropped = []

    def drop_first(self, a, b):
        if not dropped:
            dropped.append(len(a.shard))
            return b
        return merge(self, a, b)

    monkeypatch.setattr(TC.AggBuilder, "_host_merge", drop_first)
    o = _opts(Opts)
    keys = HS.sample_keys(genome, batches[0], K, o.effective_l_pre(),
                          np.random.default_rng(8), "cpu")
    tally = HS.Tally(*keys, K, o.effective_l_pre(), "cpu")
    _, agg = _port_count(batches, monkeypatch, tally=tally)
    assert dropped
    got = tally.check(agg)
    assert got["presence"] > 0 and got["n"] + got["first_arr"] > 0


def _count_ka(monkeypatch):
    """KA's plain version counted as a launch, as the card's wrapper
    counts one, so that the report's launches can be read on the CPU."""
    plain = kops.kmer_stream_plain

    def counted(*a, **kw):
        kernels.KA.launches += 1
        return plain(*a, **kw)

    monkeypatch.setattr(kops, "kmer_stream_plain", counted)


def test_main_on_the_cpu(capsys, monkeypatch):
    """A spilled run with both finalizes; KA's calls of the check (two in
    sample_keys, one a batch in the tally) are reported apart from the
    counting path's one a batch."""
    monkeypatch.delenv("BFC_TPU_MAX_MERGE_CAP", raising=False)
    _count_ka(monkeypatch)
    rc = HS.main(["--cpu", "--reads", "3072", "--genome", "100e3",
                  "--batch", "1024", "--merge-cap", str(CAP),
                  "--both-finalize", "--correct-reads", "1024"])
    out = capsys.readouterr().out.strip().splitlines()
    rep = json.loads(out[-1])
    assert rc == 0 and rep["ok"]
    assert rep["reads"] == 3072 and rep["spills"] >= 3
    assert rep["checks"]["finalizes_equal"]
    assert rep["checks"]["records"] == {"sampled": 1000, "differ": 0}
    assert set(rep["finalize_modes"]) == {"host", "device"}
    assert rep["launches"]["kmer_stream"] == 3
    assert rep["check_launches"] == {"kmer_stream": 3 + 2}


def test_main_checks_an_unspilled_run(capsys, monkeypatch):
    """Nothing spills (no cap, and the CPU has no byte limit): the device
    finalize takes finish's Run, and the check searches it where it lies,
    pulling nothing of it to the host."""
    monkeypatch.delenv("BFC_TPU_MAX_MERGE_CAP", raising=False)
    _count_ka(monkeypatch)
    pulls = []
    pull = TC.AggBuilder.pull
    monkeypatch.setattr(TC.AggBuilder, "pull",
                        lambda self, *a: pulls.append(1) or pull(self, *a))
    rc = HS.main(["--cpu", "--reads", "2048", "--genome", "100e3",
                  "--batch", "1024", "--device-finalize", "--count-only"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rep["ok"] and rep["spills"] == 0
    assert rep["checks"]["key_order"]
    assert rep["checks"]["tally"]["tallied"] > 2000
    assert rep["launches"]["kmer_stream"] == 2
    assert rep["check_launches"] == {"kmer_stream": 2 + 2}
    assert not pulls


def test_main_refuses_a_stray_cap_and_a_missing_card(monkeypatch):
    monkeypatch.setenv("BFC_TPU_MAX_MERGE_CAP", "4096")
    assert HS.main(["--cpu", "--reads", "1024"]) == 2
    monkeypatch.delenv("BFC_TPU_MAX_MERGE_CAP")
    if not torch.cuda.is_available():
        assert HS.main(["--reads", "1024"]) == 2


def test_device_finalize_raises_before_the_upload(batches, monkeypatch):
    """A spilled aggregate whose upload and verdict scratch pass the
    card's free bytes: finalize_spectrum(host=False) raises with the
    HOST_FINALIZE message and copies nothing (host_agg_to_run is never
    reached); with one byte more free than needed it goes on."""
    _, agg = _port_count(batches, monkeypatch, device_finalize=True)
    o = _opts(Opts)
    rows = len(agg.shard)
    need = (TC.upload_bytes(rows, True)
            + tspec.verdict_bytes(rows, o.bf_shift, "KF"))
    uploads = []
    monkeypatch.setattr(TC, "host_agg_to_run",
                        lambda *a: uploads.append(a) or 1 / 0)
    monkeypatch.setattr(TC.kernels, "device_free_bytes", lambda d: need - 1)
    with pytest.raises(RuntimeError, match="host finalize") as e:
        TC.finalize_spectrum(agg, o, torch.device("cuda"), host=False)
    assert tspec.HOST_FINALIZE in str(e.value) and not uploads
    monkeypatch.setattr(TC.kernels, "device_free_bytes", lambda d: need)
    with pytest.raises(ZeroDivisionError):
        TC.finalize_spectrum(agg, o, torch.device("cuda"), host=False)
    assert len(uploads) == 1
