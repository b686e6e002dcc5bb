"""The counting spill of bfc_tpu_torch against bfc_tpu on JAX-CPU.

merge_host_aggs against bfc_tpu's on seeded sorted aggregates (the
searchsorted merge at k = 21, its key-range split with _PAR_MIN lowered in
both packages, the lexsort at k = 63, counts that saturate), LsmTree
against bfc_tpu's on synthetic runs (sync and async, with and without the
eager spill; a failing worker fails the run), the spill rule, and
AggBuilder with BFC_TPU_MAX_MERGE_CAP forced low against bfc_tpu's under
the same variable and against its own unspilled aggregate, and against a
model of the card's memory in which the spill rule's free bytes must not
shrink before the merge they allowed.  End to end, run_device with the
spill forced (256-read counting batches) against bfc_tpu's run_device
under the same variable: correction and -1 in both finalize modes, and
-d.  The mesh's spill is tests/test_torch_mesh_spill.py's.

The reads are a tests/datagen.py dataset: a 2 kb genome, 1,500 reads of
80 bp, 0.3% errors, so that a 256-read batch makes runs of a few thousand
rows at k = 21 and k = 63, some merged on the device and some spilled.
bfc_tpu counts in its default 8,192-read batches; the arrivals, and so
the aggregate, do not depend on the batch size.  bfc_tpu's aggregates are
those its run_device counts (k = 21 for correction, k = 63 for -1), taken
as they pass, so that bfc_tpu counts once at each k.  Tolerance: exact
equality throughout."""

import sys
import threading

import numpy as np
import pytest
import torch

from bfc_tpu.models import counter as JC
from bfc_tpu.models import device_pipeline as JDP
from bfc_tpu.ops import lsm as jlsm
from bfc_tpu.ops import spectrum_host as jsph
from bfc_tpu.opts import Opts as JOpts
from bfc_tpu_torch.models import counter as TC
from bfc_tpu_torch.models import device_pipeline as TDP
from bfc_tpu_torch.ops import kmer as tk
from bfc_tpu_torch.ops import lsm as tlsm
from bfc_tpu_torch.ops import spectrum_host as tsph
from bfc_tpu_torch.opts import Opts

from . import datagen

CAP = 1 << 12  # BFC_TPU_MAX_MERGE_CAP of the forced spills
FIELDS = ("shard", "keybody", "ret", "n", "n_high", "first_arr",
          "first_high")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's plain versions: their small ops
    lose to thread start-up beside the suite's other workers, and no
    result depends on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_spill")
    genome = datagen.make_genome(2000, seed=71)
    reads = datagen.simulate_reads(genome, 1500, read_len=80,
                                   err_rate=0.003, seed=72)
    fq = f"{d}/reads.fq"
    datagen.write_fastq(fq, reads)
    return fq


def _opts(O, k, bf_shift=24, trim=False):
    o = O()
    o.k = k
    o.bf_shift = bf_shift
    o.filter_mode = trim
    return o


def assert_aggs_equal(got, want):
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if w is None or g is None:
            assert g is None and w is None, f
            continue
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, f)


# --------------------------------------------------------------------------
# merge_host_aggs
# --------------------------------------------------------------------------

def random_agg(rng, keys, with_ret, saturate):
    """A sorted HostAgg over the distinct (shard, keybody) keys."""
    n = len(keys)
    top = 1 << 32 if saturate else 600
    return tsph.HostAgg(
        shard=keys[:, 0].astype(np.uint32), keybody=keys[:, 1],
        ret=rng.integers(0, 1 << 63, n, dtype=np.uint64) if with_ret else None,
        n=rng.integers(1, top, n, dtype=np.uint64).astype(np.uint32),
        n_high=rng.integers(0, top, n, dtype=np.uint64).astype(np.uint32),
        first_arr=rng.integers(0, 1 << 40, n, dtype=np.uint64),
        first_high=rng.integers(0, 2, n).astype(np.uint32))


def random_pair(k, n, with_ret, saturate, seed):
    """Two sorted aggregates that share about a third of their keys."""
    rng = np.random.default_rng(seed)
    l_pre = _opts(Opts, k).effective_l_pre()
    kb_bits = tk.keybody_bits(k, l_pre)
    top = 1 << min(kb_bits, 62)
    pool = np.stack([rng.integers(0, 1 << l_pre, 3 * n, dtype=np.uint64),
                     rng.integers(0, top, 3 * n, dtype=np.uint64)], axis=1)
    pool = np.unique(pool, axis=0)  # sorted by (shard, keybody)
    rng.shuffle(pool)
    a_keys = pool[:n]
    b_keys = pool[2 * n // 3: 2 * n // 3 + n]

    def srt(keys):
        return keys[np.lexsort((keys[:, 1], keys[:, 0]))]

    a = random_agg(rng, srt(a_keys), bool(with_ret), saturate)
    b = random_agg(rng, srt(b_keys), with_ret is True, saturate)
    return a, b, l_pre, kb_bits


@pytest.mark.parametrize("k,with_ret,saturate,par_min", [
    (21, True, False, None),   # searchsorted merge, ret carried
    (21, False, False, None),  # ret derivable: None on both sides
    (21, "a", False, None),    # ret on one side only: None out
    (21, True, True, None),    # counts that saturate at 2^32 - 1
    (21, True, False, 64),     # key ranges merged on a thread pool
    (21, False, True, 64),
    (63, True, False, None),   # identity past 64 bits: stable lexsort
    (63, True, True, 64),      # _PAR_MIN does not apply to the lexsort
])
def test_merge_host_aggs_matches_jax(monkeypatch, k, with_ret, saturate,
                                     par_min):
    if par_min is not None:
        monkeypatch.setattr(tsph, "_PAR_MIN", par_min)
        monkeypatch.setattr(jsph, "_PAR_MIN", par_min)
    a, b, l_pre, kb_bits = random_pair(k, 3000, with_ret, saturate, seed=k)
    got = tsph.merge_host_aggs(a, b, l_pre=l_pre, kb_bits=kb_bits)
    ja = jsph.HostAgg(*a)
    jb = jsph.HostAgg(*b)
    want = jsph.merge_host_aggs(ja, jb, l_pre=l_pre, kb_bits=kb_bits)
    assert_aggs_equal(got, want)
    # equal keys: first occurrence from a, counts added
    both = len(a.shard) + len(b.shard) - len(got.shard)
    assert both > 0
    assert (got.ret is None) == (with_ret is not True)
    if saturate:
        assert (got.n == 0xFFFFFFFF).any()
    # against the other order: first_arr then comes from b
    swapped = tsph.merge_host_aggs(b, a, l_pre=l_pre, kb_bits=kb_bits)
    np.testing.assert_array_equal(swapped.n, got.n)
    assert not np.array_equal(swapped.first_arr, got.first_arr)


def test_merge_host_aggs_empty_sides():
    a, b, l_pre, kb_bits = random_pair(21, 200, True, False, seed=3)
    empty = tsph.empty_host_agg()
    assert tsph.merge_host_aggs(empty, b, l_pre=l_pre, kb_bits=kb_bits) is b
    assert tsph.merge_host_aggs(a, empty, l_pre=l_pre, kb_bits=kb_bits) is a


# --------------------------------------------------------------------------
# LsmTree
# --------------------------------------------------------------------------

def synthetic_tree(mod, eager, async_spill, log, fail=None):
    """bfc_tpu's test_lsm_eager_spill_order_and_content tree: runs are
    (sorted list of (key, arrival), count); merges of more than 4 rows
    spill.  log records every host push's span; fail names the stage
    whose second call raises."""
    calls = {"pull": 0, "merge": 0}

    def merge(a, b):
        if max(len(a[0]), len(b[0])) > 4:
            return None
        m = sorted(a[0] + b[0])
        return (m, len(m))

    def to_host(run):
        calls["pull"] += 1
        if fail == "pull" and calls["pull"] == 2:
            raise RuntimeError("pull failed")
        log.append(("pull", run[0][0], run[0][-1]))
        return list(run[0])

    def host_merge(a, b):
        calls["merge"] += 1
        if fail == "merge" and calls["merge"] == 2:
            raise RuntimeError("merge failed")
        # the LSM contract: `a` covers the strictly earlier span
        assert a[-1] < b[0], "span order violated"
        log.append(("merge", a[0], a[-1], b[0], b[-1]))
        return a + b

    return mod.LsmTree(merge=merge, to_host=to_host, host_merge=host_merge,
                       async_spill=async_spill, size=lambda r: r[1],
                       eager_min=4 if eager else 0,
                       eager_min_after=2 if eager else 0)


@pytest.mark.parametrize("async_spill", [False, True])
@pytest.mark.parametrize("eager", [False, True])
def test_lsm_tree_matches_jax(eager, async_spill):
    runs = [([(i, i)], 1) for i in range(37)]
    out = {}
    for mod in (tlsm, jlsm):
        log = []
        t = synthetic_tree(mod, eager, async_spill, log)
        for r in runs:
            t.push(r)
        acc, hacc = t.finish()
        # each worker's calls in order (the two workers interleave)
        out[mod] = (acc, hacc, [e for e in log if e[0] == "pull"],
                    [e for e in log if e[0] == "merge"], sorted(t.timings))
    assert out[tlsm] == out[jlsm]
    acc, hacc, pulls, _, keys = out[tlsm]
    assert acc is None and hacc == [(i, i) for i in range(37)]
    # every pull is the next contiguous span
    pulls = [e[1:] for e in pulls]
    assert pulls[0][0] == (0, 0) and pulls[-1][1] == (36, 36)
    assert all(p[1][0] + 1 == q[0][0] for p, q in zip(pulls, pulls[1:]))
    assert keys == ["host_merge", "pull"]


def test_lsm_async_spans_stay_in_order_under_thread_switching():
    """The two workers and the pushing thread, switching every few
    microseconds: every host merge still takes the earlier span first,
    and every run arrives once."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        log = []
        t = synthetic_tree(tlsm, True, True, log)
        for i in range(300):
            t.push(([(i, i)], 1))
        acc, hacc = t.finish()
    finally:
        sys.setswitchinterval(switch)
    assert acc is None and hacc == [(i, i) for i in range(300)]
    assert t._threads == [] and t._q is None


def test_lsm_tree_without_spill_keeps_the_run_on_the_device():
    for mod in (tlsm, jlsm):
        t = synthetic_tree(mod, False, True, [])
        for i in range(3):
            t.push(([(i, i)], 1))
        acc, hacc = t.finish()
        assert hacc is None and acc == ([(0, 0), (1, 1), (2, 2)], 3)


@pytest.mark.parametrize("async_spill", [False, True])
@pytest.mark.parametrize("stage", ["pull", "merge"])
def test_lsm_worker_failure_fails_the_run(stage, async_spill):
    """A worker's exception is raised by the next push or by finish:
    nothing swallows it."""
    t = synthetic_tree(tlsm, True, async_spill, [], fail=stage)
    with pytest.raises(RuntimeError, match=f"{stage} failed"):
        for i in range(37):
            t.push(([(i, i)], 1))
        t.finish()


# --------------------------------------------------------------------------
# The spill rule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rows_a,rows_b,need,free,cap,want", [
    (100, 50, 10, None, None, True),      # the CPU, no cap
    (4096, 4096, 10, None, 4096, True),   # both at the cap
    (4097, 10, 10, None, 4096, False),    # the older run over it
    (10, 4097, 10, None, 4096, False),    # the newer run over it
    (10, 10, 1000, 1000, None, True),     # exactly the free bytes
    (10, 10, 1001, 1000, None, False),    # one byte short
    (10, 10, 1001, 1000, 4096, False),
    (5000, 10, 10, 1000, None, True),     # no cap: bytes alone
])
def test_merge_on_card(rows_a, rows_b, need, free, cap, want):
    assert TC.merge_on_card(rows_a, rows_b, need, free, cap) is want


def test_device_free_bytes_leaves_out_fragments(monkeypatch):
    """The byte rule's free bytes: cudaMemGetInfo's free plus the caching
    allocator's wholly unused segments, not the blocks split off segments
    in use."""
    from bfc_tpu_torch import kernels

    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (1000, 9000))
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda dev: {
        "reserved_bytes.all.current": 800,
        "allocated_bytes.all.current": 300,
        "inactive_split_bytes.all.current": 200})
    assert kernels.device_free_bytes("cuda") == 1000 + 800 - 300 - 200


def test_merge_cap_reads_bfc_tpus_variable(monkeypatch):
    monkeypatch.delenv("BFC_TPU_MAX_MERGE_CAP", raising=False)
    assert TC.merge_cap() is None
    monkeypatch.setenv("BFC_TPU_MAX_MERGE_CAP", "4194304")
    assert TC.merge_cap() == 1 << 22
    assert TC.AggBuilder(_opts(Opts, 21), "cpu").cap == 1 << 22


# --------------------------------------------------------------------------
# AggBuilder
# --------------------------------------------------------------------------

@pytest.fixture
def builders(monkeypatch):
    """Every port AggBuilder made while the test runs."""
    made = []
    init = TC.AggBuilder.__init__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    monkeypatch.setattr(TC.AggBuilder, "__init__", record)
    return made


@pytest.mark.parametrize("k", [21, 63])
def test_spilled_aggregate_matches_jax_and_unspilled(fastq, jax_outputs,
                                                     monkeypatch, builders,
                                                     k):
    monkeypatch.setenv("BFC_TPU_MAX_MERGE_CAP", str(CAP))
    merges = []
    merge = TC.AggBuilder._merge
    monkeypatch.setattr(TC.AggBuilder, "_merge",
                        lambda self, a, b: merges.append(1) or merge(self, a, b))
    got, n = TC.count_batches_aggregate(fastq, _opts(Opts, k), "cpu",
                                        batch_reads=256)
    b = builders[-1]
    assert n == 1500 and b.spills >= 2 and merges  # both kinds of merge
    assert b.spilled_rows >= len(got.shard)
    assert b.tree.timings["pull"] >= 0 and "host_merge" in b.tree.timings
    assert "stage" in b.tree.timings
    assert got.bloom_min is not None
    assert_aggs_equal(got, jax_outputs["aggregates"][k])
    monkeypatch.delenv("BFC_TPU_MAX_MERGE_CAP")
    plain, _ = TC.count_batches_aggregate(fastq, _opts(Opts, k), "cpu",
                                          batch_reads=256)
    assert builders[-1].spills == 0
    assert_aggs_equal(got, plain)
    # the device finalize takes the spilled aggregate as a HostAgg too,
    # without the sketch, which only the host finalize reads
    monkeypatch.setenv("BFC_TPU_MAX_MERGE_CAP", str(CAP))
    dev, _ = TC.count_batches_aggregate(fastq, _opts(Opts, k), "cpu",
                                        batch_reads=256, device_finalize=True)
    assert isinstance(dev, tsph.HostAgg) and dev.bloom_min is None
    assert_aggs_equal(dev, plain)


def test_spill_rule_is_not_raced_by_the_pull_worker(fastq, monkeypatch,
                                                    builders):
    """A model of the card's memory.  A spill's only allocation on the
    card is KE's output, 8 bytes a row, held from the pack until the pull
    worker has copied it.  The free bytes that the spill rule reads before
    a merge must still be free when that merge runs: no thread may
    allocate between the check and the merge.  So KE runs on the pushing
    thread, and the pull worker only copies and frees."""
    monkeypatch.setenv("BFC_TPU_MAX_MERGE_CAP", str(CAP))
    lock = threading.Lock()
    held = [0]        # bytes of the card the spills hold
    checked = []      # held when the rule read the free bytes
    threads = {"pack": set(), "copy": set()}
    pack, copy, merge = TC.sdn.pack_pull, TC.pull_columns, TC.AggBuilder._merge

    def pack_pull(run):
        with lock:
            held[0] += 8 * len(run)
            threads["pack"].add(threading.current_thread().name)
        return pack(run)

    def pull_columns(cols):
        out = copy(cols)
        with lock:
            held[0] -= 8 * len(cols[0])
            threads["copy"].add(threading.current_thread().name)
        return out

    def free_bytes(self):
        with lock:
            checked.append(held[0])
        return 1 << 40

    def merge_after_check(self, a, b):
        with lock:
            assert held[0] <= checked[-1], "allocated since the check"
        return merge(self, a, b)

    monkeypatch.setattr(TC.sdn, "pack_pull", pack_pull)
    monkeypatch.setattr(TC, "pull_columns", pull_columns)
    monkeypatch.setattr(TC.AggBuilder, "_free_bytes", free_bytes)
    monkeypatch.setattr(TC.AggBuilder, "_merge", merge_after_check)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        TC.count_batches_aggregate(fastq, _opts(Opts, 21), "cpu",
                                   batch_reads=256)
    finally:
        sys.setswitchinterval(switch)
    assert builders[-1].spills >= 2 and len(checked) >= 2
    assert threads == {"pack": {threading.main_thread().name},
                       "copy": {"bfc-lsm-pull"}}
    assert held[0] == 0


def test_fold_refuses_a_spilled_tree(fastq, monkeypatch):
    monkeypatch.setenv("BFC_TPU_MAX_MERGE_CAP", str(CAP))
    b = TC.AggBuilder(_opts(Opts, 21), "cpu")
    for bases, qok, lens, _ in TC.padded_batches(fastq, b.opt, 256):
        b.add(bases, qok, lens)
    with pytest.raises(RuntimeError, match="spilled"):
        b.fold()


# --------------------------------------------------------------------------
# End to end
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_outputs(fastq, tmp_path_factory):
    """bfc_tpu's run_device under the forced cap: correction at k = 21 with
    its -d dump, and -1 at k = 63, and the aggregate each counted (-1 does
    not change the aggregate)."""
    d = tmp_path_factory.mktemp("torch_spill_jax")
    aggregates = {}
    count = JC.count_batches_aggregate

    def counted(fn, opt, **kw):
        agg, n = count(fn, opt, **kw)
        aggregates[opt.k] = agg
        return agg, n

    mp = pytest.MonkeyPatch()
    mp.setenv("BFC_TPU_MAX_MERGE_CAP", str(CAP))
    mp.setattr(JC, "count_batches_aggregate", counted)
    try:
        corrected = JDP.run_device(_opts(JOpts, 21), fastq,
                                   out_hash=f"{d}/j.dump").encode()
        trimmed = JDP.run_device(_opts(JOpts, 63, trim=True), fastq).encode()
    finally:
        mp.undo()
    assert sorted(aggregates) == [21, 63]
    with open(f"{d}/j.dump", "rb") as f:
        return {"corrected": corrected, "dump": f.read(), "trimmed": trimmed,
                "aggregates": aggregates}


@pytest.mark.parametrize("device_finalize", [False, True])
def test_spilled_correction_matches_jax(fastq, jax_outputs, monkeypatch,
                                        builders, device_finalize):
    monkeypatch.setenv("BFC_TPU_MAX_MERGE_CAP", str(CAP))
    report = {}
    got = TDP.run_device(_opts(Opts, 21), fastq, device="cpu",
                         count_batch_reads=256, report=report,
                         device_finalize=device_finalize).encode()
    assert builders[-1].spills >= 2
    assert report["finalize"] == ("device" if device_finalize else "host")
    assert got.count(b"\n") == 4 * 1500
    assert got == jax_outputs["corrected"]


def test_spilled_dump_matches_jax_and_unspilled(fastq, jax_outputs,
                                               monkeypatch, builders,
                                               tmp_path):
    monkeypatch.setenv("BFC_TPU_MAX_MERGE_CAP", str(CAP))
    TDP.run_device(_opts(Opts, 21), fastq, device="cpu", no_ec=True,
                   count_batch_reads=256, out_hash=str(tmp_path / "s.dump"))
    assert builders[-1].spills >= 2
    monkeypatch.delenv("BFC_TPU_MAX_MERGE_CAP")
    TDP.run_device(_opts(Opts, 21), fastq, device="cpu", no_ec=True,
                   out_hash=str(tmp_path / "u.dump"))
    assert builders[-1].spills == 0
    spilled = (tmp_path / "s.dump").read_bytes()
    assert spilled == (tmp_path / "u.dump").read_bytes()
    assert spilled == jax_outputs["dump"]


@pytest.mark.parametrize("device_finalize", [False, True])
def test_spilled_trim_matches_jax(fastq, jax_outputs, monkeypatch, builders,
                                  device_finalize):
    """-1 at k = 63, where the runs carry ret: the host sketch's verdict,
    or with the device finalize KF's over the aggregate taken to the
    card."""
    monkeypatch.setenv("BFC_TPU_MAX_MERGE_CAP", str(CAP))
    report = {}
    got = TDP.run_device(_opts(Opts, 63, trim=True), fastq, device="cpu",
                         count_batch_reads=256, report=report,
                         device_finalize=device_finalize).encode()
    assert builders[-1].spills >= 2 and builders[-1].carry
    assert report["verdict"] == ("KF" if device_finalize else "host sketch")
    assert report["finalize"] == ("device" if device_finalize else "host")
    assert got == jax_outputs["trimmed"]
