"""The mesh's counting spill of bfc_tpu_torch against bfc_tpu's.

The reads are tests/test_torch_spill.py's: a 2 kb genome from seed 71,
1,500 reads of 80 bp from seed 72, 0.3% errors; k 21, -b24.  `-L 20000`
cuts the CLI's counting into six batches of ~250 reads, whose runs hold
~1,400 rows a rank at R = 2 and ~700 at R = 4, of ~3,600 and ~1,800
distinct k-mers a rank in all.  BFC_TPU_MAX_MERGE_CAP is 2,048 rows at
R = 2 and 1,024 at R = 4 (CAPS), so every rank's tree merges some runs
on the device and spills the rest.

End to end, `python -m bfc_tpu_torch --cpu --mesh R` under the cap, each
under a subprocess timeout: R = 2 and R = 4 with the replicated table,
R = 2 with BFC_TPU_SHARD_TABLE=1 and with BFC_TPU_DEVICE_FINALIZE=1.
Each must log that all R ranks spilled, and its output must equal
bfc_tpu's run_device(mesh_devices=2) under the cap of R = 2 on the
8-device CPU mesh of tests/conftest.py, and the port's unspilled
single-device output.  The -d dump of each (but the device-finalize
run) must equal bfc_tpu's at the same R and cap and the single-device
dump.  bfc_tpu's R = 4 run counts and dumps only (no_ec): its mesh
correction compiles for most of a minute at each R, and its output does
not depend on R (tests/test_parallel.py).

In spawned gloo ranks (each under a timeout, a hang fails the test): a
mesh in which one rank alone spills (the cap set in that rank only)
gives the single-device bytes; the aggregate rank 0 gathers, the ranks'
own in rank order, is in (shard, keybody) order and equals the
single-device aggregate field for field; and while the trees spill, no
function of parallel/comm.py runs on a thread other than the main one
(each is wrapped to record its thread), while host merges do run on the
tree's merge worker.  Then the byte rule's share on a card that
ranks share.

This module imports neither jax nor bfc_tpu at its top: spawned ranks
import it again.  Tolerance: exact equality throughout."""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from . import datagen

ROOT = Path(__file__).resolve().parents[1]
K, BF = 21, 24
CHUNK = "20000"            # -L: six counting batches of ~250 reads
CAPS = {2: 2048, 4: 1024}  # BFC_TPU_MAX_MERGE_CAP (rows) at each R
TIMEOUT = 180              # seconds for any one run of ranks
AGG = ("shard", "keybody", "ret", "n", "n_high", "first_arr", "first_high")
CONFIGS = {  # (R, extra environment)
    "mesh2": (2, {}),
    "mesh4": (4, {}),
    "mesh2_sharded": (2, {"BFC_TPU_SHARD_TABLE": "1"}),
    "mesh2_device_finalize": (2, {"BFC_TPU_DEVICE_FINALIZE": "1"}),
}


def _write_reads(d) -> str:
    genome = datagen.make_genome(2000, seed=71)
    reads = datagen.simulate_reads(genome, 1500, read_len=80,
                                   err_rate=0.003, seed=72)
    fq = f"{d}/reads.fq"
    datagen.write_fastq(fq, reads)
    return fq


def _opts():
    from bfc_tpu_torch.opts import Opts

    o = Opts()
    o.k = K
    o.bf_shift = BF
    return o


def _cli(*args, env=None):
    """The port's CLI on the CPU with no BFC_TPU_ variable but env's, one
    intra-op thread a process (the ranks share the suite's cores)."""
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("BFC_TPU_")}
    full.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **(env or {}))
    return subprocess.run([sys.executable, "-m", "bfc_tpu_torch", "--cpu",
                           *args], cwd=ROOT, env=full, capture_output=True,
                          check=True, timeout=TIMEOUT)


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    return _write_reads(tmp_path_factory.mktemp("mesh_spill"))


@pytest.fixture(scope="module")
def single(fastq, tmp_path_factory):
    """The port's unspilled single-device output and -d dump."""
    d = tmp_path_factory.mktemp("mesh_spill_single")
    r = _cli("-L", CHUNK, f"-k{K}", f"-b{BF}", "-d", f"{d}/s.dump", fastq)
    assert r.stdout.count(b"\n") == 4 * 1500
    assert b"] spill 1:" not in r.stderr
    return {"out": r.stdout, "dump": (d / "s.dump").read_bytes()}


@pytest.fixture(scope="module")
def jax_mesh(fastq, tmp_path_factory):
    """bfc_tpu's run_device on make_mesh(R) under CAPS[R]: at R = 2 the
    corrected output and the -d dump, at R = 4 the dump (no_ec)."""
    from bfc_tpu.models import device_pipeline as JDP
    from bfc_tpu.opts import Opts as JOpts

    d = tmp_path_factory.mktemp("mesh_spill_jax")
    out = {"dump": {}}
    mp = pytest.MonkeyPatch()
    try:
        for R in (2, 4):
            mp.setenv("BFC_TPU_MAX_MERGE_CAP", str(CAPS[R]))
            o = JOpts()
            o.k = K
            o.bf_shift = BF
            got = JDP.run_device(o, fastq, mesh_devices=R, no_ec=R != 2,
                                 out_hash=f"{d}/j{R}.dump")
            if R == 2:
                out["out"] = got.encode()
            out["dump"][R] = (d / f"j{R}.dump").read_bytes()
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def mesh_runs(fastq, tmp_path_factory):
    """Each CONFIGS run of the CLI under its cap, with -d, made once:
    (stdout, stderr, dump bytes)."""
    d = tmp_path_factory.mktemp("mesh_spill_runs")
    done = {}

    def run(config):
        if config not in done:
            R, extra = CONFIGS[config]
            dump = d / f"{config}.dump"
            r = _cli("--mesh", str(R), "-L", CHUNK, f"-k{K}", f"-b{BF}",
                     "-d", str(dump), fastq,
                     env={"BFC_TPU_MAX_MERGE_CAP": str(CAPS[R]), **extra})
            done[config] = (r.stdout, r.stderr, dump.read_bytes())
        return done[config]

    return run


@pytest.mark.parametrize("config", list(CONFIGS))
def test_spilled_mesh_output_matches_jax_and_single_device(
        mesh_runs, jax_mesh, single, config):
    R, extra = CONFIGS[config]
    out, err, _ = mesh_runs(config)
    assert f"{R} of {R} ranks spilled".encode() in err
    verdict = b"KF" if "BFC_TPU_DEVICE_FINALIZE" in extra else b"host sketch"
    assert b"kept by the " + verdict + b" verdict on rank 0" in err
    if "BFC_TPU_SHARD_TABLE" in extra:
        assert f"sharded over {R} devices".encode() in err
    assert out.count(b"\n") == 4 * 1500
    assert out == jax_mesh["out"]
    assert out == single["out"]


@pytest.mark.parametrize("config", ["mesh2", "mesh4", "mesh2_sharded"])
def test_spilled_mesh_dump_matches_jax(mesh_runs, jax_mesh, single, config):
    R = CONFIGS[config][0]
    dump = mesh_runs(config)[2]
    assert dump == jax_mesh["dump"][R]
    assert dump == single["dump"]


# --------------------------------------------------------------------------
# Spawned ranks
# --------------------------------------------------------------------------

def _spawn(fn, R: int, *args) -> None:
    """fn(rank, R, *args) in R spawned processes; a rank that fails, or
    any still running after TIMEOUT seconds, fails the test."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(r, R) + args) for r in range(R)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(TIMEOUT)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} still running after {TIMEOUT} s"
        assert [p.exitcode for p in procs] == [0] * R
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()


def _init(rank, R, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rdv",
                            rank=rank, world_size=R)


def _one_rank_main(rank, R, out_dir, fq, spill_rank):
    """run_device over the mesh with the cap set in rank spill_rank
    alone; rank 0 writes the output and the report's spill counts."""
    import torch.distributed as dist

    from bfc_tpu_torch.models import device_pipeline as DP

    os.environ.pop("BFC_TPU_MAX_MERGE_CAP", None)
    if rank == spill_rank:
        os.environ["BFC_TPU_MAX_MERGE_CAP"] = "1024"
    _init(rank, R, out_dir)
    report = {}
    with open(f"{out_dir}/out{rank}.fq", "wb") as sink:
        DP.run_device(_opts(), fq, device="cpu", sink=sink,
                      count_batch_reads=256, report=report)
    if rank == 0:
        Path(f"{out_dir}/report.json").write_text(json.dumps({
            k: report[k] for k in ("spills_by_rank", "spilled_rows_by_rank",
                                   "finalize", "gather_s", "finalize_s")}))
    dist.destroy_process_group()


@pytest.mark.parametrize("spill_rank", [0, 1])
def test_one_rank_alone_spills(fastq, single, tmp_path, spill_rank):
    """The ranks branch on the spill only after the all_reduce that tells
    every rank whether any spilled: a rank that did not spill pulls its
    folded run for the gather, and nothing hangs."""
    _spawn(_one_rank_main, 2, str(tmp_path), fastq, spill_rank)
    rep = json.loads((tmp_path / "report.json").read_text())
    spills = rep["spills_by_rank"]
    assert spills[spill_rank] >= 2 and spills[1 - spill_rank] == 0
    assert rep["spilled_rows_by_rank"][1 - spill_rank] == 0
    assert rep["finalize"] == "host"
    assert rep["gather_s"] >= 0 and rep["finalize_s"] >= 0
    assert (tmp_path / "out0.fq").read_bytes() == single["out"]
    assert (tmp_path / "out1.fq").read_bytes() == b""


def _gather_main(rank, R, out_dir, fq):
    """count_file_mesh under the cap with every function of comm wrapped
    to record its thread and the host merges' threads recorded; rank 0
    saves the aggregate it gathered."""
    import torch.distributed as dist

    from bfc_tpu_torch.models import counter as C
    from bfc_tpu_torch.parallel import comm
    from bfc_tpu_torch.parallel import mesh as pm

    os.environ["BFC_TPU_MAX_MERGE_CAP"] = "1024"
    _init(rank, R, out_dir)
    comm_threads, merge_threads = set(), set()

    def wrap(f):
        def g(*a, **kw):
            comm_threads.add(threading.current_thread().name)
            return f(*a, **kw)
        return g

    for name in dir(comm):
        f = getattr(comm, name)
        if callable(f) and getattr(f, "__module__", "") == comm.__name__:
            setattr(comm, name, wrap(f))
    host_merge = C.AggBuilder._host_merge

    def recorded(self, a, b):
        merge_threads.add(threading.current_thread().name)
        return host_merge(self, a, b)

    C.AggBuilder._host_merge = recorded
    gather = pm.gather_aggregate
    got = {}

    def kept(cols, carry):
        got["agg"] = gather(cols, carry)
        return got["agg"]

    pm.gather_aggregate = kept
    ds = pm.count_file_mesh(fq, _opts(), "cpu", batch_reads=256)
    Path(f"{out_dir}/threads{rank}.json").write_text(json.dumps({
        "comm": sorted(comm_threads), "merge": sorted(merge_threads),
        "spills": ds.count_report["spills_by_rank"],
        "n_aggregated": ds.n_aggregated}))
    if rank == 0:
        agg = got["agg"]
        np.savez(f"{out_dir}/agg.npz", **{
            f: getattr(agg, f) for f in AGG if getattr(agg, f) is not None})
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def gathered(fastq, tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_spill_gather")
    _spawn(_gather_main, 2, str(d), fastq)
    return (dict(np.load(d / "agg.npz")),
            [json.loads((d / f"threads{r}.json").read_text())
             for r in range(2)])


def test_gathered_aggregate_is_the_single_device_aggregate(fastq, gathered):
    from bfc_tpu_torch.models import counter as C
    from bfc_tpu_torch.ops import spectrum_host as sph

    agg, ranks = gathered
    assert all(min(r["spills"]) >= 2 for r in ranks)
    want, n = C.count_batches_aggregate(fastq, _opts(), "cpu",
                                        batch_reads=256)
    assert n == 1500 and ranks[0]["n_aggregated"] == len(want.shard)
    assert "ret" not in agg  # k = 21: ret is derived once, on rank 0
    assert sph.in_key_order(agg["shard"], agg["keybody"])
    for f in AGG:
        if f != "ret":
            assert agg[f].dtype == getattr(want, f).dtype, f
            np.testing.assert_array_equal(agg[f], getattr(want, f), f)


def test_no_collective_off_the_main_thread(gathered):
    _, ranks = gathered
    for r in ranks:
        assert r["comm"] == ["MainThread"]
        # the workers merge while the stream runs; finish merges the last
        # host levels on the main thread
        assert "bfc-lsm-merge" in r["merge"]
        assert set(r["merge"]) <= {"bfc-lsm-merge", "MainThread"}


# --------------------------------------------------------------------------
# The byte rule on a card that ranks share
# --------------------------------------------------------------------------

@pytest.mark.parametrize("local_world,cards,card,want", [
    (2, 1, 0, 2),   # two gloo ranks on one card
    (3, 2, 0, 2),   # local ranks 0 and 2 on cuda:0
    (3, 2, 1, 1),   # local rank 1 alone on cuda:1
    (2, 8, 1, 1),   # a card a rank
    (4, 1, 0, 4),
])
def test_free_bytes_are_a_share_of_a_shared_card(monkeypatch, local_world,
                                                 cards, card, want):
    from bfc_tpu_torch import kernels
    from bfc_tpu_torch.models import counter as C
    from bfc_tpu_torch.parallel import comm

    monkeypatch.setattr(comm, "active", lambda: True)
    monkeypatch.setattr(comm, "size", lambda: local_world)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    monkeypatch.delenv("BFC_TPU_MAX_MERGE_CAP", raising=False)
    dev = torch.device(f"cuda:{card}")
    assert comm.ranks_sharing(dev) == want
    assert comm.ranks_sharing(torch.device("cpu")) == 1
    monkeypatch.setattr(kernels, "device_free_bytes", lambda d: 12000)
    b = C.AggBuilder(_opts(), dev)
    assert b.sharing == want and b._free_bytes() == 12000 // want
    assert C.merge_on_card(10, 10, 12000 // want, b._free_bytes(), None)
    assert C.merge_on_card(10, 10, 12000 // want + 1, b._free_bytes(),
                           None) is False
    monkeypatch.setattr(comm, "active", lambda: False)
    assert comm.ranks_sharing(dev) == 1


@pytest.mark.parametrize("carry", [False, True])
def test_gather_refuses_aggregates_out_of_key_order(monkeypatch, carry):
    """A one-rank gather (gather_rows returns what it is given) of a sorted
    aggregate returns it column for column, its ret where the runs carry
    it; the same rows with two ranks' ranges swapped raise."""
    from bfc_tpu_torch.ops import spectrum_host as sph
    from bfc_tpu_torch.parallel import comm
    from bfc_tpu_torch.parallel import mesh as pm

    rng = np.random.default_rng(5)
    n = 1000
    keys = np.unique(rng.integers(0, 1 << 40, n, dtype=np.uint64))
    n = len(keys)
    ha = sph.HostAgg(
        shard=(keys >> np.uint64(30)).astype(np.uint32),
        keybody=keys & np.uint64((1 << 30) - 1),
        ret=rng.integers(0, 1 << 63, n, dtype=np.uint64),
        n=rng.integers(1, 500, n, dtype=np.uint64).astype(np.uint32),
        n_high=rng.integers(0, 500, n, dtype=np.uint64).astype(np.uint32),
        first_arr=rng.integers(0, 1 << 40, n, dtype=np.uint64),
        first_high=rng.integers(0, 2, n).astype(np.uint32))
    monkeypatch.setattr(comm, "gather_rows", lambda cols: [cols[0]])
    monkeypatch.setattr(comm, "rank", lambda: 0)
    cols = pm.agg_columns(ha, carry)
    got = pm.gather_aggregate(cols, carry)
    assert cols == []  # every column handed over, none kept
    for f in AGG:
        if f == "ret" and not carry:
            assert got.ret is None
            continue
        assert getattr(got, f).dtype == getattr(ha, f).dtype, f
        np.testing.assert_array_equal(getattr(got, f), getattr(ha, f), f)
    swapped = sph.HostAgg(*(np.concatenate([c[n // 2:], c[:n // 2]])
                            for c in ha[:7]))
    with pytest.raises(RuntimeError, match="not in"):
        pm.gather_aggregate(pm.agg_columns(swapped, carry), carry)
