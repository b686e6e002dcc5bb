"""The human-scale rehearsal over a mesh (tools/human_scale.py --mesh N)
and the port's count_encoded_mesh, on the CPU, at a tiny size.

The tool's gen_batch batches (a 200 kb genome, batches of 1,024 reads of
100 bp, 1% errors, k = 27), as tests/test_torch_human_scale.py makes
them, go through bfc_tpu's count_encoded_mesh(..., shard_table=True) on
a 2-device mesh of tests/conftest.py's 8 CPU devices and through the
port's count_encoded_mesh over 2 and 4 spawned gloo ranks, each rank fed
its rows [r B/R, (r+1) B/R) of every batch; the port's kept entries,
gathered in rank order, must equal bfc_tpu's.  Both unspilled and under
a BFC_TPU_MAX_MERGE_CAP of 4,096 rows, where every rank spills.

Then the tool itself: `--cpu --mesh 2` exits 0 with its report as the
last line, its 1,000 sampled records equal to refmodel.ec1 on the
sharded table and its entries_sha256 equal to the single-rank tool's at
the same arguments, unspilled and spilled (rank 0 then finalizes on the
host); `--mesh 3` keeps the replicated table and passes.  Its checks
must catch faults planted in spawned ranks that run the tool: an n
changed on one rank's aggregate, a span dropped on one rank, and the
counting's arrivals made rank-local, which leaves every count in place
and which the tally, taken with global arrivals, catches in the first
occurrences alone.  A tally taken with rank-local arrivals fails a
correct run on two ranks the same way.

This module imports neither jax nor bfc_tpu at its top: spawned ranks
import it again.  Every run of ranks is under a timeout of its own (a
hang fails the test), with one intra-op thread a rank.  Tolerance: exact
equality throughout."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bfc_tpu_torch.opts import Opts
from bfc_tpu_torch.tools import human_scale as HS

GLEN, B, N_BATCHES, K = 200_000, 1024, 4, 27
CAP = 1 << 12     # BFC_TPU_MAX_MERGE_CAP (rows): every rank spills
TIMEOUT = 180     # seconds for any one run of ranks
ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--cpu", "--reads", str(N_BATCHES * B), "--genome", str(GLEN),
         "--batch", str(B)]


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread here and in every launched rank, beside the
    suite's other workers; no result depends on it."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("BFC_TPU_MAX_MERGE_CAP", raising=False)
    monkeypatch.delenv("BFC_TPU_DEVICE_FINALIZE", raising=False)
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


def _batches():
    genome = np.random.default_rng(7).integers(0, 4, GLEN).astype(np.uint8)
    return [HS.gen_batch(genome, 1000 + bi, B, 100, 0.01, Opts().q)
            for bi in range(N_BATCHES)]


def _spawn(fn, R: int, *args) -> None:
    """fn(rank, R, *args) in R spawned processes; a rank that fails, or
    any still running TIMEOUT seconds after the start, fails the test."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(r, R) + args) for r in range(R)]
    deadline = time.monotonic() + TIMEOUT
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} still running after {TIMEOUT} s"
        assert [p.exitcode for p in procs] == [0] * R
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()


# --------------------------------------------------------------------------
# count_encoded_mesh against bfc_tpu's
# --------------------------------------------------------------------------

def _count_main(rank, R, out_dir):
    """count_encoded_mesh with the sharded table over this rank's rows of
    the batches, unspilled and then under CAP; rank 0 saves the entries
    gathered in rank order and every rank's spills."""
    import torch.distributed as dist

    from bfc_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rdv",
                            rank=rank, world_size=R)
    step = B // R
    mine = [tuple(x[rank * step:(rank + 1) * step] for x in b[:3]) + (B,)
            for b in _batches()]
    for spilled in (False, True):
        if spilled:
            os.environ["BFC_TPU_MAX_MERGE_CAP"] = str(CAP)
        ds = pm.count_encoded_mesh(iter(mine), _opts(Opts), "cpu",
                                   batch_reads=B, shard_table=True)
        got = pm.gathered_entries(ds)
        if rank == 0:
            tag = "spilled" if spilled else "unspilled"
            np.savez(f"{out_dir}/{tag}.npz", *got,
                     spills=ds.count_report["spills_by_rank"],
                     by_rank=ds.entries_by_rank)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def port_counts(tmp_path_factory):
    done = {}

    def run(R):
        if R not in done:
            d = tmp_path_factory.mktemp(f"count_mesh{R}")
            _spawn(_count_main, R, str(d))
            done[R] = {t: dict(np.load(d / f"{t}.npz"))
                       for t in ("unspilled", "spilled")}
        return done[R]

    return run


@pytest.fixture(scope="module")
def jax_entries():
    """bfc_tpu's count_encoded_mesh(shard_table=True) on make_mesh(2), the
    whole batches in, unspilled and under CAP."""
    from bfc_tpu.opts import Opts as JOpts
    from bfc_tpu.parallel import mesh as jmesh

    batches = _batches()
    mesh = jmesh.make_mesh(2)
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for tag in ("unspilled", "spilled"):
            if tag == "spilled":
                mp.setenv("BFC_TPU_MAX_MERGE_CAP", str(CAP))
            ds = jmesh.count_encoded_mesh(
                (b[:3] for b in batches), _opts(JOpts), mesh,
                batch_reads=B, shard_table=True)
            assert type(ds.table).__name__ == "ShardedCuckoo"
            out[tag] = ds.compact_entries()
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("tag", ["unspilled", "spilled"])
@pytest.mark.parametrize("R", [2, 4])
def test_count_encoded_mesh_matches_jax(port_counts, jax_entries, R, tag):
    got = port_counts(R)[tag]
    spills = got["spills"]
    assert (min(spills) >= 2) if tag == "spilled" else (max(spills) == 0)
    assert len(got["by_rank"]) == R and min(got["by_rank"]) > 0
    want = jax_entries[tag]
    assert len(want[0]) > 20_000
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[f"arr_{i}"], np.asarray(w))


# --------------------------------------------------------------------------
# The tool over the mesh
# --------------------------------------------------------------------------

def _report(argv):
    """The tool with argv in a process group of its own (it launches its
    ranks there), the whole group killed after TIMEOUT seconds: its
    report, where it exits 0."""
    p = subprocess.Popen([sys.executable, "-m", HS.TOOL, *argv], cwd=ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=True)
    try:
        out, err = p.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        pytest.fail(f"the tool's ranks still running after {TIMEOUT} s")
    assert p.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def single_digests():
    """The single-rank tool's entries_sha256 at each mesh test's counting
    arguments (the tool without --mesh, in this process)."""
    import contextlib
    import io

    done = {}

    def digest(*extra):
        if extra not in done:
            buf = io.StringIO()
            mp = pytest.MonkeyPatch()
            try:
                mp.delenv("BFC_TPU_MAX_MERGE_CAP", raising=False)
                with contextlib.redirect_stdout(buf):
                    assert HS.main(SMALL + ["--count-only", *extra]) == 0
            finally:
                mp.undo()
            done[extra] = json.loads(buf.getvalue().splitlines()[-1])[
                "entries_sha256"]
        return done[extra]

    return digest


def test_mesh_tool_unspilled_with_records(single_digests):
    rep = _report(SMALL + ["--mesh", "2", "--correct-reads", "2048"])
    assert rep["ok"] and rep["world_size"] == 2 and rep["backend"] == "gloo"
    assert rep["spills_by_rank"] == [0, 0] and rep["finalize"] == "device"
    assert rep["table"] == "sharded" and rep["verdict"] == "KI"
    assert rep["table_bytes_per_rank"] == 8 << rep["cb_local"]
    assert sum(rep["entries_by_rank"]) == rep["entries"]
    assert sum(rep["rows_by_rank"]) == rep["rows_aggregated"]
    assert rep["checks"]["tally"]["tallied"] > 3000
    assert rep["checks"]["records"] == {"sampled": 1000, "differ": 0}
    assert rep["entries_sha256"] == single_digests()


def test_mesh_tool_spilled(single_digests):
    """Every rank spills; rank 0 finalizes the gathered aggregate on the
    host, and the entries are the unspilled ones."""
    rep = _report(SMALL + ["--mesh", "2", "--merge-cap", str(CAP),
                           "--count-only"])
    assert rep["ok"] and min(rep["spills_by_rank"]) >= 2
    assert rep["finalize"] == "host" and rep["rank0_finalize_s"] >= 0
    assert rep["table"] == "sharded"
    assert rep["entries_sha256"] == single_digests()
    assert rep["entries_sha256"] == single_digests("--merge-cap", str(CAP))


def test_mesh_of_three_keeps_the_replicated_table(single_digests):
    rep = _report(SMALL[:-1] + ["1023", "--mesh", "3", "--correct-reads",
                                "1023"])
    assert rep["ok"] and rep["table"] == "replicated"
    assert rep["entries_by_rank"] is None and rep["world_size"] == 3
    assert rep["checks"]["records"]["differ"] == 0
    assert rep["entries_sha256"] == single_digests("--batch", "1023")


def test_mesh_tool_refusals(capfd, monkeypatch):
    assert HS.main(SMALL + ["--mesh", "2", "--both-finalize"]) == 2
    assert HS.main(SMALL + ["--backend", "gloo"]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert HS.main(SMALL[1:] + ["--mesh", "2"]) == 2


# --------------------------------------------------------------------------
# Planted faults, in spawned ranks that run the tool
# --------------------------------------------------------------------------

def _fault_main(rank, R, out_dir, fault):
    """The tool as rank `rank` (the launcher's variables set by hand) with
    `fault` planted; each rank saves its exit code, rank 0 its report."""
    import contextlib
    import io

    from bfc_tpu_torch.models import counter as C
    from bfc_tpu_torch.ops import spectrum_dense as sdn
    from bfc_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(R), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(R),
                      BFC_TPU_INIT_METHOD=f"file://{out_dir}/rdv")
    os.environ.pop("BFC_TPU_MAX_MERGE_CAP", None)
    keys = []
    sample = HS.sample_keys

    def kept(*a):
        keys.append(sample(*a))
        return keys[-1]

    HS.sample_keys = kept
    if fault == "n" and rank == 1:
        drain = C.AggBuilder.drain

        def bumped(self):
            """n + 1 on the first of this rank's rows that holds a sampled
            key with n below the payload's cap."""
            acc, host = drain(self)
            s, kb = (t.to(acc.shard.device) for t in keys[0])
            at = HS.lower_bound(acc.shard, acc.keybody, s, kb).clamp(
                max=len(acc) - 1)
            hit = (acc.shard[at] == s) & (acc.keybody[at] == kb) & (
                acc.n[at] < HS.N_CAP)
            row = at[hit][0]
            n = acc.n.clone()
            n[row] += 1
            return sdn.Run(acc.shard, acc.keybody, acc.arr, n, acc.n_high,
                           acc.first_high, acc.ret), host

        C.AggBuilder.drain = bumped
    elif fault == "span" and rank == 1:
        merge = C.AggBuilder._merge
        dropped = []

        def drop_first(self, a, b):
            if not dropped:
                dropped.append(len(a))
                return b
            return merge(self, a, b)

        C.AggBuilder._merge = drop_first
    elif fault in ("arrivals", "tally_local"):
        # rank-local arrivals: a rank's rows of a batch start at the
        # batch's first arrival, in the counting or in the tally
        local = rank * (B // R) * 100
        if fault == "arrivals":
            chunk_run = pm.sharded_chunk_run

            def rank_local(bases, qok, lens, base, *a):
                return chunk_run(bases, qok, lens, base - local, *a)

            pm.sharded_chunk_run = rank_local
        else:
            add = HS.Tally.add

            def tally_local(self, bases, qok, lens, base):
                return add(self, bases, qok, lens, base - local)

            HS.Tally.add = tally_local
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = HS.main(SMALL[:2] + [str(2 * B)] + SMALL[3:]
                     + ["--mesh", str(R), "--count-only"])
    Path(f"{out_dir}/rc{rank}").write_text(str(rc))
    if rank == 0:
        Path(f"{out_dir}/report.json").write_text(
            buf.getvalue().splitlines()[-1])


FAULTS = ("presence", "n", "n_high", "first_arr", "first_high")


@pytest.mark.parametrize("fault", ["n", "span", "arrivals", "tally_local"])
def test_mesh_tally_catches_planted_faults(tmp_path, fault):
    _spawn(_fault_main, 2, str(tmp_path), fault)
    rcs = [int((tmp_path / f"rc{r}").read_text()) for r in range(2)]
    rep = json.loads((tmp_path / "report.json").read_text())
    got = rep["checks"]["tally"]
    assert got["tallied"] > 1500 and rep["checks"]["key_order"]
    assert rcs == [1, 1] and not rep["ok"]
    wrong = {f: got[f] for f in FAULTS if got[f]}
    if fault == "n":
        assert wrong == {"n": 1}
    elif fault == "span":
        assert got["presence"] > 0 and got["n"] + got["first_arr"] > 0
    else:  # counts and presence hold: only the first occurrences differ
        assert set(wrong) <= {"first_arr", "first_high"}
        assert got["first_arr"] > 100
