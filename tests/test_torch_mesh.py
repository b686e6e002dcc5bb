"""The port's mesh path (bfc_tpu_torch/parallel) against bfc_tpu's.

The sharded functions run in spawned gloo ranks at R = 2 and R = 4 and
are held against bfc_tpu.parallel.mesh on make_mesh(R), on the 8-device
virtual CPU mesh of tests/conftest.py, with the data of
tests/test_parallel.py (a 5 kb genome from seed 51, 1,024 reads of 100 bp
from seed 52 padded to 128 slots; k 17, l_pre 20, -b22, H 4): each rank's
aggregate equals the valid rows of device r's block of
sharded_chunk_aggregate, also after a two-half sharded_merge; the
verdicts equal sharded_adjudicate's and the single-device
adjudicate_first_occurrence's, with arrivals from 0 and from 2^33; the
payloads, kept counts and histograms equal _payloads_sharded's.

End to end, on datagen.standard_dataset (an 8 kb genome, 2,400 reads,
-k17 -b22): `python -m bfc_tpu_torch --cpu --mesh 2` and `--mesh 4` are
byte-identical to the single-device port and to bfc_tpu's scalar spec
(models/pipeline.run); --mesh 4 with --batch 1199 leaves ranks without
reads in the last batch.  With `-` operands (stdin fed from the dataset
file) --mesh 2 gives the single-device port's bytes: `- reads.fq`,
`- -` and a lone `-`, each under a 120 s subprocess timeout, so a rank
that blocks on a shared stdin fails the test instead of the suite.  Then
the launcher's stdin spooling and failure handling.  The
sharded table (BFC_TPU_SHARD_TABLE=1) is tests/test_torch_sharded.py's.

The ranks meet through a file in tmp_path.  This module imports neither
jax nor bfc_tpu at its top: spawned ranks import it again.  Tolerance:
exact equality throughout (every value is an integer or a byte)."""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from . import datagen

ROOT = Path(__file__).resolve().parents[1]
K, L_PRE, BF, H = 17, 20, 22, 4
FAR = 1 << 33
AGG = ("shard", "keybody", "ret", "n", "n_high", "first_arr", "first_high")


def _encoded_batch():
    from bfc_tpu_torch.ops import kmer as tk

    genome = datagen.make_genome(5000, seed=51)
    reads = datagen.simulate_reads(genome, 1024, read_len=100,
                                   err_rate=0.015, seed=52)
    return tk.encode_batch([r[0] for r in reads], [r[1] for r in reads], 20,
                           pad_to=128)


def _run_cols(run, k, l_pre):
    """A port run as numpy columns under bfc_tpu's Aggregate names."""
    from bfc_tpu_torch.ops import spectrum_dense as sdn

    run = sdn.run_to_aggregate(run, k, l_pre)
    return {"shard": run.shard.numpy(), "keybody": run.keybody.numpy(),
            "ret": run.ret.numpy(), "n": run.n.numpy(),
            "n_high": run.n_high.numpy(), "first_arr": run.arr.numpy(),
            "first_high": run.first_high.numpy().astype(np.int64)}


def _rank_main(rank, R, init, out_dir):
    """One spawned rank: the sharded functions on its share of the batch."""
    import torch.distributed as dist

    from bfc_tpu_torch.ops import spectrum_dense as sdn
    from bfc_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=R)
    bases, qok, lens = _encoded_batch()
    B, L = bases.shape

    def share(lo, hi):
        """Rank's rows of the batch made of reads [lo, hi)."""
        step = (hi - lo) // R
        a = lo + rank * step

        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x[a:a + step]))

        return pm.sharded_chunk_run(t(bases), t(qok), t(lens), a * L, K,
                                    L_PRE, False)

    out = {}
    whole = share(0, B)
    merged = pm.sharded_merge(share(0, B // 2), share(B // 2, B))
    for tag, run in (("agg", whole), ("merged", merged)):
        for f, v in _run_cols(run, K, L_PRE).items():
            out[f"{tag}_{f}"] = v
    run = sdn.run_to_aggregate(whole, K, L_PRE)
    for shift in (0, FAR):
        far = sdn.Run(run.shard, run.keybody, run.arr + shift, run.n,
                      run.n_high, run.first_high, run.ret)
        out[f"fp_{shift}"] = pm.sharded_adjudicate(far, BF, H).numpy()
    shard, keybody, payload, n_kept, hist, hist_high = pm.sharded_payloads(
        run, torch.from_numpy(out["fp_0"]))
    out.update(pay_shard=shard.numpy(), pay_keybody=keybody.numpy(),
               pay_payload=payload.numpy(), pay_n=np.int64(n_kept),
               pay_hist=hist.numpy(), pay_hist_high=hist_high.numpy())
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    """(R, each rank's results) from R spawned gloo ranks."""
    import torch.multiprocessing as mp

    R = request.param
    d = tmp_path_factory.mktemp(f"mesh{R}")
    mp.spawn(_rank_main, args=(R, f"file://{d}/rendezvous", str(d)),
             nprocs=R)
    return R, [dict(np.load(d / f"rank{r}.npz")) for r in range(R)]


@pytest.fixture(scope="module")
def jax_mesh(ranks):
    """bfc_tpu's sharded functions on make_mesh(R): per device the valid
    aggregate rows, the merged rows, the verdicts from 0 and 2^33, and
    the payloads; plus the single-device aggregate and verdicts."""
    import jax.numpy as jnp

    from bfc_tpu.ops import spectrum as spec
    from bfc_tpu.parallel import mesh as pmesh

    R = ranks[0]
    bases, qok, lens = (jnp.asarray(x) for x in _encoded_batch())
    B, L = bases.shape
    mref = pmesh.MeshRef(pmesh.make_mesh(R))
    cap = B * L // R
    agg, _, ovf = pmesh.sharded_chunk_aggregate(
        bases, qok, lens, jnp.uint64(0), K, L_PRE, cap, cap, mref)
    half = B // 2
    a1, _, o1 = pmesh.sharded_chunk_aggregate(
        bases[:half], qok[:half], lens[:half], jnp.uint64(0), K, L_PRE,
        cap, cap, mref)
    a2, _, o2 = pmesh.sharded_chunk_aggregate(
        bases[half:], qok[half:], lens[half:], jnp.uint64(half * L), K,
        L_PRE, cap, cap, mref)
    assert not (bool(ovf) or bool(o1) or bool(o2))
    merged, _ = pmesh.sharded_merge(a1, a2, cap, mref)

    def blocks(a, C):
        cols = {f: np.asarray(getattr(a, f)) for f in AGG}
        out = []
        for r in range(R):
            sl = slice(r * C, (r + 1) * C)
            valid = cols["shard"][sl] != 0xFFFFFFFF
            out.append({f: v[sl][valid] for f, v in cols.items()})
        return out

    res = {"agg": blocks(agg, cap), "merged": blocks(merged, cap)}
    for shift in (0, FAR):
        far = agg._replace(first_arr=agg.first_arr + jnp.uint64(shift))
        fp, ovf = pmesh.sharded_adjudicate(far, BF, H, mref)
        assert not bool(ovf)
        fp = np.asarray(fp)
        valid = np.asarray(agg.shard) != 0xFFFFFFFF
        res[f"fp_{shift}"] = [fp[r * cap:(r + 1) * cap][valid[r * cap:(r + 1)
                                                              * cap]]
                              for r in range(R)]
        if shift == 0:
            fp0 = fp
    shard_c, kb_c, pl_c, cnts, hist, hist_high = pmesh._payloads_sharded(
        agg, jnp.asarray(fp0), mref)
    cnts = np.asarray(cnts).reshape(R)
    res["pay"] = [{"shard": np.asarray(shard_c).reshape(R, -1)[r][:cnts[r]],
                   "keybody": np.asarray(kb_c).reshape(R, -1)[r][:cnts[r]],
                   "payload": np.asarray(pl_c).reshape(R, -1)[r][:cnts[r]],
                   "n": int(cnts[r]),
                   "hist": np.asarray(hist).reshape(R, -1)[r],
                   "hist_high": np.asarray(hist_high).reshape(R, -1)[r]}
                  for r in range(R)]
    single, _ = spec.chunk_aggregate(bases, qok, lens, jnp.uint64(0), K,
                                     L_PRE, B * L)
    res["single"] = {f: np.asarray(getattr(single, f)) for f in AGG}
    for shift in (0, FAR):
        far = single._replace(
            first_arr=single.first_arr + jnp.uint64(shift))
        res[f"single_fp_{shift}"] = np.asarray(
            spec.adjudicate_first_occurrence(far, BF, H))
    return res


def _same(got, want, what):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got.astype(np.uint64),
                                  want.astype(np.uint64), err_msg=what)


@pytest.mark.parametrize("tag", ["agg", "merged"])
def test_rank_aggregates_match_sharded_chunk_aggregate(ranks, jax_mesh, tag):
    """Rank r's run (one batch, and two half batches merged) holds exactly
    the valid rows of device r's block, in the same order."""
    R, got = ranks
    for r in range(R):
        assert len(got[r][f"{tag}_shard"]) > 0
        for f in AGG:
            _same(got[r][f"{tag}_{f}"], jax_mesh[tag][r][f], f"rank {r} {f}")


@pytest.mark.parametrize("shift", [0, FAR], ids=["from0", "from2^33"])
def test_verdicts_match_sharded_adjudicate(ranks, jax_mesh, shift):
    """The verdicts, routed to the Bloom-block owners and back, equal
    sharded_adjudicate's on every rank, and the single-device verdicts
    of the same keys."""
    R, got = ranks
    single = jax_mesh["single"]
    valid = single["shard"] != 0xFFFFFFFF
    key = {(int(s), int(k)): bool(f) for s, k, f in zip(
        single["shard"][valid], single["keybody"][valid],
        jax_mesh[f"single_fp_{shift}"][valid])}
    n_hits = 0
    for r in range(R):
        fp = got[r][f"fp_{shift}"]
        _same(fp, jax_mesh[f"fp_{shift}"][r], f"rank {r}")
        want = [key[(int(s), int(k))] for s, k in zip(
            got[r]["agg_shard"], got[r]["agg_keybody"])]
        _same(fp, np.array(want), f"rank {r} against one device")
        n_hits += int(fp.sum())
    assert n_hits > 0


def test_payloads_match_payloads_sharded(ranks, jax_mesh):
    R, got = ranks
    for r in range(R):
        want = jax_mesh["pay"][r]
        assert int(got[r]["pay_n"]) == want["n"] > 0
        for f in ("shard", "keybody", "payload", "hist", "hist_high"):
            _same(got[r][f"pay_{f}"], want[f], f"rank {r} {f}")


# --------------------------------------------------------------------------
# End to end, through the CLI and the launcher
# --------------------------------------------------------------------------

def _port_cli(*args, env=None, check=True, stdin=None, timeout=None):
    # one intra-op thread a process: the ranks share the suite's cores
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               **(env or {}))
    return subprocess.run([sys.executable, "-m", "bfc_tpu_torch", "--cpu",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          check=check, stdin=stdin, timeout=timeout)


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """The dataset, the single-device port's output and bfc_tpu's scalar
    spec's."""
    from bfc_tpu.models import pipeline as JP
    from bfc_tpu.opts import Opts as JOpts

    d = tmp_path_factory.mktemp("mesh_e2e")
    fq = datagen.standard_dataset(str(d), genome_len=8000, n_reads=2400,
                                  name="m.fq")
    o = JOpts()
    o.k = 17
    o.bf_shift = 22
    return fq, _port_cli("-k17", "-b22", fq).stdout, JP.run(o, fq).encode()


def test_single_device_matches_scalar_spec(e2e):
    fq, single, spec_out = e2e
    assert single.count(b"\n") == 4 * 2400
    assert single == spec_out


@pytest.mark.parametrize("R,flags", [(2, ["-L", "50000"]),
                                     (4, ["--batch", "1199"])],
                         ids=["mesh2", "mesh4"])
def test_cli_mesh_matches_single_device(e2e, R, flags):
    """-L 50000 cuts five counting and five correction batches; --batch
    1199 leaves a last batch of 2 reads, so ranks 0 and 2 have none."""
    fq, single, spec_out = e2e
    r = _port_cli("--mesh", str(R), *flags, "-k17", "-b22", fq)
    assert r.stdout == single == spec_out
    assert f"over {R} devices".encode() in r.stderr


@pytest.mark.parametrize("operands", [("-", "FQ"), ("-", "-"), ("-",)],
                         ids=["stdin_file", "stdin_stdin", "stdin"])
def test_cli_mesh_reads_stdin_once(e2e, operands):
    """The launcher reads stdin once: the first `-` counts all of it, and a
    later `-` (or a lone `-`'s correction pass) finds it consumed, as the
    single-device run does."""
    fq, single, _ = e2e
    args = [fq if a == "FQ" else a for a in operands]
    if operands == ("-", "FQ"):
        want = single
    else:
        with open(fq, "rb") as f:
            want = _port_cli("-k17", "-b22", *args, stdin=f,
                             timeout=120).stdout
        assert want == b""
    with open(fq, "rb") as f:
        r = _port_cli("--mesh", "2", "-k17", "-b22", *args, stdin=f,
                      timeout=120)
    assert r.stdout == want
    assert b"over 2 devices" in r.stderr


def test_spool_stdin_replaces_dash_operands(tmp_path):
    import io

    from bfc_tpu_torch.parallel import multihost

    src = io.BytesIO(b"@r\nACGT\n+\nIIII\n")
    got = multihost.spool_stdin(["-k17", "-d", "-", "-", "x.fq", "-"],
                                str(tmp_path), src)
    spooled, empty = str(tmp_path / "stdin"), str(tmp_path / "empty")
    assert got == ["-k17", "-d", "-", spooled, "x.fq", empty]
    assert Path(spooled).read_bytes() == b"@r\nACGT\n+\nIIII\n"
    assert Path(empty).read_bytes() == b""
    assert multihost.spool_stdin(["-"], str(tmp_path),
                                 io.BytesIO()) == [spooled, empty]
    assert multihost.spool_stdin(["a.fq"], str(tmp_path),
                                 io.BytesIO()) == ["a.fq"]


def test_torchrun_worker_refuses_stdin(monkeypatch):
    from bfc_tpu_torch.parallel import multihost

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="stdin"):
        multihost.worker_main(["--cpu", "-k17", "-"])


def test_trim_ignores_the_mesh(e2e):
    fq = e2e[0]
    want = _port_cli("-1", "-k17", "-b22", fq).stdout
    assert 0 < want.count(b"\n")
    assert _port_cli("--mesh", "2", "-1", "-k17", "-b22", fq).stdout == want


def test_a_failed_rank_fails_the_launch(tmp_path):
    """A missing input fails every rank: the launcher returns non-zero."""
    r = _port_cli("--mesh", "2", str(tmp_path / "absent.fq"), check=False)
    assert r.returncode != 0 and r.stdout == b""


def test_ranks_run_the_launchers_package(tmp_path, monkeypatch):
    """The ranks import the package the launcher belongs to, not one that
    shadows it in the working directory: a decoy there whose rank entry
    exits 7 must not run (the real rank fails on the missing input)."""
    from bfc_tpu_torch.parallel import multihost

    decoy = tmp_path / "bfc_tpu_torch" / "parallel"
    decoy.mkdir(parents=True)
    (tmp_path / "bfc_tpu_torch" / "__init__.py").write_text("")
    (decoy / "__init__.py").write_text("")
    (decoy / "multihost.py").write_text("import sys\nsys.exit(7)\n")
    monkeypatch.chdir(tmp_path)
    rc = multihost.launch(1, ["--cpu", str(tmp_path / "absent.fq")],
                          stdout=subprocess.DEVNULL)
    assert rc not in (0, 7)


def test_wait_all_kills_blocked_peers():
    """One rank exits 1 while its peer would block for ten minutes: the
    launcher's wait returns non-zero within its grace and kills the peer."""
    from bfc_tpu_torch.parallel import multihost

    procs = [subprocess.Popen([sys.executable, "-c", code]) for code in
             ("import sys; sys.exit(1)", "import time; time.sleep(600)")]
    t0 = time.time()
    assert multihost.wait_all(procs, grace_s=1.0) == 1
    assert time.time() - t0 < 30
    assert procs[1].poll() is not None


def test_nccl_needs_a_card_a_rank(monkeypatch):
    from bfc_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--backend gloo"):
        multihost.device_for("nccl", 1, 2, cpu=False)
    assert multihost.device_for("gloo", 1, 2, cpu=False) == "cuda:0"
    assert multihost.device_for("nccl", 0, 1, cpu=False) == "cuda:0"
    assert multihost.device_for("gloo", 3, 4, cpu=True) == "cpu"
