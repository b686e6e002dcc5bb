"""The port's prefix-sharded table (BFC_TPU_SHARD_TABLE=1) and -d/-r
against bfc_tpu's.

The sharded finalize runs in spawned gloo ranks at R = 2 and R = 4 on the
batch of tests/test_torch_mesh.py (a 5 kb genome from seed 51, 1,024
reads of 100 bp from seed 52; k 17, l_pre 20, -b22, H 4): each rank's
kept entries all belong to its own sub-table under the table rule (the
counting route's owner is the sub-table's); cb_local equals the one
bfc_tpu's _finalize_sharded gives on make_mesh(R) for the same reads;
and the port's sub-tables, wrapped as bfc_tpu's ShardedCuckoo, answer
bfc_tpu's sharded_cuckoo_lookup for every kept entry and 4,000 seeded
absent keys exactly as the port's plain sharded lookup (in the ranks) and
a replicated table of the same entries do.

End to end, on datagen.standard_dataset (an 8 kb genome, 2,400 reads,
-k17 -b22): `python -m bfc_tpu_torch --cpu --mesh 2` and `--mesh 4` with
BFC_TPU_SHARD_TABLE=1 are byte-identical to the single-device port and to
bfc_tpu's scalar spec (models/pipeline.run); --mesh 3 keeps the
replicated table and says so; -d writes bfc_tpu's dump byte for byte,
from one device and from the sharded mesh; -r gives the counted run's
output, on one device and over the sharded --mesh 2; trim mode ignores
-d, as bfc_tpu does.

The ranks meet through a file in tmp_path.  This module imports neither
jax nor bfc_tpu at its top: spawned ranks import it again.  Tolerance:
exact equality throughout (every value is an integer or a byte)."""

import os

import numpy as np
import pytest
import torch

from . import datagen
from .test_torch_mesh import BF, H, K, L_PRE, _encoded_batch, _port_cli

N_ABSENT = 4000


def _absent_keys():
    """Seeded (shard, keybody) keys of the batch's layout, mostly absent."""
    from bfc_tpu_torch.ops import kmer as tk

    rng = np.random.default_rng(53)
    kb_bits = tk.keybody_bits(K, L_PRE)
    return (rng.integers(0, 1 << L_PRE, N_ABSENT),
            rng.integers(0, 1 << kb_bits, N_ABSENT))


def _rank_main(rank, R, init, out_dir):
    """One spawned rank: counting, verdict and payloads on its share of
    the batch, then the sharded table and lookups in it."""
    import torch.distributed as dist

    from bfc_tpu_torch.ops import spectrum as spec
    from bfc_tpu_torch.ops import spectrum_dense as sdn
    from bfc_tpu_torch.parallel import comm
    from bfc_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=R)
    bases, qok, lens = _encoded_batch()
    B, L = bases.shape
    step = B // R
    a = rank * step

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x[a:a + step]))

    run = pm.sharded_chunk_run(t(bases), t(qok), t(lens), a * L, K, L_PRE,
                               False)
    run = sdn.run_to_aggregate(run, K, L_PRE)
    fp = pm.sharded_adjudicate(run, BF, H)
    shard, keybody, payload, _, hist, hist_high = pm.sharded_payloads(run, fp)
    hist, hist_high = comm.all_reduce(hist), comm.all_reduce(hist_high)
    ds = pm.sharded_spectrum(shard, keybody, payload, hist, hist_high, K,
                             L_PRE, "KI", 0.0)
    tab = ds.table
    qs, qk = comm.all_gather_rows([shard, keybody])
    abs_s, abs_k = _absent_keys()
    qs = torch.cat([qs, torch.from_numpy(abs_s)])
    qk = torch.cat([qk, torch.from_numpy(abs_k)])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             shard=shard.numpy(), keybody=keybody.numpy(),
             payload=payload.numpy(), cb_local=np.int64(tab.cb_local),
             c_bits=np.int64(tab.c_bits), own=tab.subtables[rank].numpy(),
             by_rank=np.array(ds.entries_by_rank),
             n_entries=np.int64(ds.n_entries),
             lookup=spec.cuckoo_lookup_plain(tab, qs, qk).numpy())
    dist.destroy_process_group()


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    """(R, each rank's results) from R spawned gloo ranks."""
    import torch.multiprocessing as mp

    R = request.param
    d = tmp_path_factory.mktemp(f"sharded{R}")
    mp.spawn(_rank_main, args=(R, f"file://{d}/rendezvous", str(d)),
             nprocs=R)
    return R, [dict(np.load(d / f"rank{r}.npz")) for r in range(R)]


def test_kept_entries_are_their_ranks_subtable_keys(ranks):
    """The counting route (top log2 R bits of the l_pre prefix) hands each
    rank exactly the keys of its sub-table (top log2 R bits of the
    position key): no exchange is needed before KN."""
    from bfc_tpu_torch.ops import kmer as tk
    from bfc_tpu_torch.ops import route
    from bfc_tpu_torch.ops import spectrum as spec

    R, got = ranks
    kb_bits = tk.keybody_bits(K, L_PRE)
    db = R.bit_length() - 1
    for r in range(R):
        s = torch.from_numpy(got[r]["shard"])
        kb = torch.from_numpy(got[r]["keybody"])
        assert len(s) > 0
        owner = spec.subtable_owner(s, kb, L_PRE, kb_bits, db)
        assert bool((owner == r).all()), f"rank {r}"
        assert bool((route.dev_of_shard(s, L_PRE, R) == r).all())
        assert got[r]["by_rank"].tolist() == [len(g["shard"]) for g in got]


@pytest.fixture(scope="module")
def jax_sharded(ranks):
    """bfc_tpu on make_mesh(R) over the same batch: _finalize_sharded's
    table with shard_table on, and a lookup function on ShardedCuckoo
    u64 entries laid out [R << cb_local]."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from bfc_tpu.ops import kmer as jk
    from bfc_tpu.ops import spectrum as jspec
    from bfc_tpu.opts import Opts as JOpts
    from bfc_tpu.parallel import mesh as pmesh

    R = ranks[0]
    bases, qok, lens = (jnp.asarray(x) for x in _encoded_batch())
    B, L = bases.shape
    mesh = pmesh.make_mesh(R)
    mref = pmesh.MeshRef(mesh)
    cap = B * L // R
    agg, _, ovf = pmesh.sharded_chunk_aggregate(
        bases, qok, lens, jnp.uint64(0), K, L_PRE, cap, cap, mref)
    fp, ovf2 = pmesh.sharded_adjudicate(agg, BF, H, mref)
    assert not (bool(ovf) or bool(ovf2))
    o = JOpts()
    o.k, o.bf_shift, o.n_hashes = K, BF, H
    assert o.effective_l_pre() == L_PRE
    ds, sharded = pmesh._finalize_sharded(agg, fp, o, mesh, True)
    assert sharded
    kb_bits = jk.keybody_bits(K, L_PRE)

    def lookup(entries, c_bits, qs, qk):
        n = -(-len(qs) // R) * R
        pad = (lambda x, dt: np.concatenate(
            [x.astype(dt), np.zeros(n - len(x), dt)]))

        def step(e, s, k):
            occ, o = jspec.sharded_cuckoo_lookup(
                jspec.sharded_from_u64(e), s, k, c_bits, L_PRE, kb_bits, "d",
                R, slack=R)  # the queries come grouped by owner
            return occ, o[None]

        got, o = jax.jit(shard_map(
            step, mesh=mesh, in_specs=(P("d"), P("d"), P("d")),
            out_specs=(P("d"), P("d"))))(
            jax.device_put(jnp.asarray(entries), NamedSharding(mesh, P("d"))),
            jnp.asarray(pad(qs, np.uint32)), jnp.asarray(pad(qk, np.uint64)))
        assert not bool(jnp.any(o))
        return np.asarray(got)[:len(qs)].astype(np.int64)

    entries = (np.asarray(ds.table.lo).astype(np.uint64)
               | (np.asarray(ds.table.hi).astype(np.uint64) << np.uint64(32)))
    return {"c_bits": ds.s_bits, "n_entries": ds.n_entries,
            "entries": entries, "lookup": lookup}


def test_cb_local_matches_finalize_sharded(ranks, jax_sharded):
    R, got = ranks
    db = R.bit_length() - 1
    assert len(jax_sharded["entries"]) == R << int(got[0]["cb_local"])
    for r in range(R):
        assert int(got[r]["c_bits"]) == jax_sharded["c_bits"]
        assert int(got[r]["cb_local"]) == jax_sharded["c_bits"] - db
        assert int(got[r]["n_entries"]) == jax_sharded["n_entries"]


def test_subtables_answer_sharded_cuckoo_lookup(ranks, jax_sharded):
    """Every kept entry and N_ABSENT seeded keys: bfc_tpu's
    sharded_cuckoo_lookup on the port's sub-tables, on its own sub-tables,
    the port's plain sharded lookup in every rank, and a replicated table
    of the same entries all give the same payloads."""
    from bfc_tpu_torch.models import counter as TC
    from bfc_tpu_torch.ops import kmer as tk
    from bfc_tpu_torch.ops import spectrum as spec

    R, got = ranks
    cat = {f: np.concatenate([g[f] for g in got])
           for f in ("shard", "keybody", "payload")}
    abs_s, abs_k = _absent_keys()
    qs = np.concatenate([cat["shard"], abs_s])
    qk = np.concatenate([cat["keybody"], abs_k])
    want = np.concatenate([cat["payload"], np.full(N_ABSENT, -1)])
    kb_bits = tk.keybody_bits(K, L_PRE)
    c_bits = TC.table_c_bits(len(cat["shard"]), K, L_PRE)
    table, ok = spec.cuckoo_build_plain(
        *(torch.from_numpy(cat[f]) for f in ("shard", "keybody")),
        torch.from_numpy(cat["payload"]), K, L_PRE, kb_bits, c_bits)
    assert ok
    replicated = spec.cuckoo_lookup_plain(
        spec.SpecTable(table, K, L_PRE, kb_bits, c_bits),
        torch.from_numpy(qs), torch.from_numpy(qk)).numpy()
    hits = replicated != -1
    want = np.where(hits, want, -1)
    assert int((~hits[:len(cat["shard"])]).sum()) == 0
    assert int(hits[len(cat["shard"]):].sum()) < N_ABSENT // 100
    ours = np.concatenate([g["own"] for g in got]).view(np.uint64)
    c = int(got[0]["c_bits"])
    lookup = jax_sharded["lookup"]
    np.testing.assert_array_equal(lookup(ours, c, qs, qk), replicated)
    np.testing.assert_array_equal(
        lookup(jax_sharded["entries"], jax_sharded["c_bits"], qs, qk),
        replicated)
    for r in range(R):
        np.testing.assert_array_equal(got[r]["lookup"], replicated)
    np.testing.assert_array_equal(replicated, want)


# --------------------------------------------------------------------------
# End to end, through the CLI and the launcher
# --------------------------------------------------------------------------

SHARD = {"BFC_TPU_SHARD_TABLE": "1"}


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """The dataset, the single-device port's output and dump (-d), and
    bfc_tpu's scalar spec's output and dump."""
    from bfc_tpu.models import pipeline as JP
    from bfc_tpu.opts import Opts as JOpts

    d = tmp_path_factory.mktemp("sharded_e2e")
    fq = datagen.standard_dataset(str(d), genome_len=8000, n_reads=2400,
                                  name="s.fq")
    o = JOpts()
    o.k = 17
    o.bf_shift = 22
    spec_out = JP.run(o, fq, out_hash=str(d / "spec.dump")).encode()
    single = _port_cli("-k17", "-b22", "-d", str(d / "port.dump"), fq).stdout
    return {"fq": fq, "dir": d, "single": single, "spec": spec_out,
            "port_dump": (d / "port.dump").read_bytes(),
            "spec_dump": (d / "spec.dump").read_bytes()}


def test_dump_matches_bfc_tpu(e2e):
    assert e2e["single"] == e2e["spec"]
    assert len(e2e["port_dump"]) > 8 << 20  # 2^20 shard headers and keys
    assert e2e["port_dump"] == e2e["spec_dump"]


@pytest.mark.parametrize("R,flags", [(2, ["-L", "50000"]),
                                     (4, ["--batch", "1199"])],
                         ids=["mesh2", "mesh4"])
def test_sharded_mesh_matches_single_device(e2e, R, flags):
    """Each rank holds only its sub-table; rank 0 alone writes the -d
    dump, the ranks' entries gathered to it."""
    dump = e2e["dir"] / f"mesh{R}.dump"
    r = _port_cli("--mesh", str(R), *flags, "-k17", "-b22", "-d", str(dump),
                  e2e["fq"], env=SHARD)
    assert r.stdout == e2e["single"] == e2e["spec"]
    assert f"sharded over {R} devices".encode() in r.stderr
    assert dump.read_bytes() == e2e["spec_dump"]


def test_mesh3_keeps_the_replicated_table(e2e):
    r = _port_cli("--mesh", "3", "-k17", "-b22", e2e["fq"], env=SHARD)
    assert r.stdout == e2e["single"]
    assert b"correcting with a replicated table" in r.stderr
    assert b"sharded over" not in r.stderr


@pytest.mark.parametrize("flags", [[], ["--mesh", "2"]],
                         ids=["single", "mesh2-sharded"])
def test_restore_gives_the_counted_output(e2e, flags):
    """-r with another -k: the dump's k (17) wins, as in bfc_tpu."""
    r = _port_cli(*flags, "-k23", "-r", str(e2e["dir"] / "spec.dump"),
                  e2e["fq"], env=SHARD)
    assert r.stdout == e2e["single"]
    assert (b"sharded over 2 devices" in r.stderr) == bool(flags)


def test_trim_ignores_dump(e2e, tmp_path):
    """-1 with -d trims as -1 alone and writes no dump (bfc_tpu's
    pipeline.run ignores the hash files in trim mode)."""
    want = _port_cli("-1", "-k17", "-b22", e2e["fq"]).stdout
    got = _port_cli("-1", "-k17", "-b22", "-d", str(tmp_path / "x.dump"),
                    e2e["fq"]).stdout
    assert 0 < want.count(b"\n") and got == want
    assert not (tmp_path / "x.dump").exists()
