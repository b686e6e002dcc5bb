"""The probe kernels KO-KR (bfc_tpu_torch/ops/probe.py) against the
repo's Pallas kernels, run in interpret mode on JAX-CPU.

Each Pallas kernel is re-stated here from the cited lines of the TPU
probe scripts (scripts/tpu_probe_r2.py, tpu_probe2.py, tpu_probe4.py,
tpu_session_gather.py: the scripts run every section when imported, so
they cannot be imported), at small sizes (tables of 2^10 to 2^12
entries, up to 256 queries, the probes' own step counts), with the same
memory spaces, scalar loops, DMA slots and chunks, and
`interpret=True`.  A loop around a pallas_call (tpu_probe2.py:213, :245,
tpu_probe4.py:206) is the same jax.lax.fori_loop here.  The same
numpy-seeded inputs go to the port's wrapper on CPU tensors, which runs
the plain version.  Every value is an integer: the tolerance is exact
equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import chip_probe
from bfc_tpu_torch.ops import probe as P

VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)
SMEM = pl.BlockSpec(memory_space=pltpu.SMEM)
ANY = pl.BlockSpec(memory_space=pltpu.ANY)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _u32_table(rng, n):
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _fori(K, body, init):
    return jax.jit(lambda x: jax.lax.fori_loop(0, K, body, x))(init)


# --------------------------------------------------------------------------
# KO: flat gathers (tpu_probe_r2.py s4b-s4e, tpu_probe4.py sD,
# tpu_session_gather.py sE)
# --------------------------------------------------------------------------

def pallas_s4b(idx, tab):
    """tpu_probe_r2.py:192-210, the scalar-loop gather."""
    Q = idx.shape[0]

    def kern(i_ref, t_ref, o_ref):
        def body(i, _):
            j = i_ref[i]
            o_ref[i] = t_ref[j]
            return 0
        jax.lax.fori_loop(0, Q, body, 0)

    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((Q,), tab.dtype),
        in_specs=[SMEM, VMEM], out_specs=SMEM, interpret=True)(idx, tab)


def pallas_s4c(idx, tab):
    """tpu_probe_r2.py:225-237, the vector take."""
    Q = idx.shape[0]

    def kern(i_ref, t_ref, o_ref):
        o_ref[:] = jnp.take(t_ref[:], i_ref[:], axis=0)

    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((Q,), tab.dtype),
        in_specs=[VMEM, VMEM], out_specs=VMEM, interpret=True)(idx, tab)


def pallas_s4d(idx, tab2):
    """tpu_probe_r2.py:258-275, row read and one-hot lane select."""
    Q = idx.shape[0]

    def kern(i_ref, t_ref, o_ref):
        def body(i, _):
            j = i_ref[i]
            row = t_ref[j >> 7]
            lane = j & 127
            oh = jax.lax.broadcasted_iota(jnp.int32, (128,), 0) == lane
            o_ref[i] = jnp.sum(jnp.where(oh, row, 0)).astype(jnp.uint32)
            return 0
        jax.lax.fori_loop(0, Q, body, 0)

    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((Q,), jnp.uint32),
        in_specs=[SMEM, VMEM], out_specs=SMEM, interpret=True)(idx, tab2)


def pallas_dma_gather(idx, tab, nslot):
    """tpu_probe_r2.py:287-329 (nslot 8, u32) and tpu_probe4.py:158-195
    (nslot 16, i32): a per-element DMA from an HBM table, nslot in
    flight."""
    Q = idx.shape[0]

    def kern(i_ref, t_hbm, o_ref):
        def run(scratch, sems):
            def dma(slot, qi):
                return pltpu.make_async_copy(
                    t_hbm.at[pl.ds(i_ref[qi], 1)],
                    scratch.at[pl.ds(slot, 1)],
                    sems.at[slot])
            for s in range(nslot):
                dma(s, s).start()

            def body(q, _):
                slot = jax.lax.rem(q, nslot)
                dma(slot, q).wait()
                o_ref[q] = scratch[slot]

                @pl.when(q + nslot < Q)
                def _():
                    dma(slot, q + nslot).start()
                return 0
            jax.lax.fori_loop(0, Q, body, 0)

        pl.run_scoped(run, scratch=pltpu.VMEM((nslot,), tab.dtype),
                      sems=pltpu.SemaphoreType.DMA((nslot,)))

    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((Q,), tab.dtype),
        in_specs=[SMEM, ANY], out_specs=SMEM, interpret=True)(idx, tab)


def pallas_flat_lookup(tab2, qidx, N, CH, K):
    """tpu_session_gather.py:180-218 (sE): each round fetches every
    query's row by broadcast, extracts its lane, in chunks of CH queries;
    K rounds of ix = (ix + v) & (N - 1).  Returns the final ix."""
    Qr = qidx.shape[0]

    def kern(t_ref, i_ref, o_ref):
        def one_round(ix):
            out = jnp.zeros_like(ix)
            for c in range(Qr // (CH // 128)):
                blk = ix[c * (CH // 128):(c + 1) * (CH // 128)]
                flat_row = (blk >> 7).reshape(CH, 1)
                rows = jnp.take_along_axis(
                    t_ref[:], jnp.broadcast_to(flat_row, (CH, 128)), axis=0)
                lane = (blk & 127).reshape(CH, 1)
                v = jnp.take_along_axis(rows, lane, axis=1)
                out = out.at[c * (CH // 128):(c + 1) * (CH // 128)].set(
                    v.reshape(CH // 128, 128))
            return out

        def body(s, ix):
            return (ix + one_round(ix)) & (N - 1)

        o_ref[:] = jax.lax.fori_loop(0, K, body, i_ref[:])

    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(qidx.shape, jnp.int32),
        in_specs=[VMEM, VMEM], out_specs=VMEM, interpret=True)(tab2, qidx)


@pytest.mark.parametrize("site,seed", [("s4b", 3), ("s4c", 4), ("s4e", 6)])
def test_ko_flat_gather_r2(site, seed):
    """tpu_probe_r2.py s4b (:204), s4c (:231), s4e (:323): one gather of a
    u32 table."""
    rng = np.random.default_rng(seed)
    N, Q = 1 << (12 if site == "s4e" else 10), 256
    tab = _u32_table(rng, N)
    idx = rng.integers(0, N, Q).astype(np.int32)
    if site == "s4b":
        want = pallas_s4b(jnp.asarray(idx), jnp.asarray(tab))
    elif site == "s4c":
        want = pallas_s4c(jnp.asarray(idx), jnp.asarray(tab))
    else:
        want = pallas_dma_gather(jnp.asarray(idx), jnp.asarray(tab), 8)
    v, ix = P.flat_gather(_t(tab.view(np.int32)), _t(idx))
    _same(v, np.asarray(want).view(np.int32))
    _same(ix, (idx.astype(np.int64) + tab[idx]) & (N - 1))


def test_ko_flat_gather_r2_s4d():
    """tpu_probe_r2.py s4d (:269): the table as [N/128, 128] rows."""
    rng = np.random.default_rng(5)
    N, Q = 1 << 11, 256
    tab = _u32_table(rng, N).reshape(N // 128, 128)
    idx = rng.integers(0, N, Q).astype(np.int32)
    want = pallas_s4d(jnp.asarray(idx), jnp.asarray(tab))
    v, _ = P.flat_gather(_t(tab.reshape(-1).view(np.int32)), _t(idx))
    _same(v, np.asarray(want).view(np.int32))


@pytest.mark.parametrize("K", [1, 8])
def test_ko_flat_gather_probe4(K):
    """tpu_probe4.py sD (:189; :206 in a loop of 8): the 16-slot DMA
    gather of an i32 table, the loop's ix = (ix + v) & (N - 1)."""
    rng = np.random.default_rng(40 + K)
    N, Q = 1 << 12, 256
    tab = rng.integers(-(1 << 31), 1 << 31, N).astype(np.int32)
    idx = rng.integers(0, N, Q).astype(np.int32)
    jtab = jnp.asarray(tab)

    def body(i, ix):
        return (ix + pallas_dma_gather(ix, jtab, 16)) & (N - 1)

    v, ix = P.flat_gather(_t(tab), _t(idx), steps=K)
    if K == 1:
        _same(v, pallas_dma_gather(jnp.asarray(idx), jtab, 16))
    _same(ix, _fori(K, body, jnp.asarray(idx)))


def test_ko_flat_lookup_session_gather():
    """tpu_session_gather.py sE (:180): 4 rounds of the chunked flat
    lookup (chunks of 128 queries here, of 512 there)."""
    rng = np.random.default_rng(7)
    N, Q = 1 << 12, 256
    tab = rng.integers(0, 1 << 30, N).astype(np.int32)
    idx = rng.integers(0, N, Q).astype(np.int32)
    want = pallas_flat_lookup(jnp.asarray(tab.reshape(N // 128, 128)),
                              jnp.asarray(idx.reshape(Q // 128, 128)),
                              N, 128, 4)
    _, ix = P.flat_gather(_t(tab), _t(idx), steps=4)
    _same(ix, np.asarray(want).reshape(-1))


# --------------------------------------------------------------------------
# KP: row, column and lane gathers (tpu_probe2.py sD, tpu_session_gather.py
# sC, sD)
# --------------------------------------------------------------------------

def pallas_row_take(idx, tab):
    """tpu_probe2.py:190-203 (D1)."""
    Q = idx.shape[0]

    def kern1(i_ref, t_ref, o_ref):
        o_ref[:] = jnp.take(t_ref[:], i_ref[:], axis=0)

    return pl.pallas_call(
        kern1, out_shape=jax.ShapeDtypeStruct((Q, 128), jnp.int32),
        in_specs=[VMEM, VMEM], out_specs=VMEM, interpret=True)(idx, tab)


def pallas_column_take(idx2, tab):
    """tpu_probe2.py:227-239 (D2)."""
    def kern2(i_ref, t_ref, o_ref):
        o_ref[:] = jnp.take_along_axis(t_ref[:], i_ref[:], axis=0)

    return pl.pallas_call(
        kern2, out_shape=jax.ShapeDtypeStruct(idx2.shape, jnp.int32),
        in_specs=[VMEM, VMEM], out_specs=VMEM, interpret=True)(idx2, tab)


def pallas_in_kernel_chain(tab, ix0, K, axis, mask):
    """tpu_session_gather.py sC (:135, axis 1, mask 127) and sD (:159,
    axis 0, mask R - 1): K steps inside the kernel; returns the final ix."""
    def kern(t_ref, i_ref, o_ref):
        def body(s, ix):
            v = jnp.take_along_axis(t_ref[:], ix, axis=axis)
            return (ix + v) & mask
        o_ref[:] = jax.lax.fori_loop(0, K, body, i_ref[:])

    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(ix0.shape, jnp.int32),
        in_specs=[VMEM, VMEM], out_specs=VMEM, interpret=True)(tab, ix0)


@pytest.mark.parametrize("K", [1, 16])
def test_kp_row_probe2_d1(K):
    """tpu_probe2.py sD D1 (:196; :213 in a loop of 16 with ix = (ix +
    rows[:, 0]) & (R - 1))."""
    rng = np.random.default_rng(5 + K)
    R, Q = 32, 256
    tab = rng.integers(0, 1 << 31, (R, 128)).astype(np.int32)
    idx = rng.integers(0, R, Q).astype(np.int32)
    jtab = jnp.asarray(tab)

    def body(i, ix):
        return (ix + pallas_row_take(ix, jtab)[:, 0]) & (R - 1)

    out, ix = P.tile_gather(_t(tab), _t(idx), steps=K, mode=P.ROW)
    if K == 1:
        _same(out, pallas_row_take(jnp.asarray(idx), jtab))
    _same(ix, _fori(K, body, jnp.asarray(idx)))


@pytest.mark.parametrize("K", [1, 16])
def test_kp_column_probe2_d2(K):
    """tpu_probe2.py sD D2 (:233; :245 in a loop of 16)."""
    rng = np.random.default_rng(9 + K)
    R, Q = 16, 64
    tab = rng.integers(0, 1 << 31, (R, 128)).astype(np.int32)
    idx2 = rng.integers(0, R, (Q, 128)).astype(np.int32)
    jtab = jnp.asarray(tab)

    def body(i, ix):
        return (ix + pallas_column_take(ix, jtab)) & (R - 1)

    v, ix = P.tile_gather(_t(tab), _t(idx2), steps=K, mode=P.COLUMN)
    if K == 1:
        _same(v, pallas_column_take(jnp.asarray(idx2), jtab))
    _same(ix, _fori(K, body, jnp.asarray(idx2)))


def test_kp_lane_session_gather_sc():
    """tpu_session_gather.py sC (:135): the lane gather, 16 steps."""
    rng = np.random.default_rng(11)
    rows = rng.integers(0, 1 << 30, (24, 128)).astype(np.int32)
    lidx = rng.integers(0, 128, (24, 128)).astype(np.int32)
    want = pallas_in_kernel_chain(jnp.asarray(rows), jnp.asarray(lidx), 16,
                                  1, 127)
    _, ix = P.tile_gather(_t(rows), _t(lidx), steps=16, mode=P.LANE)
    _same(ix, want)


def test_kp_column_session_gather_sd():
    """tpu_session_gather.py sD (:159): the column gather, 16 steps."""
    rng = np.random.default_rng(12)
    R = 32
    tab = rng.integers(0, 1 << 30, (R, 128)).astype(np.int32)
    sidx = rng.integers(0, R, (16, 128)).astype(np.int32)
    want = pallas_in_kernel_chain(jnp.asarray(tab), jnp.asarray(sidx), 16,
                                  0, R - 1)
    _, ix = P.tile_gather(_t(tab), _t(sidx), steps=16, mode=P.COLUMN)
    _same(ix, want)


# --------------------------------------------------------------------------
# KQ: the one-hot passes (tpu_probe_r2.py s4a, tpu_probe2.py sE,
# tpu_session_gather.py sF)
# --------------------------------------------------------------------------

def _passes(x, pos, B, S, n=30):
    """tpu_probe_r2.py:158-163 (the same at tpu_probe2.py:283-289 and
    tpu_session_gather.py:224-230)."""
    cols = jax.lax.broadcasted_iota(jnp.int32, (B, S), 1)
    for i in range(n):
        oh = cols == (pos[:, None] + i) % S
        v = jnp.sum(jnp.where(oh, x, 0), axis=1, dtype=jnp.int32)
        x = jnp.where(oh, v[:, None] + 1, x)
    return x


def pallas_passes(x, pos):
    """tpu_probe_r2.py:165-177 (s4a) and tpu_probe2.py:291-301 (sE)."""
    B, S = x.shape

    def kern(x_ref, p_ref, o_ref):
        o_ref[:] = _passes(x_ref[:], p_ref[:], B, S)

    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((B, S), jnp.int32),
        in_specs=[VMEM, VMEM], out_specs=VMEM, interpret=True)(x, pos)


def pallas_passes_in_kernel(p_col, x, K):
    """tpu_session_gather.py:235-245 (sF): K steps inside the kernel, pos
    from p_ref[:, 0]."""
    B, S = x.shape

    def kern(p_ref, x_ref, o_ref):
        def body(s, x):
            return _passes(x, p_ref[:, 0], B, S)
        o_ref[:] = jax.lax.fori_loop(0, K, body, x_ref[:])

    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((B, S), jnp.int32),
        in_specs=[VMEM, VMEM], out_specs=VMEM, interpret=True)(p_col, x)


def _kq_inputs(seed, B=64):
    rng = np.random.default_rng(seed)
    x = rng.integers(-(1 << 20), 1 << 20, (B, 128)).astype(np.int32)
    pos = (np.arange(B) % 128).astype(np.int32)
    pos[B // 2:] = rng.integers(0, 128, B - B // 2)
    return x, pos


@pytest.mark.parametrize("variant", [P.REGISTERS, P.SHARED])
@pytest.mark.parametrize("site,K", [("r2_s4a", 1), ("probe2_sE", 32),
                                    ("session_sF", 16)])
def test_kq_onehot_passes(site, K, variant):
    """s4a (:172) one step; tpu_probe2.py sE (:296) in a loop of 32;
    tpu_session_gather.py sF (:221) 16 steps inside the kernel."""
    x, pos = _kq_inputs(len(site) + K)
    jx, jpos = jnp.asarray(x), jnp.asarray(pos)
    if site == "r2_s4a":
        want = pallas_passes(jx, jpos)
    elif site == "probe2_sE":
        want = _fori(K, lambda i, x: pallas_passes(x, jpos), jx)
    else:
        want = pallas_passes_in_kernel(jpos[:, None], jx, K)
    got = P.onehot_passes(_t(x), _t(pos), steps=K, variant=variant)
    _same(got, want)


# --------------------------------------------------------------------------
# KR: the two-probe, two-plane lookup (tpu_session_gather.py sG)
# --------------------------------------------------------------------------

def pallas_two_plane(lo, hi, qidx, N, CH, K):
    """tpu_session_gather.py:257-291 (sG), chunks of CH queries."""
    Q = qidx.size

    def fetch(t_ref, blk):
        flat_row = (blk >> 7).reshape(CH, 1)
        rows = jnp.take_along_axis(
            t_ref[:], jnp.broadcast_to(flat_row, (CH, 128)), axis=0)
        lane = (blk & 127).reshape(CH, 1)
        return jnp.take_along_axis(rows, lane, axis=1).reshape(CH // 128, 128)

    def kern(lo_ref, hi_ref, i_ref, o_ref):
        def one(ix):
            out = jnp.zeros_like(ix)
            for c in range(Q // CH):
                blk = ix[c * (CH // 128):(c + 1) * (CH // 128)]
                s2 = (blk * jnp.int32(-1640531527)) & (N - 1)
                l1 = fetch(lo_ref, blk)
                h1 = fetch(hi_ref, blk)
                l2 = fetch(lo_ref, s2)
                h2 = fetch(hi_ref, s2)
                m1 = (h1 ^ blk) < (1 << 16)
                v = jnp.where(m1, l1,
                              jnp.where((h2 ^ blk) < (1 << 16), l2, -1))
                out = out.at[c * (CH // 128):(c + 1) * (CH // 128)].set(v)
            return out

        def body(s, ix):
            return (ix + one(ix)) & (N - 1)

        o_ref[:] = jax.lax.fori_loop(0, K, body, i_ref[:])

    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(qidx.shape, jnp.int32),
        in_specs=[VMEM, VMEM, VMEM], out_specs=VMEM,
        interpret=True)(lo, hi, qidx)


@pytest.mark.parametrize("planes", ["probe", "hits"])
def test_kr_two_plane_session_gather_sg(planes):
    """tpu_session_gather.py sG (:257): 4 steps.  "probe" draws hi as the
    script does ([0, 2^30): nearly every probe misses, v = -1); "hits"
    from [-2^17, 2^17), so both slots match often and negative hi ^ ix
    compares below 2^16 as a signed i32."""
    rng = np.random.default_rng(13)
    N, Q = 1 << 12, 256
    lo = rng.integers(-(1 << 30), 1 << 30, N).astype(np.int32)
    if planes == "probe":
        hi = rng.integers(0, 1 << 30, N).astype(np.int32)
    else:
        hi = rng.integers(-(1 << 17), 1 << 17, N).astype(np.int32)
    idx = rng.integers(0, N, Q).astype(np.int32)
    want = pallas_two_plane(jnp.asarray(lo.reshape(N // 128, 128)),
                            jnp.asarray(hi.reshape(N // 128, 128)),
                            jnp.asarray(idx.reshape(Q // 128, 128)),
                            N, 128, 4)
    _, ix = P.two_plane(_t(lo), _t(hi), _t(idx), steps=4)
    _same(ix, np.asarray(want).reshape(-1))


# --------------------------------------------------------------------------
# The wrappers' checks
# --------------------------------------------------------------------------

def test_wrappers_refuse_bad_shapes():
    t = torch.zeros(1000, dtype=torch.int32)
    i = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        P.flat_gather(t, i)
    with pytest.raises(ValueError, match="dtype"):
        P.flat_gather(torch.zeros(1024, dtype=torch.int64), i)
    with pytest.raises(ValueError, match="steps"):
        P.two_plane(t[:512], t[:512], i, steps=0)
    with pytest.raises(ValueError, match="shape"):
        P.tile_gather(torch.zeros((8, 64), dtype=torch.int32), i)
    with pytest.raises(ValueError, match="mode"):
        P.tile_gather(torch.zeros((8, 128), dtype=torch.int32), i,
                      mode="diagonal")
    with pytest.raises(ValueError, match="variant"):
        P.onehot_passes(torch.zeros((8, 128), dtype=torch.int32), i,
                        variant="global")


def _small(s):
    """A chip_probe site cut to a CPU size, its recipe kept."""
    if s.kernel == "KQ":
        return s._replace(n=64, q=64)
    if s.mode == P.LANE:
        return s._replace(n=16 * 128, q=16)
    return s._replace(n=min(s.n, 1 << 12), q=min(s.q, 256))


def test_chip_probe_path_on_the_cpu():
    """chip_probe.py's probe path, every site cut to a small size, on CPU
    tensors (the plain versions): inputs, the one launch a site, the
    check and the bound; and each library call computes the site's
    function."""
    sites = [_small(s) for s in chip_probe.SITES]
    rows, launches = chip_probe.run(torch.device("cpu"), sites=sites,
                                    timed=False)
    assert [r["mismatches"] for r in rows] == [0] * len(sites)
    assert all(r["bound_ms"] > 0 for r in rows)
    assert set(chip_probe.KERNEL.values()) <= set(launches)
    for s in sites:
        inp = chip_probe.make_inputs(s, torch.device("cpu"))
        lib, what = chip_probe.library_call(s, inp)
        want = chip_probe.plain_call(s, inp)[0]
        if s.kernel == "KR":
            assert lib is None and what.startswith("none")
        else:
            torch.testing.assert_close(lib().to(torch.int32), want, rtol=0,
                                       atol=0)


def test_chip_probe_covers_every_site():
    """Every pl.pallas_call site of the table has a chip_probe site, and
    KO and KR also run over 256 MiB, beyond the card's L2."""
    cited = [s.replaces for s in chip_probe.SITES]
    for site in ("tpu_probe_r2.py:172", "tpu_probe_r2.py:204",
                 "tpu_probe_r2.py:231", "tpu_probe_r2.py:269",
                 "tpu_probe_r2.py:323", "tpu_probe2.py:196",
                 "tpu_probe2.py:213", "tpu_probe2.py:233",
                 "tpu_probe2.py:245", "tpu_probe2.py:296",
                 "tpu_probe4.py:189", "tpu_probe4.py:206", "(sC, :135)",
                 "(sD, :159)", "(sE, :180)", "(sF, :221)", "(sG, :257)"):
        assert any(site in c for c in cited), site
    big = {(s.kernel, 4 * s.n * (2 if s.kernel == "KR" else 1))
           for s in chip_probe.SITES if s.name.startswith("hbm_")}
    assert big == {("KO", 1 << 28), ("KR", 1 << 28)}
    names = {(s.name, s.mode) for s in chip_probe.SITES}
    assert set(chip_probe.REPRESENTATIVE.values()) <= names


@pytest.mark.parametrize("mode", [P.ROW, P.COLUMN, P.LANE])
def test_kp_route_by_shape(mode):
    """KP's route (tile_route): column mode stages its four lanes' columns
    where they fit a block's 128 KiB (up to 8,192 rows) and a lane's
    chains take more steps in all than its column has entries (queries *
    steps > rows); row mode walks the table; lane mode stages its rows."""
    route = P.tile_route
    if mode == P.COLUMN:
        assert route(8192, mode, 16, 2048) == P.SHARED
        assert route(8192, mode, 2, 8192) == P.SHARED
        assert route(8192, mode, 1, 8192) == P.GLOBAL
        assert route(8192, mode, 4, 2048) == P.GLOBAL
        assert route(1, mode, 1, 2) == P.SHARED
        assert route(16384, mode, 64, 8192) == P.GLOBAL
    elif mode == P.ROW:
        assert route(1, mode, 64, 1) == P.GLOBAL
        assert route(8192, mode, 16, 8192) == P.GLOBAL
        assert route(65536, mode, 64, 8192) == P.GLOBAL
    else:
        assert route(1 << 20, mode, 1, 1 << 20) == P.SHARED


def test_chip_probe_kp_routes():
    """The probe path's KP sites (8,192 rows a table, and sC's 2,048): the
    column sites stage where a lane's chains take more steps than its
    column has entries (sg_sD, p2_sD2_loop, not p2_sD2's one step), the
    row sites walk the table, lane mode always stages; the other kernels'
    sites have no route."""
    kp = {s.name: s for s in chip_probe.SITES if s.kernel == "KP"}
    assert set(kp) == {"p2_sD1", "p2_sD1_loop", "p2_sD2", "p2_sD2_loop",
                       "sg_sC", "sg_sD"}
    shared = {n for n, s in kp.items() if chip_probe.route(s) == P.SHARED}
    assert shared == {"p2_sD2_loop", "sg_sC", "sg_sD"}
    assert {chip_probe.route(s) for s in kp.values()} == {P.SHARED,
                                                          P.GLOBAL}
    assert all(chip_probe.route(s) == "" for s in chip_probe.SITES
               if s.kernel not in ("KP", "KR"))


def test_kr_route_by_shape():
    """KR's route (two_plane_route): the lazy route (hi at both slots,
    then lo where one matched) from KR_LAZY_QUERIES queries, where the
    chains fill the card; the eager one (four loads in one round) below,
    at any steps."""
    route, n = P.two_plane_route, P.KR_LAZY_QUERIES
    for steps in (1, 4, 64):
        assert route(n, steps) == P.LAZY
        assert route(1 << 22, steps) == P.LAZY
        assert route(n - 1, steps) == P.EAGER
        assert route(8192, steps) == P.EAGER
        assert route(1, steps) == P.EAGER


def test_chip_probe_kr_routes():
    """The probe path's KR sites: sG's 32,768 queries and the 32,768- and
    4,194,304-query sites over 256 MiB take the lazy route, the 8,192-
    query sites (4 and 64 steps) the eager one."""
    kr = {chip_probe.label(s): chip_probe.route(s) for s in chip_probe.SITES
          if s.kernel == "KR"}
    assert kr == {"sg_sG": P.LAZY, "hbm_KR_q8192": P.EAGER,
                  "hbm_KR_q8192_k64": P.EAGER, "hbm_KR_q32768": P.LAZY,
                  "hbm_KR_q4194304": P.LAZY}


def _kr_inputs(hi, q=64, seed=9):
    rng = np.random.default_rng(seed)
    n = hi.shape[0]
    return {"lo": _t(rng.integers(0, 1 << 30, n).astype(np.int32)),
            "hi": _t(hi.astype(np.int32)),
            "idx": _t(rng.integers(0, n, q).astype(np.int32))}


@pytest.mark.parametrize("case", ["KO", "KP_row", "KR_miss", "KR_first"])
def test_chip_probe_counts_the_sectors_read(case, monkeypatch):
    """work() charges the sectors the function reads for this run's data:
    KO one a step; KP row the first word of each row passed and the whole
    last row; KR hi at both slots where the first misses and lo only at a
    slot that matches.  A table that fits L2 is charged each distinct
    sector once (the bound then is no floor for the timed calls), a
    larger one a sector an access."""
    cpu = torch.device("cpu")
    n, q, K = 1 << 12, 64, 4
    if case == "KO":
        s = chip_probe.Site("t", "", "KO", "", n, q, K, "i30", 1)
        inp, want = chip_probe.make_inputs(s, cpu), q * K
    elif case == "KP_row":
        s = chip_probe.Site("t", "", "KP", P.ROW, n, q, K, "i31", 1)
        inp, want = chip_probe.make_inputs(s, cpu), q * (K - 1) + 16 * q
    else:   # hi 2^30 never matches (v = -1); hi[j] = j matches slot 1
        s = chip_probe.Site("t", "", "KR", "", n, q, K, "planes", 1)
        hi = (np.full(n, 1 << 30) if case == "KR_miss" else np.arange(n))
        inp, want = _kr_inputs(hi, q), 2 * q * K
    ids = chip_probe.touched(s, inp)
    assert ids.numel() == want
    if case == "KR_miss":
        assert int(ids.max()) < n // 8     # the hi plane only
    if case == "KR_first":
        assert int((ids >= n // 8).sum()) == q * K   # lo at slot 1
    assert chip_probe.start_sets(s, inp, cpu) == [inp]
    g, sectors, nbytes, _, _, floor = chip_probe.work(s, [inp])
    io = nbytes - 32 * int(torch.unique(ids).numel())
    assert (sectors, floor) == (want, False) and io > 0
    # beyond L2: a sector an access, over fresh start indices a timed call
    # (a replay reads 4x the L2: here 4 sets)
    monkeypatch.setattr(chip_probe, "L2_BYTES", 32 * q * K)
    sets = chip_probe.start_sets(s, inp, cpu)
    assert len(sets) == 4 and sets[0] is inp
    assert not torch.equal(sets[1]["idx"], inp["idx"])
    g, sectors, nbytes, _, _, floor = chip_probe.work(s, sets[:1])
    assert (sectors, nbytes, floor) == (want, 32 * want + io, True)
    mean = np.mean([chip_probe.touched(s, x).numel() for x in sets])
    assert chip_probe.work(s, sets)[1] == mean
