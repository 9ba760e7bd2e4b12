"""The shard plan, the banded face tables and K7's plain version == the JAX
package's, on the CPU.

* `build_shard_plan` against the JAX builder, field by field, at ne=4
  with 2, 4 and 8 shards, overlap ordering on and off;
* `build_sharded_face_tables` against the JAX builder at (ne, S) = (6, 1)
  (one band holds the sphere), (4, 4) (row-aligned chunks), (4, 8) and
  (6, 8) (chunks cut rows);
* `dss_band_plain` against the JAX `dss_band_pallas` in interpret mode, as
  tests/test_sharded_face.py runs it (ext built from halo_gid), in the
  raw, scale, scale + min/max and scale + min/max + Laplacian variants:
  bitwise, the Laplacian to 1e-12 (the JAX kernel's `_lap_wk` and the
  port's associate the 4x4 contractions differently, and the JAX band
  metric is folded in f64 before its cast);
* the role-table form K7 computes (`csrc/band.cu`), written out in PyTorch
  here, against `dss_band_plain`: bitwise, so the kernel's tables and add
  order are checked where no card is;
* the band against the single-device face DSS K4: bitwise except at the
  slots with three partners (interior element corners), where K4 adds
  (x + (x partner + corner)) + y partner and the band ((x + x partner) +
  y partner) + corner, as the JAX package's own two face assemblies do.
"""

import dataclasses
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transport_se_tpu.grid.cubesphere import build_grid as jbuild_grid
from transport_se_tpu.ops.dss_face import build_face_tables as jface_tables
from transport_se_tpu.ops.pallas_band import dss_band_pallas
from transport_se_tpu.parallel import face_sharded as jfs
from transport_se_tpu.parallel.halo import build_shard_plan as jbuild_plan
from transport_se_tpu_torch.grid.cubesphere import build_grid
from transport_se_tpu_torch.ops import band, dss_face as fk
from transport_se_tpu_torch.ops.euler import N2, metric_pack
from transport_se_tpu_torch.parallel import face_sharded as fs
from transport_se_tpu_torch.parallel.halo import build_shard_plan

torch.set_num_threads(1)

TIME_LIMIT = 240          # seconds per test


@pytest.fixture(autouse=True)
def time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"test ran over its {TIME_LIMIT} s limit")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _same_fields(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("overlap", [False, True])
def test_shard_plan_matches_jax(S, overlap):
    plan = build_shard_plan(build_grid(4), S, overlap=overlap)
    _same_fields(plan, jbuild_plan(jbuild_grid(4), S, overlap=overlap))
    assert (plan.nbound > 0) == overlap


def _tables(ne, S):
    g = build_grid(ne, order="raster")
    plan = build_shard_plan(g, S)
    ftd = fk.build_face_tables(g.part_idx, g.part_mask, ne)
    return g, plan, ftd, fs.build_sharded_face_tables(g, plan, ftd)


@pytest.mark.parametrize("ne,S", [(6, 1), (4, 4), (4, 8), (6, 8)])
def test_sharded_face_tables_match_jax(ne, S):
    g, plan, ftd, stack = _tables(ne, S)
    jg = jbuild_grid(ne, order="raster")
    want = jfs.build_sharded_face_tables(jg, jbuild_plan(jg, S),
                                         jface_tables(jg))
    assert stack.keys() == want.keys()
    assert stack["_dims"] == want["_dims"]
    for k in stack:
        if k != "_dims":
            assert stack[k].dtype == want[k].dtype, k
            assert np.array_equal(stack[k], want[k]), k
    aligned = plan.eloc % ne == 0
    assert (stack["_dims"]["band_o_static"] is not None) == aligned
    # K7's role table reaches every partner of every local slot
    roles = fs.band_roles(plan, ftd, ne)
    n_partners = (g.part_mask.reshape(-1, 16, 3).sum(-1))
    for s in range(S):
        sl = slice(s * plan.eloc, (s + 1) * plan.eloc)
        assert np.array_equal((roles[s] >= 0).sum(-1), n_partners[sl])
        assert roles[s].max() < (plan.eloc + plan.nhalo) * 16


def _shard_inputs(g, plan, s, x):
    """Shard s's local field and ext = cat([x, halo]) built from
    halo_gid on the host (tests/test_sharded_face.py:92-99)."""
    sl = slice(s * plan.eloc, (s + 1) * plan.eloc)
    hg = plan.halo_gid[s]
    halo = np.where((hg >= 0)[:, None, None], x[np.maximum(hg, 0)], 0.0)
    return sl, x[sl], np.concatenate([x[sl], halo])


def _kernel_form(x, ext, t, rsp=None, dp=None, nq=None, lap=False):
    """What csrc/band.cu computes, in PyTorch: partners through the role
    table, per slot ((x + sx) + sy) + corner on the i = 0, 3 planes and
    x + sy elsewhere, then the epilogues of K4's plain version."""
    E, _, L = x.shape
    extf = ext.reshape(-1, L)

    def at(r):
        idx = t.role[:, :, r].reshape(-1).long()
        v = extf.index_select(0, idx.clamp(min=0))
        return torch.where((idx >= 0)[:, None], v, 0.0).reshape(x.shape)
    sx, sy, d = at(0), at(1), at(2)
    xplane = torch.tensor([p // 4 in (0, 3) for p in range(N2)])[None, :,
                                                                 None]
    res = torch.where(xplane, ((x + sx) + sy) + d, x + sy)
    if rsp is None:
        return res
    res = res * rsp[:, :, None]
    if dp is None:
        return res
    q = (res.reshape(E, N2, nq, -1) / dp[:, :, None, :]).reshape(x.shape)
    out = (res, q.amin(dim=1), q.amax(dim=1))
    if lap:
        out += (fk._lap_wk(q, *fk._met_rows(t.met, "s00", "s01", "s11"),
                           t.deriv),)
    return out


@pytest.mark.parametrize("ne,S", [(6, 1), (4, 8), (6, 8)])
def test_band_plain_matches_jax_kernel(ne, S):
    """Every shard of a row-aligned and of a mid-row layout, every
    variant, against the JAX Pallas band kernel (interpret mode), the JAX
    XLA band assembly and the role-table form of the CUDA kernel."""
    g, plan, ftd, stack = _tables(ne, S)
    roles = fs.band_roles(plan, ftd, ne)
    jg = jbuild_grid(ne, order="raster")
    jft = jface_tables(jg)
    jstack = jfs.build_sharded_face_tables(jg, jbuild_plan(jg, S), jft)
    jdims = jstack.pop("_dims")
    E = g.nelem
    nq, nk = 2, 8
    rng = np.random.default_rng(ne * 17 + S)
    x = rng.standard_normal((E, N2, nq * nk))
    dp_all = rng.uniform(0.5, 2.0, (E, N2, nk))
    t64 = {k: torch.tensor(np.asarray(getattr(g, k))) for k in
           ("Dinv", "metdet", "rmetdet", "spheremp")}
    met = metric_pack(**t64)
    rsp_all = torch.tensor(g.rspheremp.reshape(E, N2))
    for s in range(S):
        sl, xs, ext = _shard_inputs(g, plan, s, x)
        t = fs.ShardedFaceTables.from_stack(
            stack, roles, s, plan.nhalo, "cpu", met=met[sl],
            deriv=torch.tensor(g.deriv))
        jt = jfs.tables_from_stack(
            {k: jnp.asarray(v[s]) for k, v in jstack.items()}, jdims)
        xt, et = torch.tensor(xs), torch.tensor(ext)
        rsp, dp = rsp_all[sl], torch.tensor(dp_all[sl])
        # raw: the JAX kernel, the JAX XLA band and the kernel form
        raw = band.dss_band_plain(xt, et, t)
        want = np.asarray(dss_band_pallas(jnp.asarray(xs), jnp.asarray(ext),
                                          jt, interpret=True))
        assert np.array_equal(raw.numpy(), want), s
        assert np.array_equal(raw.numpy(), np.asarray(
            jfs.dss_sum_t_face_band(jnp.asarray(xs), jnp.asarray(ext), jt)))
        assert torch.equal(_kernel_form(xt, et, t), raw)
        # halo-only ext: the same bits
        assert torch.equal(band.dss_band_plain(xt, et[plan.eloc:], t), raw)
        # scale, scale + min/max, scale + min/max + Laplacian
        got_s = band.dss_band_plain(xt, et, t, rsp=rsp)
        assert torch.equal(got_s, raw * rsp[:, :, None])
        assert torch.equal(got_s, _kernel_form(xt, et, t, rsp=rsp))
        got = band.dss_band(xt, et, t, rsp=rsp, dp=dp, nq=nq, lap=True)
        want = dss_band_pallas(
            jnp.asarray(xs), jnp.asarray(ext), jt, rsp_band=jt.band_rsp,
            dp=jnp.asarray(dp_all[sl]), nq=nq, met_band=jt.band_met,
            deriv=jg.deriv, interpret=True)
        for a, b in zip(got[:3], want[:3]):
            assert np.array_equal(a.numpy(), np.asarray(b)), s
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                                   rtol=1e-12, atol=1e-12)
        form = _kernel_form(xt, et, t, rsp=rsp, dp=dp, nq=nq, lap=True)
        assert all(torch.equal(a, b) for a, b in zip(got, form))
        mm = band.dss_band(xt, et, t, rsp=rsp, dp=dp, nq=nq)
        assert len(mm) == 3 and all(torch.equal(a, b)
                                    for a, b in zip(mm, got))


def _edge_inputs(E, dtype, seed):
    """x [E, 16, 2*8] and dp [E, 16, 8] (2 tracers, 8 levels) at the edges
    of K7's inline division (common.cuh tse::Bits: out/dp is inline while
    |out| lies in 2^-+100 (f32) / 2^-+400 (f64) or out is +0, and dp in
    2^-+20 / 2^-+400): lanes of zeros, of -0, of magnitudes below and above
    the out range (every partner too, so the assembled slot stays there),
    scattered -0 and negative values; dp at both ends of its range on
    levels 0 and 1 and just outside it in some elements on level 2.  Tiny
    and huge lanes sit on levels with dp near 1, so q stays normal and
    finite and the Laplacian does not overflow; each has one sign, so no
    sum cancels to a subnormal (which XLA on the CPU flushes to zero and
    PyTorch keeps)."""
    f = np.float32 if dtype == "f32" else np.float64
    big, lim = (100, 20) if dtype == "f32" else (400, 400)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, N2, 2, 8)).astype(f)
    x[:, :, 0, 3] = 0.0
    x[:, :, 1, 3] = -0.0
    x[:, :, 0, 4] = f(2.0 ** -(big + 20)) * rng.uniform(1, 2, (E, N2))
    x[:, :, 1, 4] = f(-2.0 ** (big + 1)) * rng.uniform(1, 1.5, (E, N2))
    x[::3, ::5, 0, 5] = -0.0
    x[::2, :, 1, 5] = -np.abs(x[::2, :, 1, 5])
    dp = rng.uniform(0.5, 2.0, (E, N2, 8)).astype(f)
    dp[:, :, 0] = f(2.0 ** lim)
    dp[:, :, 1] = f(2.0 ** -lim)
    dp[::5, 7, 2] = np.nextafter(f(2.0 ** lim), f(np.inf))
    dp[1::5, 9, 2] = np.nextafter(f(2.0 ** -lim), f(0))
    return x.reshape(E, N2, 16), dp


@pytest.mark.parametrize("ne,S", [(4, 8), (6, 1)])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_band_plain_matches_jax_kernel_edges(ne, S, dtype):
    """dss_band_plain against the JAX Pallas band kernel (interpret mode)
    on inputs at the edges of K7's inline division, every shard: out, qmin
    and qmax bitwise, the Laplacian within 1e-5 (f32) / 1e-12 (f64) of the
    field max (the two associate the 4x4 contractions differently).  The
    one difference in the bits is the sign of a zero: where every present
    term of a slot is -0, the Pallas kernel gives -0 and the JAX XLA band
    assembly +0, as the port's plain version and K7 do (their chains add
    the absent terms as +0); out is held to the XLA assembly bit for bit."""
    g, plan, ftd, stack = _tables(ne, S)
    roles = fs.band_roles(plan, ftd, ne)
    jg = jbuild_grid(ne, order="raster")
    jstack = jfs.build_sharded_face_tables(jg, jbuild_plan(jg, S),
                                           jface_tables(jg))
    jdims = jstack.pop("_dims")
    nq = 2
    x, dp_all = _edge_inputs(g.nelem, dtype, seed=ne * 31 + S)
    tt = torch.float32 if dtype == "f32" else torch.float64
    ibits = torch.int32 if dtype == "f32" else torch.int64
    t64 = {k: torch.tensor(np.asarray(getattr(g, k))) for k in
           ("Dinv", "metdet", "rmetdet", "spheremp")}
    met = metric_pack(**t64).to(tt)
    rsp_all = torch.tensor(g.rspheremp.reshape(g.nelem, N2)).to(tt)
    tol = 1e-5 if dtype == "f32" else 1e-12
    slow = 0
    for s in range(S):
        sl, xs, ext = _shard_inputs(g, plan, s, x)
        xs, ext = xs.astype(x.dtype), ext.astype(x.dtype)
        t = fs.ShardedFaceTables.from_stack(
            stack, roles, s, plan.nhalo, "cpu", met=met[sl],
            deriv=torch.tensor(g.deriv).to(tt))
        jt = jfs.tables_from_stack(
            {k: jnp.asarray(v[s]) for k, v in jstack.items()}, jdims)
        got = band.dss_band(torch.tensor(xs), torch.tensor(ext), t,
                            rsp=rsp_all[sl], dp=torch.tensor(dp_all[sl]),
                            nq=nq, lap=True)
        want = dss_band_pallas(
            jnp.asarray(xs), jnp.asarray(ext), jt, rsp_band=jt.band_rsp,
            dp=jnp.asarray(dp_all[sl]), nq=nq, met_band=jt.band_met,
            deriv=jg.deriv, interpret=True)
        for name, a, b in zip(("out", "qmin", "qmax"), got[:3], want[:3]):
            b = torch.from_numpy(np.array(b))
            assert a.dtype == b.dtype == tt, name
            same = a.view(ibits) == b.view(ibits)
            assert bool((same | ((a == 0) & (b == 0))).all()), (s, name)
        xla = torch.from_numpy(np.array(jfs.dss_sum_t_face_band(
            jnp.asarray(xs), jnp.asarray(ext), jt))) * rsp_all[sl][:, :, None]
        assert torch.equal(got[0].view(ibits), xla.view(ibits)), s
        lap = torch.from_numpy(np.array(want[3]))
        assert bool(torch.isfinite(got[3]).all())
        scale = lap.abs().max().item()
        assert (got[3] - lap).abs().max().item() <= tol * scale, s
        # the edges are reached: +0 slots from -0 inputs, slots outside
        # the out range, and elements with a dp outside the dp range
        out = got[0].reshape(-1, N2, 2, 8)
        assert bool((out[..., 1, 3].view(ibits) == 0).all())
        assert float(out[..., 0, 4].abs().max()) < 2.0 ** -(
            100 if dtype == "f32" else 400)
        assert float(out[..., 1, 4].abs().min()) > 2.0 ** (
            100 if dtype == "f32" else 400)
        slow += int((dp_all[sl] != np.clip(dp_all[sl], 2.0 ** -(
            20 if dtype == "f32" else 400), 2.0 ** (
                20 if dtype == "f32" else 400))).any(axis=(1, 2)).sum())
    assert slow > 0


def test_band_against_single_device_face_dss():
    """K7 and K4 differ only in the association at three-partner slots."""
    ne, S = 4, 4
    g, plan, ftd, stack = _tables(ne, S)
    roles = fs.band_roles(plan, ftd, ne)
    ft = fk.FaceTables.from_grid(g.part_idx, g.part_mask, ne, "cpu")
    x = np.random.default_rng(5).standard_normal((g.nelem, N2, 24))
    k4 = fk.dss_face_plain(torch.tensor(x), ft)
    three = (ft.part >= 0).all(-1)                     # [E, 16]
    assert int(three.sum()) > 0
    for s in range(S):
        sl, xs, ext = _shard_inputs(g, plan, s, x)
        t = fs.ShardedFaceTables.from_stack(stack, roles, s, plan.nhalo,
                                            "cpu")
        got = band.dss_band_plain(torch.tensor(xs), torch.tensor(ext), t)
        want = k4[sl]
        assert torch.equal(got[~three[sl]], want[~three[sl]])
        d = (got - want)[three[sl]].abs().max().item()
        assert d <= 4 * np.finfo(np.float64).eps * np.abs(x).max() * 4


def test_dss_band_rejects_bad_inputs():
    g, plan, ftd, stack = _tables(4, 4)
    t = fs.ShardedFaceTables.from_stack(stack, fs.band_roles(plan, ftd, 4),
                                        0, plan.nhalo, "cpu")
    x = torch.zeros((plan.eloc, N2, 6), dtype=torch.float64)
    ext = torch.zeros((plan.eloc + plan.nhalo, N2, 6), dtype=torch.float64)
    rsp = torch.ones((plan.eloc, N2), dtype=torch.float64)
    dp = torch.ones((plan.eloc, N2, 4), dtype=torch.float64)
    dp3 = torch.ones((plan.eloc, N2, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="ext has"):
        band.dss_band(x, ext[1:], t)
    with pytest.raises(ValueError, match="requires rsp"):
        band.dss_band(x, ext, t, dp=dp3)
    with pytest.raises(ValueError, match="nq\\*nk"):
        band.dss_band(x, ext, t, rsp=rsp, dp=dp)
    with pytest.raises(ValueError, match="met and deriv"):
        band.dss_band(x, ext, t, rsp=rsp, dp=dp3, lap=True)
    with pytest.raises(TypeError, match="dtype"):
        band.dss_band(x, ext.float(), t)
