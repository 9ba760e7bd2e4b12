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
