"""Port's gather DSS, bound prep and model tables == the JAX package's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transport_se_tpu.config import Config as JConfig
from transport_se_tpu.grid.cubesphere import build_grid
from transport_se_tpu.model import core as jcore
from transport_se_tpu_torch.convert import (model_from_numpy,
                                            state_from_numpy,
                                            state_to_numpy)
from transport_se_tpu_torch.model import core as tcore
from transport_se_tpu_torch.ops.dss import DssTables

from test_torch_host import port_config

torch.set_num_threads(1)

JCFG = JConfig(ne=2, nlev=8, qsize=3, tstep=1200.0, vcoord="dcmip8",
               test_case="dcmip1-1", dtype="f64", elem_order="raster")
CFG = port_config(JCFG)
ARRAYS = ("lon", "lat", "deriv", "D", "Dinv", "metdet", "rmetdet",
          "spheremp", "rspheremp", "etam", "etai", "hyai", "hybi",
          "dp0col", "dp0ref")


def jax_arrays(jm):
    a = {k: np.asarray(getattr(jm, k)) for k in ARRAYS}
    a.update(part_idx=np.asarray(jm.tables.part_idx),
             part_mask=np.asarray(jm.tables.part_mask),
             nbr=np.asarray(jm.tables.nbr))
    return a


@pytest.fixture(scope="module")
def models():
    jm = jcore.build_model(JCFG)
    return jm, model_from_numpy(CFG, jax_arrays(jm), "cpu")


def _field(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


def test_model_from_numpy_equals_build_model(models):
    jm, tm = models
    tb = tcore.build_model(CFG, "cpu")
    for k in ARRAYS:
        a, b = getattr(tm, k), getattr(tb, k)
        assert a.dtype == b.dtype == torch.float64, k
        assert torch.equal(a, b), k
    for k in ("part_idx", "part_mask", "nbr"):
        assert torch.equal(getattr(tm.tables, k), getattr(tb.tables, k)), k
    assert torch.equal(tm.met, tb.met)


@pytest.mark.parametrize("B", [1, 24])
def test_dss_sum_t_bitwise(models, B):
    jm, tm = models
    x = _field(0, (24, 16, B))
    want = np.asarray(jm.tables.dss_sum_t(jnp.asarray(x)))
    got = tm.tables.dss_sum_t(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_dss_scale_t_with_average_bitwise(models):
    jm, tm = models
    x, avg = _field(1, (24, 16, 24)), _field(2, (24, 16, 24))
    rsp = np.array(jm.rspheremp).reshape(24, 16)
    want = np.asarray(jm.tables.dss_scale_t(jnp.asarray(x), jnp.asarray(rsp),
                                            avg=jnp.asarray(avg)))
    got = tm.tables.dss_scale_t(torch.from_numpy(x), torch.from_numpy(rsp),
                                avg=torch.from_numpy(avg)).numpy()
    np.testing.assert_array_equal(got, want)


def test_minmax_prep_and_neighbor_minmax_bitwise(models):
    jm, tm = models
    nq, nk = CFG.qsize, CFG.nlev
    x = _field(3, (24, 16, nq * nk))
    dp = 1.0 + np.abs(_field(4, (24, 16, nk)))
    jmn, jmx = jm.tables.minmax_prep(jnp.asarray(x), jnp.asarray(dp), nq)
    tmn, tmx = tm.tables.minmax_prep(torch.from_numpy(x),
                                     torch.from_numpy(dp), nq)
    np.testing.assert_array_equal(tmn.numpy(), np.asarray(jmn))
    np.testing.assert_array_equal(tmx.numpy(), np.asarray(jmx))
    jgn, jgx = jm.tables.neighbor_minmax(jmn, jmx)
    tgn, tgx = tm.tables.neighbor_minmax(tmn, tmx)
    np.testing.assert_array_equal(tgn.numpy(), np.asarray(jgn))
    np.testing.assert_array_equal(tgx.numpy(), np.asarray(jgx))
    assert float(tm.tables.global_min(tgn)) == float(
        jm.tables.global_min(jgn))


def test_dss_scale_minmax_t_matches_parts(models):
    jm, tm = models
    nq, nk = CFG.qsize, CFG.nlev
    x = _field(5, (24, 16, nq * nk))
    dp = 1.0 + np.abs(_field(6, (24, 16, nk)))
    rsp = np.array(jm.rspheremp).reshape(24, 16)
    jout, jmn, jmx, jlap = jm.tables.dss_scale_minmax_t(
        jnp.asarray(x), jnp.asarray(rsp), jnp.asarray(dp), nq)
    tout, tmn, tmx, tlap = tm.tables.dss_scale_minmax_t(
        torch.from_numpy(x), torch.from_numpy(rsp), torch.from_numpy(dp), nq,
        lap=True)
    for a, b in ((tout, jout), (tmn, jmn), (tmx, jmx)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the gather mode leaves the first Laplacian to the caller
    assert jlap is None and tlap is None


@pytest.mark.parametrize("mode", ["segsum"])
def test_unported_modes_raise(models, mode):
    """segsum is ported: it needs its member tables (an unknown mode
    raises), gives every copy of a shared point the same sum, and agrees
    with the JAX segment_sum to roundoff."""
    jm, tm = models
    with pytest.raises(ValueError, match="member tables"):
        DssTables(tm.tables.part_idx, tm.tables.part_mask, tm.tables.nbr,
                  mode=mode)
    with pytest.raises(ValueError, match="not in"):
        DssTables(tm.tables.part_idx, tm.tables.part_mask, tm.tables.nbr,
                  mode="scatter")
    tb = DssTables.from_numpy(np.asarray(jm.tables.part_idx),
                              np.asarray(jm.tables.part_mask),
                              np.asarray(jm.tables.nbr), "cpu", mode=mode)
    x = _field(8, (24, 16, 5))
    got = tb.dss_sum_t(torch.from_numpy(x)).numpy().reshape(24 * 16, 5)
    gid = np.asarray(jm.tables.gid)
    for g in np.unique(gid):
        rows = got[gid == g]
        assert (rows == rows[0]).all()
    jseg = dataclasses.replace(jm.tables, mode="segsum")
    want = np.asarray(jseg.dss_sum_t(jnp.asarray(x))).reshape(24 * 16, 5)
    # up to 4 addends summed in another order: a few ulp of the largest
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=8 * np.finfo(np.float64).eps
                               * np.abs(x).max())


def test_face_mode_requires_raster_order(models):
    jm, _ = models
    g = build_grid(2, order="gilbert")
    with pytest.raises(ValueError, match="raster"):
        DssTables.from_numpy(g.part_idx, g.part_mask, g.nbr, "cpu",
                             mode="face", ne=2)
    arrays = dict(jax_arrays(jm), part_idx=g.part_idx,
                  part_mask=g.part_mask, nbr=g.nbr)
    face_cfg = dataclasses.replace(CFG, dss_mode="face")
    with pytest.raises(ValueError, match="raster"):
        model_from_numpy(face_cfg, arrays, "cpu")
    with pytest.raises(ValueError, match="face tables"):
        DssTables(torch.as_tensor(g.part_idx), torch.as_tensor(g.part_mask),
                  torch.as_tensor(g.nbr), mode="face")


def test_state_round_trip():
    x = _field(7, (24, 16, 24))
    t = state_from_numpy(x, "cpu")
    assert t.is_contiguous() and t.dtype == torch.float64
    np.testing.assert_array_equal(state_to_numpy(t), x)
    with pytest.raises(ValueError):
        state_from_numpy(x.reshape(24, 4, 4, 24), "cpu")
