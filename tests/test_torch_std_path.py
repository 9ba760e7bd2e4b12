"""The port's std-layout path == the JAX package's, in f64 on the CPU, at
ne=2, 16 levels, 2 tracers: the DCMIP fields, the vorticity, the general
PPM remap, the std DSS in its three modes, repro_sum, the diagnostics, one
subcycle in each of its options, the dispatch between the two pipelines,
and run_simulation with its StateLog and restart.  The std remap (the T
layout's K3 and health kernel on T-layout copies) is held both against
the JAX package's and against the plain-torch std remap it replaced.

Tolerances, each with its reason:
* bitwise where both sides do the same operations in the same order: the
  gather DSS, min/max reductions, repro_sum (exact integer windows);
* the JAX package's own f64 parity bound, rtol 1e-11 / atol 1e-9 on Qdp
  (O(1e3) Pa values; tests/test_pallas_limiter.py:90), for a subcycle:
  PyTorch and XLA associate the 4x4 contractions, the 16-point limiter
  sums and the level sums differently;
* a few ulp of the largest term for single sums taken in another order
  (segsum, the face DSS's partner order, trigonometric functions of two
  libms).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transport_se_tpu import diagnostics as jdiag
from transport_se_tpu.config import Config as JConfig
from transport_se_tpu.io import restart as jrestart
from transport_se_tpu.model import core as jcore
from transport_se_tpu.model import dcmip as jdcmip
from transport_se_tpu.model.driver import run_simulation as jrun
from transport_se_tpu.ops import dss as jdss
from transport_se_tpu.ops import ppm as jppm
from transport_se_tpu.ops import sphere_ops as jso
from transport_se_tpu.utils import repro_sum as jrepro
from transport_se_tpu_torch import counters
from transport_se_tpu_torch import diagnostics as tdiag
from transport_se_tpu_torch.convert import (model_from_numpy, qdp_from_numpy,
                                            qdp_to_numpy)
from transport_se_tpu_torch.io import restart as trestart
from transport_se_tpu_torch.model import core as tcore
from transport_se_tpu_torch.model import dcmip as tdcmip
from transport_se_tpu_torch.model.driver import run_simulation as trun
from transport_se_tpu_torch.ops import dss as tdss
from transport_se_tpu_torch.ops import ppm as tppm
from transport_se_tpu_torch.ops import sphere_ops as tso
from transport_se_tpu_torch.utils import repro_sum as trepro

from test_torch_host import port_config

torch.set_num_threads(1)

JCFG = JConfig(ne=2, nlev=16, qsize=2, tstep=1200.0, vcoord="dcmip16",
               test_case="dcmip1-1", nu_q=6e16, nmax=6, statefreq=3,
               dtype="f64")
CFG = port_config(JCFG)
ARRAYS = ("lon", "lat", "deriv", "D", "Dinv", "metdet", "rmetdet",
          "spheremp", "rspheremp", "etam", "etai", "hyai", "hybi",
          "dp0col", "dp0ref")
EPS = np.finfo(np.float64).eps
# the JAX package's f64 subcycle parity bound on Qdp
RTOL, ATOL = 1e-11, 1e-9
E = 24


def _pair(jcfg):
    jm = jcore.build_model(jcfg)
    arrays = {k: np.asarray(getattr(jm, k)) for k in ARRAYS}
    arrays.update(part_idx=np.asarray(jm.tables.part_idx),
                  part_mask=np.asarray(jm.tables.part_mask),
                  nbr=np.asarray(jm.tables.nbr))
    return jm, model_from_numpy(port_config(jcfg), arrays, "cpu")


@pytest.fixture(scope="module")
def models():
    return _pair(JCFG)


@pytest.fixture(scope="module")
def face_models():
    return _pair(dataclasses.replace(JCFG, dss_mode="face",
                                     elem_order="raster"))


def _field(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close_ulps(got, want, n=8):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=n * EPS * np.abs(want).max())


# ---------------------------------------------------------------------------
# the std path's operators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["dcmip1-1", "dcmip1-2"])
def test_dcmip_fields_match_jax(models, case):
    jm, tm = models
    for t in (0.0, 7.0 * 1200.0):
        want = np.asarray(jdcmip.winds(case, jm.lon, jm.lat, jm.etam, t))
        got = tdcmip.winds(case, tm.lon, tm.lat, tm.etam, t).numpy()
        assert got.shape == want.shape == (E, 16, 2, 4, 4)
        _close_ulps(got, want, 16)
        for eta in ("etai", "etam"):
            want = np.asarray(jdcmip.eta_dot_dpdn(
                case, jm.lon, jm.lat, getattr(jm, eta), t))
            got = tdcmip.eta_dot_dpdn(case, tm.lon, tm.lat,
                                      getattr(tm, eta), _t(t)).numpy()
            assert got.shape == want.shape
            _close_ulps(got, want, 16)


def test_vorticity_matches_jax(models):
    jm, tm = models
    v = _field(1, (E, 16, 2, 4, 4))
    want = np.asarray(jso.vorticity_sphere(jnp.asarray(v), jm.deriv, jm.D,
                                           jm.rmetdet))
    got = tso.vorticity_sphere(_t(v), tm.deriv, tm.D, tm.rmetdet).numpy()
    _close_ulps(got, want, 16)


def test_remap_q_ppm_general_matches_jax():
    """Deformation of many cells, which the fast path's window refuses."""
    rng = np.random.default_rng(2)
    n, nq, nk = 40, 3, 16
    dp1 = rng.uniform(0.2, 3.0, (n, nk))
    dp2 = rng.uniform(0.2, 3.0, (n, nk))
    dp2 *= dp1.sum(-1, keepdims=True) / dp2.sum(-1, keepdims=True)
    qdp = rng.uniform(0.0, 1.0, (n, nq, nk)) * dp1[:, None]
    assert float(jppm.ppm_fast_margin(jnp.asarray(dp1), jnp.asarray(dp2))) < 0
    for alg in (0, 2):
        want = np.asarray(jppm.remap_q_ppm_general(
            jnp.asarray(qdp), jnp.asarray(dp1), jnp.asarray(dp2), alg=alg))
        got = tppm.remap_q_ppm_general(_t(qdp), _t(dp1), _t(dp2),
                                       alg=alg).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(got.sum(-1), qdp.sum(-1), rtol=1e-12)


def _former_vertical_remap(m, Qdp, divdp_proj, dt_remap):
    """The std remap as the std path ran it before it took the T layout's:
    the plain-torch PPM on the movedim columns [E,n,n,q,k], the health
    value dp_star.min() (and ppm_fast_margin with the fast search).
    Returns (Qdp', ps_v, dp_star, min_dp)."""
    general = m.cfg.ppm_search == "general"
    dp_star = m.dp0col[None, :, None, None] - dt_remap * divdp_proj
    ps_v = m.hyai[0] * 1e5 + dp_star.sum(dim=1)
    dp_ref = ((m.hyai[1:] - m.hyai[:-1])[None, :, None, None] * 1e5
              + (m.hybi[1:] - m.hybi[:-1])[None, :, None, None]
              * ps_v[:, None])
    d1 = torch.movedim(dp_star, 1, 3)
    d2 = torch.movedim(dp_ref, 1, 3)
    health = dp_star.min() if general else torch.minimum(
        dp_star.min(), tppm.ppm_fast_margin(d1, d2))
    remap = tppm.remap_q_ppm_general if general else tppm.remap_q_ppm
    Qnew = remap(torch.movedim(Qdp, (1, 2), (3, 4)), d1, d2,
                 alg=m.cfg.vert_remap_q_alg)
    return (torch.movedim(Qnew, (3, 4), (1, 2)), ps_v, dp_star,
            m.tables.global_min(health))


@pytest.mark.parametrize("search", ["fast", "general"])
@pytest.mark.parametrize("alg", [0, 2])
@pytest.mark.parametrize("case", ["dcmip1-1", "dcmip1-2"])
def test_std_remap_matches_its_former_formulation(models, case, alg,
                                                  search):
    """The std vertical_remap (the T remap on T-layout copies) == the
    plain-torch std remap it replaced, on the state and widths of a tracer
    step: Qdp to 1e-13 of its largest value (another association of the
    PPM's sums), ps_v and min_dp to a few ulp of the column's pressure
    (level sums in another order), each column's mass conserved."""
    _, tm = models
    m = dataclasses.replace(tm, cfg=dataclasses.replace(
        CFG, test_case=case, vert_remap_q_alg=alg, ppm_search=search))
    vn0 = tdcmip.winds(case, m.lon, m.lat, m.etam, torch.tensor(
        2 * CFG.tstep, dtype=torch.float64)) * m.dp0col[
            None, :, None, None, None]
    Qdp, divdp_proj, _, _ = tcore.advect_rk2(m, tcore.initial_qdp(m), vn0,
                                             CFG.dt_tracer)
    want, ps_want, dp_star, min_want = _former_vertical_remap(
        m, Qdp, divdp_proj, CFG.dt_remap)
    counters.reset()
    got, ps_got, min_got = tcore.vertical_remap(m, Qdp, divdp_proj,
                                                CFG.dt_remap)
    c = counters.snapshot()
    assert c["remap_q_ppm_t_plain"] == (search == "fast")
    assert c["remap_health_t_plain"] == (search == "fast")
    assert got.shape == Qdp.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-13 * want.abs().max().item())
    pulp = 8 * EPS * ps_want.abs().max().item()
    np.testing.assert_allclose(ps_got.numpy(), ps_want.numpy(), rtol=0,
                               atol=pulp)
    assert abs(min_got.item() - min_want.item()) <= pulp
    assert 0 < min_got.item() <= dp_star.min().item()
    # each (element, tracer, point) column's mass
    np.testing.assert_allclose(got.sum(2).numpy(), Qdp.sum(2).numpy(),
                               rtol=0, atol=1e-13 * Qdp.sum(2).abs().max()
                               .item())


@pytest.mark.parametrize("search", ["fast", "general"])
@pytest.mark.parametrize("alg", [0, 2])
@pytest.mark.parametrize("case", ["dcmip1-1", "dcmip1-2"])
def test_std_remap_matches_jax(models, case, alg, search):
    """The std vertical_remap == the JAX package's vertical_remap on the
    same state and widths of a tracer step: Qdp to 1e-13 of its largest
    value (XLA and PyTorch associate the PPM's sums differently), ps_v and
    min_dp to a few ulp of the column's pressure."""
    jm, tm = models
    cfg = dict(test_case=case, vert_remap_q_alg=alg, ppm_search=search)
    m = dataclasses.replace(tm, cfg=dataclasses.replace(CFG, **cfg))
    jmc = dataclasses.replace(jm, cfg=dataclasses.replace(JCFG, **cfg))
    vn0 = tdcmip.winds(case, m.lon, m.lat, m.etam, torch.tensor(
        2 * CFG.tstep, dtype=torch.float64)) * m.dp0col[
            None, :, None, None, None]
    Qdp, divdp_proj, _, _ = tcore.advect_rk2(m, tcore.initial_qdp(m), vn0,
                                             CFG.dt_tracer)
    want, ps_want, _, min_want = (np.asarray(a) for a in jcore.vertical_remap(
        jmc, jnp.asarray(Qdp.numpy()), jnp.asarray(divdp_proj.numpy()),
        CFG.dt_remap))
    got, ps_got, min_got = tcore.vertical_remap(m, Qdp, divdp_proj,
                                                CFG.dt_remap)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-13 * np.abs(want).max())
    pulp = 8 * EPS * np.abs(ps_want).max()
    np.testing.assert_allclose(ps_got.numpy(), ps_want, rtol=0, atol=pulp)
    assert abs(min_got.item() - float(min_want)) <= pulp


def test_std_dss_gather_bitwise(models):
    jm, tm = models
    for shape in ((E, 4, 4), (E, 2, 16, 4, 4)):
        x = _field(3, shape)
        want = np.asarray(jm.tables.dss_sum(jnp.asarray(x)))
        np.testing.assert_array_equal(tm.tables.dss_sum(_t(x)).numpy(), want)
    x = _field(4, (E, 16, 4, 4))
    want = np.asarray(jdss.dss_scale(jnp.asarray(x), jm.spheremp,
                                     jm.rspheremp, jm.tables))
    got = tdss.dss_scale(_t(x), tm.spheremp, tm.rspheremp, tm.tables)
    np.testing.assert_array_equal(got.numpy(), want)


def test_std_dss_segsum_matches_jax_and_repeats(models):
    jm, _ = models
    tb = tdss.DssTables.from_numpy(np.asarray(jm.tables.part_idx),
                                   np.asarray(jm.tables.part_mask),
                                   np.asarray(jm.tables.nbr), "cpu",
                                   mode="segsum")
    jseg = dataclasses.replace(jm.tables, mode="segsum")
    x = _field(5, (E, 2, 16, 4, 4))
    want = np.asarray(jseg.dss_sum(jnp.asarray(x)))
    got = tb.dss_sum(_t(x))
    # up to 4 addends summed in another order than segment_sum's
    _close_ulps(got.numpy(), want, 8)
    assert torch.equal(tb.dss_sum(_t(x)), got)


def test_std_dss_face_matches_jax(face_models):
    jm, tm = face_models
    x = _field(6, (E, 2, 16, 4, 4))
    want = np.asarray(jm.tables.dss_sum(jnp.asarray(x)))
    counters.reset()
    got = tm.tables.dss_sum(_t(x)).numpy()
    assert counters.COUNTS["dss_face_plain"] == 1
    _close_ulps(got, want, 8)


@pytest.mark.parametrize("mode", ["gather", "face"])
def test_std_neighbor_minmax_bitwise(models, face_models, mode):
    jm, tm = models if mode == "gather" else face_models
    mn, mx = _field(7, (E, 2, 16)), _field(8, (E, 2, 16))
    want = jdss.neighbor_minmax(jnp.asarray(mn), jnp.asarray(mx), jm.tables) \
        if mode == "gather" else jm.tables.neighbor_minmax(jnp.asarray(mn),
                                                           jnp.asarray(mx))
    got = tdss.neighbor_minmax(_t(mn), _t(mx), tm.tables)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("axis", [None, (0, 2), 1, (0, -2, -1)])
def test_repro_sum_bitwise(axis):
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((6, 5, 4, 4))
         * np.exp(rng.uniform(-12, 12, (6, 5, 4, 4))))
    x[2] = 0.0
    want = np.asarray(jrepro(jnp.asarray(x), axis=axis))
    got = trepro(_t(x), axis=axis).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    perm = rng.permutation(6)
    assert np.array_equal(trepro(_t(x[perm]), axis=axis).numpy(), got) \
        or axis == 1


def test_tracer_diagnostics_match_jax(models):
    jm, tm = models
    Qdp = np.asarray(jcore.initial_qdp(jm)) * (1 + 0.1 * _field(10, (E, 2, 16,
                                                                     4, 4)))
    Q = Qdp / np.asarray(jm.dp0col)[None, None, :, None, None]
    want = jdiag.tracer_diagnostics(jm, jnp.asarray(Qdp), jnp.asarray(Q))
    got = tdiag.tracer_diagnostics(tm, _t(Qdp), _t(Q))
    # mass and variance: level sums in another order, then repro_sum
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-14)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # repro_sum of the same addends is bitwise equal
    h = _t(Qdp.sum(axis=2))
    np.testing.assert_array_equal(
        tdiag.global_integral(tm, h).numpy(),
        np.asarray(jdiag.global_integral(jm, jnp.asarray(h.numpy()))))


def test_startup_checks_and_state_text_match_jax(models):
    jm, tm = models
    assert tdiag.test_global_integral(tm) == pytest.approx(
        jdiag.test_global_integral(jm), abs=1e-15)
    assert tdiag.test_global_integral(tm) < 1e-13
    assert tdiag.print_cfl(tm, CFG, verbose=False) == jdiag.print_cfl(
        jm, JCFG, verbose=False)
    Qdp = np.asarray(jcore.initial_qdp(jm))
    ps = np.full((E, 4, 4), 1.0e5)
    assert tdiag.print_state(tm, _t(Qdp), _t(ps)) == jdiag.print_state(
        jm, Qdp, ps)
    got, want = tdiag.energy_diagnostics(tm, 4), jdiag.energy_diagnostics(
        jm, 4)
    for k in ("KE", "IE", "PE"):
        assert got[k] == pytest.approx(want[k], rel=1e-13), k


def test_flow_fields_match_jax(models):
    jm, tm = models
    want = jdiag.flow_fields(jm, 5)
    got = tdiag.flow_fields(tm, 5)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        _close_ulps(got[k], want[k], 64)


# ---------------------------------------------------------------------------
# the std subcycle, the dispatch and the driver
# ---------------------------------------------------------------------------

VARIANTS = {"default": {}, "diagnostics": {}, "limiter0": dict(
    limiter_option=0), "limiter4": dict(limiter_option=4), "segsum": dict(
    dss_mode="segsum"), "general": dict(ppm_search="general"),
    "dcmip12": dict(test_case="dcmip1-2")}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_std_subcycle_matches_jax(models, name):
    jm, tm = models
    cfg = dataclasses.replace(CFG, **VARIANTS[name])
    if cfg != CFG:
        jm, tm = (dataclasses.replace(
            jm, cfg=dataclasses.replace(JCFG, **VARIANTS[name])),
            dataclasses.replace(tm, cfg=cfg))
        if cfg.dss_mode == "segsum":
            jm = dataclasses.replace(
                jm, tables=dataclasses.replace(jm.tables, mode="segsum"))
            tm = dataclasses.replace(tm, tables=tdss.DssTables.from_numpy(
                np.asarray(jm.tables.part_idx),
                np.asarray(jm.tables.part_mask),
                np.asarray(jm.tables.nbr), "cpu", mode="segsum"))
    diag = name == "diagnostics"
    Q0 = np.asarray(jcore.initial_qdp(jm))
    want = jax.jit(jcore.make_subcycle_fn(jm, diagnostics=diag))(
        jnp.asarray(Q0), jnp.asarray(0, jnp.int32))
    counters.reset()
    got = tcore.make_subcycle_fn(tm, diagnostics=diag)(
        qdp_from_numpy(Q0, "cpu"), 0)
    counts = counters.snapshot()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-13)
    assert got[2] == int(want[2]) == CFG.rsplit
    assert float(got[3]) == pytest.approx(float(want[3]), rel=1e-12)
    # limiter 8 runs K10's plain version on each of the 9 stages
    assert counts["limiter_optim_plain"] == (
        9 if cfg.limiter_option == 8 else 0)
    assert counts["fused_advect_limit_plain"] == 0
    sp = tm.spheremp.numpy()
    m0, m1 = (np.einsum("eqkij,eij->q", q, sp) for q in (Q0, got[0].numpy()))
    assert (np.abs(m1 - m0) / np.abs(m0)).max() < 1e-12


def test_std_subcycle_face_matches_jax(face_models):
    jm, tm = face_models
    Q0 = np.asarray(jcore.initial_qdp(jm))
    want = jax.jit(jcore.make_subcycle_fn(jm))(jnp.asarray(Q0),
                                               jnp.asarray(0, jnp.int32))
    counters.reset()
    got = tcore.make_subcycle_fn(tm)(qdp_from_numpy(Q0, "cpu"), 0)
    counts = counters.snapshot()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)
    # 3 stage DSS + the stage-2 Laplacian + stage 0's divdp_proj per step;
    # neighbor min/max on stages 0 and 2
    assert counts["dss_face_plain"] == 5 * CFG.rsplit
    assert counts["neighbor_minmax_plain"] == 2 * CFG.rsplit
    assert counts["limiter_optim_plain"] == 3 * CFG.rsplit


@pytest.mark.parametrize("use_pallas, limiter, diagnostics, path", [
    (False, 8, False, "std"), (True, 8, True, "std"), (True, 0, False, "std"),
    (True, 8, False, "t")])
def test_dispatch_follows_use_pallas(models, use_pallas, limiter,
                                     diagnostics, path):
    """The T pipeline runs exactly for use_pallas with limiter 8 and no
    diagnostics (JAX core.py:613, driver.py:80), seen in the counts."""
    _, tm = models
    cfg = dataclasses.replace(CFG, use_pallas=use_pallas,
                              limiter_option=limiter)
    m = dataclasses.replace(tm, cfg=cfg)
    assert tcore.uses_t_layout(cfg, diagnostics) == (path == "t")
    Q0 = tcore.initial_qdp(m)
    counters.reset()
    out = tcore.make_subcycle_fn(m, diagnostics=diagnostics)(Q0, 0)[0]
    c = counters.snapshot()
    assert out.shape == Q0.shape
    # both pipelines remap through K3 (and its health kernel); they differ
    # in the stages: K1 on the T path, K10 (limiter 8) on the std path
    assert c["remap_q_ppm_t_plain"] == 1 and c["remap_health_t_plain"] == 1
    if path == "t":
        assert c["fused_advect_limit_plain"] == 9 and c[
            "limiter_optim_plain"] == 0
    else:
        assert c["fused_advect_limit_plain"] == 0
        assert c["limiter_optim_plain"] == (9 if limiter == 8 else 0)
    if path == "std":
        with pytest.raises(ValueError, match="T-layout"):
            tcore.make_subcycle_fn(m, diagnostics=diagnostics, io_layout="t")


def test_run_simulation_std_matches_jax(models):
    jm, tm = models
    want = jrun(JCFG, model=jm, verbose=False)
    counters.reset()
    got = trun(CFG, "cpu", model=tm, verbose=False)
    assert counters.COUNTS["limiter_optim_plain"] == 18
    assert got.state.shape == (E, 2, 16, 4, 4)
    np.testing.assert_allclose(got.q_final.numpy(), want.q_final,
                               rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(got.ps_final.numpy(), want.ps_final,
                               rtol=1e-13)
    assert got.log.steps == want.log.steps == [0, 3, 6]
    np.testing.assert_allclose(np.asarray(got.log.masses),
                               np.asarray(want.log.masses), rtol=1e-13)
    np.testing.assert_allclose(np.asarray(got.log.variances),
                               np.asarray(want.log.variances), rtol=1e-12)
    assert got.log.max_relative_mass_drift() < 1e-13


def test_exact_restart_bitwise(models, tmp_path):
    """runtype 1: 6 steps straight == 3 steps + restart + 3 steps, to the
    bit; the restart file is the JAX package's format."""
    _, tm = models
    full = trun(CFG, "cpu", model=tm, verbose=False)
    path = str(tmp_path / "R0001")
    trun(dataclasses.replace(CFG, nmax=3), "cpu", model=tm, verbose=False,
         restartfreq=3,
         restart_writer=lambda m, n, q, ps: trestart.write_restart(
             path, m, q, ps, n))
    state = trestart.read_restart(path)
    assert state.nstep == 3
    Qdp, ps_v, nstep0 = trestart.resume(state, tm, runtype=1)
    assert Qdp.dtype == torch.float64 and nstep0 == 3
    res = trun(CFG, "cpu", model=tm, verbose=False, init_state=(Qdp, nstep0))
    assert torch.equal(res.q_final, full.q_final)
    assert torch.equal(res.ps_final, full.ps_final)


def test_resume_branch_matches_jax(models, tmp_path):
    jm, tm = models
    path = str(tmp_path / "R0002")
    Qdp = np.asarray(jcore.initial_qdp(jm))
    ps = np.full((E, 4, 4), 99000.0)
    jrestart.write_restart(path, jm, Qdp, ps, 3)
    state = trestart.read_restart(path)
    got = trestart.resume(state, tm, runtype=2)
    want = jrestart.resume(state, jm, runtype=2)
    assert got[2] == want[2] == 0
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-15)
    with pytest.raises(ValueError):
        trestart.resume(state, tm, runtype=3)


def test_qdp_round_trip():
    x = _field(11, (E, 2, 16, 4, 4))
    t = qdp_from_numpy(x, "cpu")
    assert t.is_contiguous() and t.dtype == torch.float64
    np.testing.assert_array_equal(qdp_to_numpy(t), x)
    with pytest.raises(ValueError):
        qdp_from_numpy(x.reshape(E, 2, 16, 16), "cpu")
