"""The port's T-layout subcycle and driver in face DSS mode (the production
configuration) == the JAX package's face pipeline, in f64 with the Pallas
kernels (interpret mode on CPU); the face path runs no weak-Laplacian
kernel and goes through the face trio (K4, K5, K6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transport_se_tpu.config import Config as JConfig
from transport_se_tpu.model import core as jcore
from transport_se_tpu.model.driver import run_simulation as jrun
from transport_se_tpu_torch import counters
from transport_se_tpu_torch.convert import (model_from_numpy,
                                            state_from_numpy)
from transport_se_tpu_torch.model import core as tcore
from transport_se_tpu_torch.model.driver import run_simulation as trun

from test_torch_host import port_config

torch.set_num_threads(1)

# the JAX suite's face-mode Pallas subcycle (test_sharded_face.py) at ne=2
JCFG = JConfig(ne=2, nlev=16, qsize=2, tstep=1200.0, vcoord="dcmip16",
               test_case="dcmip1-1", nu_q=6e16, nmax=6, dtype="f64",
               use_pallas=True, disable_diagnostics=True, dss_mode="face",
               elem_order="raster")
CFG = port_config(JCFG)
ARRAYS = ("lon", "lat", "deriv", "D", "Dinv", "metdet", "rmetdet",
          "spheremp", "rspheremp", "etam", "etai", "hyai", "hybi",
          "dp0col", "dp0ref")
# DCMIP 1-1's wind basis has 6 terms, each DSS'd once when the subcycle
# function is made
WIND_TERMS = 6


@pytest.fixture(scope="module")
def models():
    jm = jcore.build_model(JCFG)
    arrays = {k: np.asarray(getattr(jm, k)) for k in ARRAYS}
    arrays.update(part_idx=np.asarray(jm.tables.part_idx),
                  part_mask=np.asarray(jm.tables.part_mask),
                  nbr=np.asarray(jm.tables.nbr))
    return jm, model_from_numpy(CFG, arrays, "cpu")


@pytest.fixture(scope="module")
def one_subcycle(models):
    jm, tm = models
    E, qk = 24, CFG.qsize * CFG.nlev
    Qt0 = np.asarray(jcore._tp(jcore.initial_qdp(jm), E, qk))
    jout = jax.jit(jcore.make_subcycle_fn(jm, io_layout="t"))(
        jnp.asarray(Qt0), jnp.asarray(0, jnp.int32))
    counters.reset()
    tout = tcore.make_subcycle_fn(tm, io_layout="t")(
        state_from_numpy(Qt0, "cpu"), 0)
    return Qt0, [np.asarray(a) for a in jout], tout, counters.snapshot()


def test_face_model_matches_build_model(models):
    _, tm = models
    tb = tcore.build_model(CFG, "cpu")
    assert tm.tables.mode == tb.tables.mode == "face"
    for k in ("part", "nbr", "diag_idx", "ghost_px", "src_my"):
        assert torch.equal(getattr(tm.tables.face, k),
                           getattr(tb.tables.face, k)), k
    assert torch.equal(tm.tables.met, tm.met)


def test_face_subcycle_matches_jax(one_subcycle):
    _, (jq, jps, jn, jmd), (tq, tps, tn, tmd), _ = one_subcycle
    # the JAX package's own f64 parity bound (test_pallas_limiter.py:90)
    np.testing.assert_allclose(tq.numpy(), jq, rtol=1e-11, atol=1e-9)
    np.testing.assert_allclose(tps.numpy(), jps, rtol=1e-13)
    assert tn == int(jn) == CFG.rsplit
    assert float(tmd) == pytest.approx(float(jmd), rel=1e-12)


def test_face_subcycle_goes_through_the_face_trio(one_subcycle):
    """On the CPU every wrapper runs its plain version and counts it: 4
    face DSS per step (+ the wind basis's), the winds once a step, one
    bound prep per subcycle, neighbor min/max on stages 0 and 2, the
    remap's health check once, and no weak-Laplacian run."""
    counts = one_subcycle[3]
    n = CFG.rsplit
    assert {k: v for k, v in counts.items() if v} == {
        "fused_advect_limit_plain": 3 * n, "remap_q_ppm_t_plain": 1,
        "dss_face_plain": 4 * n + WIND_TERMS, "minmax_prep_plain": 1,
        "neighbor_minmax_plain": 2 * n, "wind_eval_t_plain": n,
        "remap_health_t_plain": 1}


def test_face_subcycle_conserves_mass(models, one_subcycle):
    _, tm = models
    Qt0, _, (tq, _, _, _), _ = one_subcycle
    sp = tm.spheremp.numpy().reshape(24, 16)
    E = Qt0.shape[0]
    m0, m1 = (np.einsum("epqk,ep->q", q.reshape(E, 16, CFG.qsize, CFG.nlev),
                        sp) for q in (Qt0, tq.numpy()))
    assert (np.abs(m1 - m0) / np.abs(m0)).max() < 1e-12


def test_face_plain_switch_equals_wrappers(models, one_subcycle):
    """plain=True takes the same path through the plain versions."""
    _, tm = models
    Qt0, _, (tq, _, _, _), _ = one_subcycle
    got = tcore.make_subcycle_fn(tm, io_layout="t", plain=True)(
        state_from_numpy(Qt0, "cpu"), 0)[0]
    assert torch.equal(got, tq)


def test_face_run_simulation_matches_jax(models):
    jm, tm = models
    want = jrun(JCFG, model=jm, verbose=False)
    got = trun(CFG, "cpu", model=tm)
    assert got.nsteps == want.nsteps == 6
    assert len(got.min_dp) == 2 and min(got.min_dp) > 0
    np.testing.assert_allclose(got.q_final.numpy(), want.q_final,
                               rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(got.ps_final.numpy(), want.ps_final,
                               rtol=1e-13)
    np.testing.assert_allclose(got.q_init.numpy(), want.q_init,
                               rtol=1e-12, atol=1e-14)
