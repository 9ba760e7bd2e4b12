"""The port's T-layout subcycle and driver == the JAX package's, in f64
gather mode with the Pallas kernels (interpret mode on CPU); the port
imports no JAX and its kernel loader does not fall back."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transport_se_tpu.config import Config as JConfig
from transport_se_tpu.model import core as jcore
from transport_se_tpu.model.driver import run_simulation as jrun
from transport_se_tpu_torch import _build
from transport_se_tpu_torch.config import Config
from transport_se_tpu_torch.convert import (model_from_numpy,
                                            state_from_numpy)
from transport_se_tpu_torch.model import core as tcore
from transport_se_tpu_torch.model.driver import run_simulation as trun
from transport_se_tpu_torch.timing import Timers

from test_torch_host import port_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = JConfig(ne=2, nlev=16, qsize=2, tstep=1200.0, vcoord="dcmip16",
               test_case="dcmip1-1", nu_q=6e16, nmax=6, dtype="f64",
               use_pallas=True, disable_diagnostics=True)
CFG = port_config(JCFG)
ARRAYS = ("lon", "lat", "deriv", "D", "Dinv", "metdet", "rmetdet",
          "spheremp", "rspheremp", "etam", "etai", "hyai", "hybi",
          "dp0col", "dp0ref")
SLICE_MODULES = (
    "transport_se_tpu_torch", "transport_se_tpu_torch._build",
    "transport_se_tpu_torch.config", "transport_se_tpu_torch.convert",
    "transport_se_tpu_torch.counters", "transport_se_tpu_torch.timing",
    "transport_se_tpu_torch.ops.sphere_ops", "transport_se_tpu_torch.ops.dss",
    "transport_se_tpu_torch.ops.dss_face",
    "transport_se_tpu_torch.ops.euler", "transport_se_tpu_torch.ops.ppm",
    "transport_se_tpu_torch.ops.remap", "transport_se_tpu_torch.model.dcmip",
    "transport_se_tpu_torch.model.core",
    "transport_se_tpu_torch.model.wind_basis",
    "transport_se_tpu_torch.model.driver",
    "transport_se_tpu_torch.ops.limiter", "transport_se_tpu_torch.utils",
    "transport_se_tpu_torch.utils.repro_sum",
    "transport_se_tpu_torch.diagnostics", "transport_se_tpu_torch.io",
    "transport_se_tpu_torch.io.restart", "transport_se_tpu_torch.norms",
    "transport_se_tpu_torch.main")


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
    tout = tcore.make_subcycle_fn(tm, io_layout="t")(
        state_from_numpy(Qt0, "cpu"), 0)
    return Qt0, [np.asarray(a) for a in jout], tout


def _mass(sp, qt):
    """Global tracer mass per tracer: sum of spheremp * Qdp."""
    E = qt.shape[0]
    return np.einsum("epqk,ep->q", qt.reshape(E, 16, CFG.qsize, CFG.nlev),
                     sp.reshape(E, 16))


def test_subcycle_matches_jax(one_subcycle):
    _, (jq, jps, jn, jmd), (tq, tps, tn, tmd) = one_subcycle
    # the JAX package's own f64 parity bound (test_pallas_limiter.py:90)
    np.testing.assert_allclose(tq.numpy(), jq, rtol=1e-11, atol=1e-9)
    np.testing.assert_allclose(tps.numpy(), jps, rtol=1e-13)
    assert tn == int(jn) == CFG.rsplit
    assert float(tmd) == pytest.approx(float(jmd), rel=1e-12)


def test_subcycle_conserves_mass(models, one_subcycle):
    _, tm = models
    Qt0, _, (tq, _, _, _) = one_subcycle
    sp = tm.spheremp.numpy()
    m0, m1 = _mass(sp, Qt0), _mass(sp, tq.numpy())
    assert (np.abs(m1 - m0) / np.abs(m0)).max() < 1e-12


def test_run_simulation_matches_jax(models):
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


def test_run_simulation_aborts_on_negative_thickness(models):
    _, tm = models
    cfg = Config(**{**CFG.__dict__, "tstep": 2.0e5, "nmax": 3})
    with pytest.raises(RuntimeError, match="negative layer thickness"):
        trun(cfg, "cpu", model=tcore.build_model(cfg, "cpu"))


@pytest.mark.parametrize("kw", [dict(disable_diagnostics=False),
                                dict(limiter_option=0),
                                dict(ppm_search="general"),
                                dict(rhs_bf16=True)])
def test_unported_options_raise(kw):
    """Only rhs_bf16 stays unported; diagnostics, limiter 0 (the std
    path) and the general PPM search run and conserve mass."""
    cfg = Config(**{**CFG.__dict__, "nmax": 3, **kw})
    if kw.get("rhs_bf16"):
        with pytest.raises(NotImplementedError, match="rhs_bf16"):
            trun(cfg, "cpu")
        return
    res = trun(cfg, "cpu", verbose=False)
    assert res.nsteps == 3 and min(res.min_dp) > 0
    assert bool(torch.isfinite(res.q_final).all())
    if not cfg.disable_diagnostics:
        assert res.log.steps == [0, 3]
        assert res.log.max_relative_mass_drift() < 1e-12


def test_unported_subcycle_forms_raise(models):
    """diagnostics=True and io_layout="std" run the std-layout step; the
    T layout is refused where the T pipeline is not taken; restart
    writing runs."""
    jm, tm = models
    Qdp0 = jcore.initial_qdp(jm)
    want = jax.jit(jcore.make_subcycle_fn(jm, diagnostics=True))(
        Qdp0, jnp.asarray(0, jnp.int32))[0]
    got = tcore.make_subcycle_fn(tm, diagnostics=True)(
        torch.tensor(np.asarray(Qdp0)), 0)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-11,
                               atol=1e-9)
    got_t = tcore.make_subcycle_fn(tm, io_layout="std")(
        torch.tensor(np.asarray(Qdp0)), 0)[0]
    assert got_t.shape == Qdp0.shape
    with pytest.raises(ValueError, match="T-layout pipeline"):
        tcore.make_subcycle_fn(tm, diagnostics=True, io_layout="t")
    saved = []
    trun(CFG, "cpu", model=tm, restartfreq=3,
         restart_writer=lambda m, n, q, ps: saved.append((n, q.shape)))
    assert saved == [(3, Qdp0.shape), (6, Qdp0.shape)]


def test_t_subcycle_general_search_matches_jax(models):
    """ppm_search="general" on the T layout: the unbounded search in
    element chunks, as the JAX package's lax.map."""
    jm, tm = models
    jcfg = dataclasses.replace(JCFG, ppm_search="general")
    jm, tm = (dataclasses.replace(jm, cfg=jcfg),
              dataclasses.replace(tm, cfg=port_config(jcfg)))
    E, qk = 24, CFG.qsize * CFG.nlev
    Qt0 = np.asarray(jcore._tp(jcore.initial_qdp(jm), E, qk))
    want = jax.jit(jcore.make_subcycle_fn(jm, io_layout="t"))(
        jnp.asarray(Qt0), jnp.asarray(0, jnp.int32))
    got = tcore.make_subcycle_fn(tm, io_layout="t")(
        state_from_numpy(Qt0, "cpu"), 0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-11, atol=1e-9)
    assert float(got[3]) == pytest.approx(float(want[3]), rel=1e-12)


def test_slice_imports_no_jax():
    code = ("import sys, importlib\n"
            f"for name in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(name)\n"
            "assert 'jax' not in sys.modules, sorted(\n"
            "    m for m in sys.modules if m.startswith('jax'))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_kernel_loader_raises_without_nvcc(tmp_path, monkeypatch):
    """No nvcc: the loader raises; nothing falls back to another path."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
    assert not (tmp_path / "build").exists()


def test_timers_host_region():
    t = Timers()
    with t.time("region"):
        sum(range(1000))
    with t.time("region", sync=torch.zeros(1)):
        pass
    r = t.get("region")
    assert r.count == 2 and r.total >= r.max >= 0.0
    assert "region" in t.report()
