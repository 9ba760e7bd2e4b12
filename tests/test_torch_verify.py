"""The port's verification tools == the JAX package's, on the CPU.

`transport_se_tpu_torch.verify` against `scripts/verify.py`: the Config
its flags build, field by field, and the DCMIP norms of a run against the
JAX package's `run_simulation` and norms at the same flags (ne = 2, 16
levels, 2 tracers, 6 steps, the T-layout kernel path through the plain
versions, the JAX kernels in interpret mode).  In f64 the norms agree to
1e-12 relative: the two runs agree to 1e-11 of the field
(test_torch_subcycle_face.py), and the norms are ratios of sums over the
columns of the change, O(0.1) of the field at this size.  In f32 with the
limiter capped at 4 iterations, to 1e-5 relative, the port's f32 parity
bound of the kernels (test_torch_ppm.py PALLAS_TOL): the two frameworks
round the advection, the prefix sums and the limiter's sums in other
orders.

`transport_se_tpu_torch.audit_drift` against `scripts/audit_drift.py`: the
configuration and subcycle count its flags give, and at ne = 2 over two
subcycles the masses of every tracer and level before and after the run
against the JAX package's same run (the script's NE8 settings at ne = 2,
which the script itself has none for), summed in f32 as the script sums
them.  The masses agree to 1e-5 of each tracer's largest level mass
(F32_TOL; they differ by ~3e-6), and the run moves each tracer's mass
between levels by more than ten times that, so a state a subcycle off
fails.  The drift itself is f32 roundoff of the sums at this size (~2e-7
per tracer) and differs between the frameworks by as much: it is held to
the returned masses and to a floor above zero.

Both refuse to run without a card unless --device cpu is given.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transport_se_tpu.config import Config as JConfig
from transport_se_tpu.config import perf_config as jperf_config
from transport_se_tpu.constants import SCALE_HEIGHT
from transport_se_tpu.model import core as jcore
from transport_se_tpu.model.driver import run_simulation as jrun
from transport_se_tpu.norms import (dcmip_error_norms, grade_tracer,
                                    unique_columns)
from transport_se_tpu_torch import audit_drift, verify
from transport_se_tpu_torch.model import core

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# the size of test_torch_subcycle_face.py: 6 steps = 2 subcycles (the
# days as a float give int(days * 86400 / tstep) = 6)
SMALL = ["--ne", "2", "--nlev", "16", "--qsize", "2", "--tstep", "1200",
         "--nu_q", "6e16", "--days", "0.0834", "--pallas", "--device",
         "cpu"]
# the port's f32 parity bound of the kernels (test_torch_ppm.py PALLAS_TOL)
F32_TOL = 1e-5
# the T path through the plain versions: K1, K3, K4, K5, K6; no K2, K10
T_PATH = {"fused_advect_limit_plain": 18, "remap_q_ppm_t_plain": 2,
          "dss_face_plain": 4 * 6 + 6, "minmax_prep_plain": 2,
          "neighbor_minmax_plain": 12}


class _Built(Exception):
    pass


def jax_script_config(flags, monkeypatch):
    """The JAX Config that scripts/verify.py builds from flags (its run
    stopped where it starts)."""
    spec = importlib.util.spec_from_file_location(
        "jax_verify_script", ROOT / "scripts" / "verify.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    from transport_se_tpu.model import driver
    seen = {}

    def stop(cfg, **kw):
        seen["cfg"] = cfg
        raise _Built

    monkeypatch.setattr(driver, "run_simulation", stop)
    monkeypatch.setattr("sys.argv", ["verify.py", *flags])
    with pytest.raises(_Built):
        mod.main()
    return seen["cfg"]


CONFIG_FLAGS = {
    "defaults": [],
    "pallas": ["--pallas"],
    "pallas_f32_cap": ["--pallas", "--dtype", "f32", "--limcap", "4"],
    "ne30_12": ["--test", "dcmip1-2", "--ne", "30", "--pallas", "--dtype",
                "f32"],
    "ne120_64L": ["--ne", "120", "--nlev", "64", "--tstep", "75", "--nu_q",
                  "1e13", "--pallas"],
    "segsum_days": ["--dss", "segsum", "--days", "0.5", "--qsize", "35"],
    "small": SMALL[:-2],
}


@pytest.mark.parametrize("case", list(CONFIG_FLAGS))
def test_config_matches_the_jax_script(case, monkeypatch, capsys):
    flags = CONFIG_FLAGS[case]
    want = jax_script_config(flags, monkeypatch)
    got = verify.build_config(verify.parser().parse_args(flags))
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def jax_norms(cfg):
    """scripts/verify.py's run and norms of the port's cfg, through the
    JAX package."""
    jcfg = JConfig(**dataclasses.asdict(cfg))
    res = jrun(jcfg, verbose=False)
    g = res.model.grid
    tr = grade_tracer(cfg.test_case)
    qi = unique_columns(g, res.q_init, tr)
    qf = unique_columns(g, res.q_final, tr)
    lat_col = g.lat.reshape(-1)[g.uniq_src]
    zm = SCALE_HEIGHT * np.log(1.0 / np.asarray(res.model.etam))
    return (dcmip_error_norms(qi, qf, lat_col, zm, ne=cfg.ne),
            res.log.max_relative_mass_drift())


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_verify_matches_jax(dtype, capsys):
    flags = SMALL + ["--dtype", dtype] + (
        ["--limcap", "4"] if dtype == "f32" else [])
    got = verify.main(flags)
    out = capsys.readouterr().out
    cfg = got["config"]
    assert cfg.nsteps == got["steps"] == 6 and got["subcycles"] == 2
    assert core.uses_t_layout(cfg) and cfg.dss_mode == "face"
    assert got["launches"] == T_PATH
    assert "launches: fused_advect_limit_plain 18" in out
    assert "DCMIP dcmip1-1 NE2: L1=" in out
    want, jdrift = jax_norms(cfg)
    tol = 1e-12 if dtype == "f64" else F32_TOL
    n = got["norms"]
    for k in ("l1", "l2", "linf", "q_max"):
        assert getattr(n, k) == pytest.approx(getattr(want, k), rel=tol), k
    # q_min is a roundoff-scale undershoot here: held at the field's scale
    assert abs(n.q_min - want.q_min) <= tol * want.q_max
    assert got["drift"] < (1e-13 if dtype == "f64" else 1e-5)
    assert jdrift < (1e-13 if dtype == "f64" else 1e-5)


@pytest.mark.parametrize("tool", [verify.main, audit_drift.main])
def test_refuses_without_a_card(tool, capsys, monkeypatch):
    """--device defaults to cuda and exits 2 where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tool(["--ne", "2"])
    assert e.value.code == 2
    assert "--device cpu" in capsys.readouterr().err


def jax_audit_script(ne, days, monkeypatch):
    """(cfg, nsub) of scripts/audit_drift.py at AUDIT_NE=ne,
    AUDIT_DAYS=days (its run stopped where it builds the model)."""
    spec = importlib.util.spec_from_file_location(
        "jax_audit_script", ROOT / "scripts" / "audit_drift.py")
    mod = importlib.util.module_from_spec(spec)

    def stop(cfg):
        raise _Built

    monkeypatch.setattr(jcore, "build_model", stop)
    monkeypatch.setenv("AUDIT_NE", str(ne))
    monkeypatch.setenv("AUDIT_DAYS", str(days))
    with pytest.raises(_Built):
        spec.loader.exec_module(mod)
    return mod.cfg, mod.nsub


@pytest.mark.parametrize("ne,days", [(8, 12.0), (30, 1.0), (8, 0.0834)])
def test_audit_drift_config_matches_the_jax_script(ne, days, monkeypatch):
    want, want_nsub = jax_audit_script(ne, days, monkeypatch)
    got, nsub = audit_drift.run_config(ne, days)
    assert nsub == want_nsub
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_audit_drift_small(capsys):
    got = audit_drift.main(["--ne", "2", "--days", "0.0834", "--device",
                            "cpu"])
    out = capsys.readouterr().out
    assert got["ok"] and "DRIFT GATE (2e-04) PASS" in out
    assert got["ne"] == 2 and got["subcycles"] == 2 and got["cap"] == 4
    assert got["min_dp"] > 0
    # the JAX package's run, as scripts/audit_drift.py makes it
    cfg = dataclasses.replace(jperf_config(8, dtype="f32", use_pallas=True),
                              ne=2)
    assert dataclasses.asdict(got["config"]) == dataclasses.asdict(cfg)
    m = jcore.build_model(cfg)
    E, qk = m.grid.nelem, cfg.qsize * cfg.nlev
    step = jax.jit(jcore.make_subcycle_fn(m, diagnostics=False,
                                          io_layout="t"))
    Q = jcore._tp(jax.jit(lambda: jcore.initial_qdp(m))(), E, qk)
    sp = m.spheremp.reshape(E, 16, 1)

    def mass(q):
        return np.asarray((q * sp).sum(axis=(0, 1)), np.float64) \
            .reshape(cfg.qsize, cfg.nlev)

    m0, nstep = mass(Q), jnp.asarray(0, jnp.int32)
    for _ in range(2):
        Q, _, nstep, _ = step(Q, nstep)
    m1 = mass(Q)
    scale = np.abs(m0).max(axis=1, keepdims=True)
    assert (np.abs(m1 - m0) / scale).max(axis=1).min() > 10 * F32_TOL
    for key, want in (("mass0", m0), ("mass1", m1)):
        assert got[key].shape == want.shape
        assert (np.abs(got[key] - want) / scale).max() <= F32_TOL, key
    s0, s1 = got["mass0"].sum(axis=1), got["mass1"].sum(axis=1)
    np.testing.assert_array_equal(got["drift"], np.abs(s1 - s0) / np.abs(s0))
    assert np.median(got["drift"]) > 1e-8 and got["max"] < 1e-5
