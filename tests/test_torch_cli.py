"""The port's CLI (`python -m transport_se_tpu_torch.main`) == the JAX
package's, on the CPU at ne=2, 16 levels, 2 tracers, in f64.

Both read the same namelist and write the same history file format.  The
tracer records agree to the JAX package's f64 subcycle parity bound
(rtol 1e-11 on O(1) mixing ratios, atol 1e-12): PyTorch and XLA associate
the 4x4 contractions, the limiter's 16-point sums and the level sums
differently.  The flow fields (analytic winds, their assembled vorticity,
omega) agree to a few hundred ulp of their largest value (two libms'
trigonometric functions, einsum orders).  Grid fields are bitwise equal.
An exact restart through the port's CLI is bitwise.
"""

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from transport_se_tpu.main import main as jmain
from transport_se_tpu_torch import main as tmain_mod
from transport_se_tpu_torch.main import main as tmain

torch.set_num_threads(1)

NL = """
&ctl_nl
  test_case         = "dcmip1-1"
  ne                = 2
  qsize             = 2
  nmax              = {nmax}
  statefreq         = 3
  restartfreq       = {restartfreq}
  restartfile       = "./R0001"
  runtype           = {runtype}
  tstep             = 1200
  tstep_type        = 1
  qsplit            = 1
  rsplit            = 3
  nu_q              = 6e16
  limiter_option    = 8
  prescribed_wind   = 1
/
&vert_nl
  vfile_mid         = "vcoord/sabm-16m.ascii"
  vfile_int         = "vcoord/sabm-16i.ascii"
/
&analysis_nl
  output_dir        = "./movies/"
  output_timeunits  = 0
  output_frequency  = 3
  output_varnames1  = 'Q','Q2','ps','geo','u','zeta','omega'
/
"""
EPS = np.finfo(np.float64).eps


def _write_nl(d, nmax=6, restartfreq=-1, runtype=0):
    d.mkdir(parents=True, exist_ok=True)
    path = d / "run.nl"
    path.write_text(NL.format(nmax=nmax, restartfreq=restartfreq,
                              runtype=runtype))
    return str(path)


def _history(d):
    with netcdf_file(str(d / "movies" / "dcmip1-11.nc"), "r",
                     mmap=False) as f:
        return {k: v[:].copy() for k, v in f.variables.items()}


def test_cli_history_matches_jax(tmp_path, monkeypatch, capsys):
    runs = {}
    for name, fn, extra in (("jax", jmain, ["--platform", "cpu"]),
                            ("torch", tmain, ["--device", "cpu"])):
        d = tmp_path / name
        nl = _write_nl(d)
        monkeypatch.chdir(d)
        assert fn([nl, *extra]) == 0
        out = capsys.readouterr().out
        assert "Q1,Q diss, dQ^2/dt:" in out and "done: 6 steps" in out
        runs[name] = _history(d), out
    (want, jout), (got, tout) = runs["jax"], runs["torch"]
    assert "device=cpu" in tout and "CFL estimates" in tout
    assert set(got) == set(want)
    assert got["Q"].shape == (3, 16, want["lat"].shape[0])
    for k in ("lat", "lon", "lev", "ilev", "hyai", "hybi", "area", "time",
              "geo"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("Q", "Q2"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-11, atol=1e-12,
                                   err_msg=k)
    np.testing.assert_allclose(got["ps"], want["ps"], rtol=1e-13)
    for k in ("u", "zeta", "omega"):
        np.testing.assert_allclose(
            got[k], want[k], rtol=0,
            atol=256 * EPS * np.abs(want[k]).max(), err_msg=k)
    # the printstate masses: the same lines to their printed 14 digits
    # (the last one may round the other way)
    pick = [[ln.split()[3][:14] for ln in o.splitlines()
             if ln.startswith("Q1,Q diss")] for o in (jout, tout)]
    assert len(pick[0]) == len(pick[1]) == 2 and pick[0] == pick[1]


def test_cli_exact_restart_bitwise(tmp_path, monkeypatch, capsys):
    straight = tmp_path / "straight"
    nl = _write_nl(straight)
    monkeypatch.chdir(straight)
    assert tmain([nl, "--device", "cpu", "--quiet"]) == 0
    want = _history(straight)

    split = tmp_path / "split"
    nl = _write_nl(split, nmax=3, restartfreq=3)
    monkeypatch.chdir(split)
    assert tmain([nl, "--device", "cpu", "--quiet"]) == 0
    assert "wrote restart ./R0001 at nstep=3" in capsys.readouterr().out
    nl = _write_nl(split, nmax=6, runtype=1)
    assert tmain([nl, "--device", "cpu", "--quiet"]) == 0
    assert "restart (runtype=1)" in capsys.readouterr().out
    got = _history(split)
    # the resumed run's history starts after the restart (no t=0 record)
    assert got["time"].tolist() == want["time"][-1:].tolist()
    for k in ("Q", "Q2", "ps"):
        np.testing.assert_array_equal(got[k][-1], want[k][-1], err_msg=k)


def test_cli_device_defaults_to_cuda(tmp_path, monkeypatch, capsys):
    """Without a card the default device fails; nothing runs on the CPU
    unless --device cpu is given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nl = _write_nl(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert tmain([nl]) == 2
    err = capsys.readouterr().err
    assert "--device cpu" in err
    assert not (tmp_path / "movies").exists()
    with pytest.raises(SystemExit):
        tmain([nl, "--device", "tpu"])
    assert tmain_mod.__doc__ and "--device" in tmain_mod.__doc__


@pytest.mark.parametrize("run", [0, 1, 2])
def test_smoke_namelists_are_the_published_configs(run):
    """chip_smoke.py's CLI runs read as the verification configurations
    of the published norms (config.py dcmip1*_ne*)."""
    import chip_smoke
    from transport_se_tpu_torch import config as tconfig
    from transport_se_tpu_torch.io.namelist import config_from_namelist
    test, ne, tstep, nu_q, days = chip_smoke.CLI_RUNS[run][:5]
    rs = config_from_namelist(chip_smoke.namelist(test, ne, tstep, nu_q,
                                                  days))
    preset = getattr(tconfig, f"dcmip{test[-3]}{test[-1]}_ne{ne}")
    assert rs.cfg == preset(statefreq=rs.cfg.statefreq)
    assert rs.output_frequency == days and rs.output_timeunits == 1


# The JAX package's own result for the published NE8 DCMIP 1-2 run (f64, CPU,
# `scripts/verify.py --test dcmip1-2 --ne 8 --platform cpu --dtype f64`):
# L2, Linf and q_max are the published digits (reference README:96); L1 is
# 0.307660 against the published 0.307665 and q_min is roundoff-scale
# against the published -9.385639e-06.  The JAX package's remap selects a
# source cell two levels down where the reference's walking loop stops one
# level down (prim_advection_mod.F90:159-173 starts at kk = k), and the
# run's Hadley downdraft reaches two levels over the thin acme-72 surface
# layers.
JAX_NE8_DCMIP12 = dict(l1=0.307660, l2=0.622099, linf=0.839133,
                       q_max=0.813105)


@pytest.mark.slow
def test_ne8_dcmip12_cli_matches_jax(tmp_path, monkeypatch):
    """The port's CLI and the JAX package's CLI on the published NE8 DCMIP
    1-2 run (216 steps): the same norms to their six printed decimals, the
    JAX package's, and a roundoff-scale q_min in both."""
    import chip_smoke
    from transport_se_tpu_torch.norms import history_norms
    norms = {}
    for name, fn, extra in (("jax", jmain, ["--platform", "cpu"]),
                            ("torch", tmain, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        (d / "run.nl").write_text(chip_smoke.namelist("dcmip1-2", 8, 400.0,
                                                      6e16, 1))
        monkeypatch.chdir(d)
        assert fn(["run.nl", "--quiet", *extra]) == 0
        norms[name] = history_norms(str(d / "movies" / "dcmip1-21.nc"),
                                    "dcmip1-2", 8)
    for name, nrm in norms.items():
        for key, want in JAX_NE8_DCMIP12.items():
            assert f"{getattr(nrm, key):.6f}" == f"{want:.6f}", (name, key)
        assert abs(nrm.q_min) < 1e-10, (name, nrm.q_min)
