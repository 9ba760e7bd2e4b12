"""The port's own host modules == the JAX package's, bitwise.

The port keeps copies of the JAX package's numpy modules (config,
constants, grid, native, io.namelist, io.history, io.restart, norms) and
imports nothing of the JAX package.  These tests hold every copy to its
original: the grid's fields at ne=2 and 4 in both element orders, the
native table builder against its numpy fallback, the vertical coordinate
(also through the namelist's vfile route), the Config dataclass and its
presets, the namelist parse, the DCMIP norms and the restart format in both
directions.  The last test imports every module of the port, and
chip_smoke.py's import block, with `jax` and `transport_se_tpu` blocked.

`port_config` is the one helper that carries a JAX Config into the port:
the other port tests build their JAX models from a JAX Config and their
port models from its port twin.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from transport_se_tpu import config as jconfig
from transport_se_tpu.grid import cubesphere as jgrid
from transport_se_tpu.grid import vcoord as jvcoord
from transport_se_tpu.io import namelist as jnamelist
from transport_se_tpu.io import restart as jrestart
from transport_se_tpu import norms as jnorms
from transport_se_tpu_torch import config as tconfig
from transport_se_tpu_torch import native as tnative
from transport_se_tpu_torch import norms as tnorms
from transport_se_tpu_torch.grid import cubesphere as tgrid
from transport_se_tpu_torch.grid import vcoord as tvcoord
from transport_se_tpu_torch.io import namelist as tnamelist
from transport_se_tpu_torch.io import restart as trestart

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_config(jcfg) -> tconfig.Config:
    """The port's Config with every field of the JAX Config `jcfg`."""
    if not isinstance(jcfg, jconfig.Config):
        raise TypeError(f"not a JAX package Config: {type(jcfg)}")
    return tconfig.Config(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(jcfg)})


def _assert_same(a, b, what):
    """Field-by-field equality of two dataclass instances, arrays bitwise
    (values, dtype and shape)."""
    fa = [f.name for f in dataclasses.fields(a)]
    assert fa == [f.name for f in dataclasses.fields(b)], what
    for k in fa:
        x, y = getattr(a, k), getattr(b, k)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
            assert np.array_equal(x, y), (what, k)
        else:
            assert type(x) is type(y) and x == y, (what, k)


# ---------------------------------------------------------------------------
# grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ne", [2, 4])
@pytest.mark.parametrize("order", ["gilbert", "raster"])
def test_build_grid_bitwise(ne, order):
    _assert_same(tgrid.build_grid(ne, order=order),
                 jgrid.build_grid(ne, order=order), f"grid ne={ne} {order}")


@pytest.mark.parametrize("order", ["gilbert", "raster"])
def test_native_builder_matches_numpy_fallback(order, monkeypatch):
    assert tnative.get_lib() is not None, "g++ build of gridtables.cpp"
    native = tgrid.build_grid(4, order=order)
    monkeypatch.setenv("TRANSPORT_SE_NO_NATIVE", "1")
    assert tnative.build_point_tables(np.zeros((16, 3)), 16, 1e-7) is None
    _assert_same(tgrid.build_grid(4, order=order), native, "fallback")


def test_native_library_builds_into_build_dir(tmp_path, monkeypatch):
    """The loader compiles to a name of its own and renames into place,
    in _build/ (gitignored), never beside the source."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    out = tnative.library_path()
    assert out.parent == tmp_path / "_build" and out.suffix == ".so"
    assert tnative._build(out) and out.exists()
    assert [p.name for p in out.parent.iterdir()] == [out.name]
    src_dir = os.path.dirname(tnative.__file__)
    assert not [n for n in os.listdir(src_dir) if n.endswith(".so")]


# ---------------------------------------------------------------------------
# vertical coordinate, config, namelist
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["acme72", "dcmip8", "dcmip16", "dcmip64",
                                   "files"])
def test_hvcoord_bitwise(which):
    if which == "acme72":
        t, j = tvcoord.hvcoord_acme72(), jvcoord.hvcoord_acme72()
    elif which == "files":
        d = os.path.join(REPO, "transport_se_tpu", "data")
        paths = (os.path.join(d, "acme-72m.ascii"),
                 os.path.join(d, "acme-72i.ascii"))
        t, j = (tvcoord.hvcoord_from_files(*paths),
                jvcoord.hvcoord_from_files(*paths))
    else:
        n = int(which[len("dcmip"):])
        t, j = tvcoord.hvcoord_dcmip(n), jvcoord.hvcoord_dcmip(n)
    _assert_same(t, j, which)
    for k in ("nlev", "etam", "etai", "dp0"):
        assert np.array_equal(getattr(t, k), getattr(j, k)), k


def test_config_fields_and_defaults():
    tf, jf = dataclasses.fields(tconfig.Config), dataclasses.fields(
        jconfig.Config)
    assert [(f.name, f.type, f.default) for f in tf] == \
        [(f.name, f.type, f.default) for f in jf]
    assert dataclasses.asdict(tconfig.Config()) == \
        dataclasses.asdict(jconfig.Config())
    for prop in ("np_dtype", "dt_tracer", "dt_remap", "nsteps"):
        assert getattr(tconfig.Config(ndays=1), prop) == \
            getattr(jconfig.Config(ndays=1), prop)


PRESETS = [("dcmip11_ne8", {}), ("dcmip12_ne8", {}), ("dcmip11_ne30", {}),
           ("dcmip12_ne30", dict(dtype="f32")),
           ("perf_config", dict(ne=30, dtype="f32", use_pallas=True)),
           ("perf_config", dict(ne=8, dss_mode="gather")),
           ("perf_config", dict(ne=42, dtype="f64"))]


@pytest.mark.parametrize("name, kw", PRESETS)
def test_config_presets(name, kw):
    t = getattr(tconfig, name)(**kw)
    j = getattr(jconfig, name)(**kw)
    assert isinstance(t, tconfig.Config)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert port_config(j) == t


@pytest.mark.parametrize("kw, err", [
    (dict(qsplit=0), ValueError), (dict(rsplit=0), NotImplementedError),
    (dict(limiter_option=2), NotImplementedError),
    (dict(dss_mode="face"), ValueError),
    (dict(limiter_iter_cap=4), ValueError),
    (dict(ppm_search="slow"), ValueError)])
def test_config_rejects_as_jax(kw, err):
    for mod in (tconfig, jconfig):
        with pytest.raises(err):
            mod.Config(**kw)


def _namelists(tmp_path):
    import chip_smoke
    from test_io import REF_NL
    from test_torch_cli import NL
    out = {"ref": (REF_NL, None), "cli": (NL.format(nmax=6, runtype=0,
                                                      restartfreq=-1), None)}
    for i, run in enumerate(chip_smoke.CLI_RUNS):
        out[f"smoke{i}"] = (chip_smoke.namelist(*run[:5]), None)
    # the vfile route: the named files exist relative to the namelist
    d = tmp_path / "nl"
    (d / "vcoord").mkdir(parents=True)
    for name in ("acme-72m.ascii", "acme-72i.ascii"):
        shutil.copy(os.path.join(REPO, "transport_se_tpu", "data", name),
                    d / "vcoord" / name)
    out["vfile"] = (chip_smoke.namelist(*chip_smoke.CLI_RUNS[0][:5]), str(d))
    out["dcmip"] = (chip_smoke.namelist(*chip_smoke.CLI_RUNS[0][:5])
                    .replace("acme-72m", "dcmip-30m")
                    .replace("acme-72i", "dcmip-30i"), None)
    return out


def test_config_from_namelist_bitwise(tmp_path):
    nls = _namelists(tmp_path)
    for name, (text, nl_dir) in nls.items():
        kw = {} if nl_dir is None else dict(nl_dir=nl_dir)
        t = tnamelist.config_from_namelist(text, **kw)
        j = jnamelist.config_from_namelist(text, **kw)
        assert dataclasses.asdict(t.cfg) == dataclasses.asdict(j.cfg), name
        assert isinstance(t.cfg, tconfig.Config)
        for k in ("runtype", "restartfreq", "restartfile", "output_dir",
                  "output_frequency", "output_timeunits", "output_varnames"):
            assert getattr(t, k) == getattr(j, k), (name, k)
    # the vfile route reaches the files, and the model's coordinate is the
    # JAX one read from them
    from transport_se_tpu_torch.model.core import hvcoord
    cfg = tnamelist.config_from_namelist(*nls["vfile"]).cfg
    assert cfg.vcoord.startswith("files:" + nls["vfile"][1])
    _assert_same(hvcoord(cfg), jvcoord.hvcoord_from_files(
        *cfg.vcoord.split(":")[1:]), "vfile")
    bad = nls["ref"][0].replace("tstep_type        = 1",
                                "tstep_type        = 5")
    for mod in (tnamelist, jnamelist):
        with pytest.raises(NotImplementedError):
            mod.config_from_namelist(bad)


# ---------------------------------------------------------------------------
# norms and restart
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ne", [2, 8])
def test_dcmip_error_norms_bitwise(ne):
    rng = np.random.default_rng(ne)
    nlev, ncol = 16, 6 * (3 * ne) ** 2 + 2
    q0 = rng.uniform(0, 1, (nlev, ncol))
    q1 = q0 + 1e-3 * rng.standard_normal((nlev, ncol))
    lat = rng.uniform(-1.5, 1.5, ncol)
    zm = np.sort(rng.uniform(100, 12000, nlev))[::-1].copy()
    t = tnorms.dcmip_error_norms(q0, q1, lat, zm, ne=ne)
    j = jnorms.dcmip_error_norms(q0, q1, lat, zm, ne=ne)
    assert dataclasses.asdict(t) == dataclasses.asdict(j) and str(t) == str(j)
    grid = tgrid.build_grid(2)
    f = rng.standard_normal((24, 2, nlev, 4, 4))
    for tr in (0, 1):
        assert np.array_equal(tnorms.unique_columns(grid, f, tr),
                              jnorms.unique_columns(grid, f, tr))
    for case in ("dcmip1-1", "dcmip1-2"):
        assert tnorms.grade_tracer(case) == jnorms.grade_tracer(case)


@pytest.mark.parametrize("writer, reader", [(jrestart, trestart),
                                            (trestart, jrestart)])
def test_restart_read_across_packages(tmp_path, writer, reader):
    """A restart written by either package reads back bitwise in the
    other, header and all, and passes its compatibility check."""
    cfg = tconfig.Config(ne=2, nlev=8, qsize=3, vcoord="dcmip8")
    model = types.SimpleNamespace(
        cfg=cfg if writer is trestart else jconfig.Config(
            **dataclasses.asdict(cfg)))
    rng = np.random.default_rng(3)
    Qdp = rng.standard_normal((24, 3, 8, 4, 4))
    ps = rng.standard_normal((24, 4, 4))
    path = str(tmp_path / "R0001")
    writer.write_restart(path, model, Qdp, ps, 9)
    st = reader.read_restart(path)
    assert st.nstep == 9 and st.header["version"] == reader.VERSION == 1
    assert np.array_equal(st.Qdp, Qdp) and np.array_equal(st.ps_v, ps)
    reader.check_compatible(st, model.cfg, exact=True)
    with pytest.raises(ValueError, match="ne"):
        reader.check_compatible(st, dataclasses.replace(model.cfg, ne=3),
                                exact=False)


# ---------------------------------------------------------------------------
# the port imports nothing of the JAX package
# ---------------------------------------------------------------------------

BLOCKED_IMPORTS = r'''
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "transport_se_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import transport_se_tpu_torch
names = ["transport_se_tpu_torch"]
for info in pkgutil.walk_packages(transport_se_tpu_torch.__path__,
                                  "transport_se_tpu_torch.",
                                  onerror=lambda n: sys.exit(f"walk {n}")):
    importlib.import_module(info.name)
    names.append(info.name)
import chip_smoke
chip_smoke.port_modules()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "transport_se_tpu"))
assert not bad, bad
print(len(names))
'''


def test_port_imports_nothing_of_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", BLOCKED_IMPORTS], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 30


def test_port_refuses_the_jax_config():
    """No duck typing: the port's entry points take only its own Config."""
    from transport_se_tpu_torch.model import core as tcore
    from transport_se_tpu_torch.model.driver import run_simulation
    jcfg = jconfig.Config(ne=2, nlev=8, qsize=1, vcoord="dcmip8", nmax=3)
    for call in (lambda: tcore.build_model(jcfg, "cpu"),
                 lambda: run_simulation(jcfg, "cpu")):
        with pytest.raises(TypeError, match="transport_se_tpu_torch"):
            call()
