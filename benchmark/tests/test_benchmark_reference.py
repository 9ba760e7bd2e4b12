"""The plain reference against the port's plain T path at ne = 2 and 4,
and what the benchmark's modules import."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.reference import grid as rgrid
from benchmark.reference import transport as R

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAMES = ["q1", "q2", "q3", "q4", "checkerboard"]


def _port(ne, dtype, cap, nq):
    from transport_se_tpu_torch.config import Config
    from transport_se_tpu_torch.model.core import (
        build_model, initial_qdp_t, make_subcycle_fn)
    cfg = Config(ne=ne, test_case="dcmip1-1", tstep=1200.0, qsize=nq,
                 nu_q=6e16, disable_diagnostics=True, dss_mode="face",
                 elem_order="raster", dtype=dtype, use_pallas=True,
                 limiter_iter_cap=cap)
    m = build_model(cfg, "cpu")
    return m, make_subcycle_fn(m, io_layout="t"), initial_qdp_t(m)


@pytest.mark.parametrize("ne,dtype,cap,tol", [
    (2, "f64", 0, 1e-12), (4, "f64", 0, 1e-12), (2, "f32", 4, 1e-4)])
def test_reference_follows_the_port(ne, dtype, cap, tol):
    """Two subcycles of 5 tracers (q1-q4 and the checkerboard): the same
    initial state, then the same fields to roundoff of the dtype."""
    nq = 5
    m, step, Qt = _port(ne, dtype, cap, nq)
    rm = R.build_model(dict(ne=ne, nlev=72, dtype=dtype, tstep=1200.0,
                            rsplit=3, nu_q=6e16, limiter_iter_cap=cap or 15),
                       "cpu")
    f = R.initial_fields(rm)
    Q = torch.stack([f[n] for n in NAMES], 1) \
        * rm.dp0col[None, None, :, None, None]
    E = Q.shape[0]

    def std(x):
        return x.reshape(E, 16, nq, 72).permute(0, 2, 3, 1) \
            .reshape(E, nq, 72, 4, 4)
    assert torch.equal(std(Qt), Q)
    n = nr = 0
    for _ in range(2):
        Qt, _, n, md = step([Qt], n)
        Q, nr, mdr = R.subcycle(rm, Q, nr)
        d = (std(Qt) - Q).abs().amax(dim=(0, 2, 3, 4)) \
            / Q.abs().amax(dim=(0, 2, 3, 4))
        assert float(d.max()) < tol
        assert float(md) == pytest.approx(float(mdr), rel=1e-6)


@pytest.mark.parametrize("ne", [2, 4])
def test_grid_matches_the_port(ne):
    from transport_se_tpu_torch.grid.cubesphere import build_grid
    g = rgrid.build(ne)
    p = build_grid(ne, order="raster")
    for k in ("lon", "lat", "Dinv", "metdet", "spheremp", "rspheremp",
              "deriv"):
        a, b = getattr(g, k), getattr(p, k)
        assert abs(a - b).max() <= 1e-13 * abs(b).max(), k
    # the same points coincide: each slot's partners are the other slots
    # of its global point
    gid = g.gid
    for s in range(3):
        m = p.part_mask[:, s]
        assert (gid[p.part_idx[m, s]] == gid[m]).all()


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").glob("*.py")):
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("transport_se_tpu_torch", "transport_se_tpu",
                               "jax", "jaxlib", "flax"), (f.name, name)
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.transport as R; "
            "m = R.build_model(dict(ne=2, nlev=72, dtype='f64', tstep=1200.0,"
            " rsplit=3, nu_q=6e16, limiter_iter_cap=15), 'cpu'); "
            "f = R.initial_fields(m); "
            "R.subcycle(m, f['q1'][:, None] * m.dp0col[None, None, :, None, "
            "None], 0); "
            "print(sorted({n.split('.')[0] for n in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=str(ROOT)).stdout
    mods = set(eval(out.strip().splitlines()[-1]))
    assert not mods & {"transport_se_tpu_torch", "transport_se_tpu", "jax",
                       "jaxlib", "flax"}


def test_a_run_loads_no_jax(tmp_path):
    """A whole run on the CPU at ne = 2 (the harness, the port, the
    reference) leaves no module whose top-level name is jax, jaxlib, flax
    or transport_se_tpu."""
    code = ("import sys, time; t = time.perf_counter(); "
            "sys.path.insert(0, %r); "
            "from benchmark import harness; "
            "r = harness.run_cell('ne30_perf.q35', 7, 0.2, 0, t, "
            "device='cpu', config_overrides={'ne': 2}, "
            "traffic_overrides={'qsize': 5, 'warmup_subcycles': 1}); "
            "assert r['correct'], r; "
            "print(harness.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=str(tmp_path)).stdout
    assert out.strip().splitlines()[-1] == "[]"
