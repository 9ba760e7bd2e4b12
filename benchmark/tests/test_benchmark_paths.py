"""The pipelines and DCMIP tests a configuration file can choose, on the
CPU: the plain reference against the port's plain T path under DCMIP 1-2
and against its std-layout verification path (gather DSS on the gilbert
order, f64, the full limiter iteration) under 1-1 and 1-2, through the
element map; a whole T-path run at ne = 2 under 1-2; the lanes drawn for
1-1 pinned; a run whose elements do not map one to one onto the
reference's refused.  (The std path's whole runs, sound and broken:
test_benchmark_faults.py.)"""

import time

import pytest
import torch

from benchmark import harness
from benchmark.reference import transport as R
from benchmark.tests.test_benchmark_faults import STD_12

# NE30's step and hyperviscosity (test/run_ne30_tests.sh): at 1200 s the
# DCMIP 1-2 winds move a level past the remap's window, min_dp < 0
TSTEP, NU_Q = 300.0, 1e15


def _reference(ne, dtype, cap, test_case):
    return R.build_model(dict(ne=ne, nlev=72, dtype=dtype, tstep=TSTEP,
                              rsplit=3, nu_q=NU_Q, limiter_iter_cap=cap,
                              test_case=test_case), "cpu")


def _port(ne, dtype, cap, test_case, nq, std):
    from transport_se_tpu_torch.config import Config
    from transport_se_tpu_torch.model.core import (
        build_model, initial_qdp, initial_qdp_t, make_subcycle_fn)
    order = dict(dss_mode="gather", elem_order="gilbert") if std else \
        dict(dss_mode="face", elem_order="raster")
    cfg = Config(ne=ne, test_case=test_case, tstep=TSTEP, qsize=nq,
                 nu_q=NU_Q, disable_diagnostics=True, dtype=dtype,
                 use_pallas=not std, limiter_iter_cap=cap, **order)
    m = build_model(cfg, "cpu")
    step = make_subcycle_fn(m, io_layout="std" if std else "t")
    return m, step, initial_qdp(m) if std else initial_qdp_t(m)


def _follow(ne, dtype, cap, tol, test_case, std):
    """Two subcycles of 5 tracers in the reference model's order: the same
    initial state, then the same fields to roundoff of the dtype, each
    compared in the reference's element order."""
    nq = 5
    m, step, X = _port(ne, dtype, cap, test_case, nq, std)
    rm = _reference(ne, dtype, cap, test_case)
    f = R.initial_fields(rm)
    Q = torch.stack([f[n] for n in R.lane_fields(test_case, nq)], 1) \
        * rm.dp0col[None, None, :, None, None]
    E = Q.shape[0]
    emap = harness.element_map(m.lon, m.lat, rm.lon, rm.lat)
    assert (emap is not None) == std

    def ref(x):
        return harness.to_reference_order(
            harness.to_std(x.reshape(E, 16, nq, 72) if not std else x, E,
                           72, not std), emap)
    assert torch.equal(ref(X), Q)
    n = nr = 0
    for _ in range(2):
        X, _, n, md = step([X], n)
        Q, nr, mdr = R.subcycle(rm, Q, nr)
        d = (ref(X) - Q).abs().amax(dim=(0, 2, 3, 4)) \
            / Q.abs().amax(dim=(0, 2, 3, 4))
        assert float(d.max()) < tol
        assert float(md) == pytest.approx(float(mdr), rel=1e-6)


@pytest.mark.parametrize("ne,dtype,cap,tol", [
    (2, "f64", 0, 1e-12), (4, "f64", 0, 1e-12), (2, "f32", 4, 1e-4)])
def test_reference_follows_the_t_path_under_dcmip12(ne, dtype, cap, tol):
    _follow(ne, dtype, cap, tol, "dcmip1-2", std=False)


@pytest.mark.parametrize("test_case,ne", [
    ("dcmip1-1", 2), ("dcmip1-2", 2), ("dcmip1-2", 4)])
def test_reference_follows_the_std_path(test_case, ne):
    _follow(ne, "f64", 0, 1e-12, test_case, std=True)


def test_reference_refuses_a_test_case_it_does_not_ship():
    with pytest.raises(ValueError, match="dcmip2-1"):
        _reference(2, "f64", 0, "dcmip2-1")


# ---------------------------------------------------------------------------
# whole runs at ne = 2
# ---------------------------------------------------------------------------

T_12 = dict(config_overrides={"ne": 2, "test_case": "dcmip1-2"},
            traffic_overrides={"qsize": 6, "winds": "dcmip1-2",
                               "warmup_subcycles": 2})


def run(settings, fault=None, seed=2**31 + 9):
    return harness.run_cell("ne30_perf.q35", seed, 0.3, 0,
                            time.perf_counter(), device="cpu", fault=fault,
                            **settings)


def test_a_dcmip12_run_on_the_t_path_is_correct():
    """(The std path's: test_benchmark_faults.py, with its faults.)"""
    r = run(T_12)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] >= 1


# ---------------------------------------------------------------------------
# the lanes and the element map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,where,lanes", [
    (0, {"q1": 9, "q2": 17, "q3": 27, "q4": 21}, [2, 9, 12, 17, 21, 27]),
    (12345, {"q1": 11, "q2": 7, "q3": 26, "q4": 22},
     [7, 10, 11, 22, 26, 32]),
    (2**31 + 12345, {"q1": 15, "q2": 23, "q3": 29, "q4": 14},
     [7, 14, 15, 23, 29, 30]),
    (2**32 + 5, {"q1": 4, "q2": 25, "q3": 26, "q4": 16},
     [3, 4, 16, 19, 25, 26])])
def test_dcmip11_lanes_are_pinned(seed, where, lanes):
    """The lanes every existing cell draws at these seeds, as drawn before
    the test case chose the named fields."""
    fields, got = harness.draw_lanes(seed, 35, 6)
    assert got == lanes
    assert {f: fields.index(f) for f in where} == where
    assert fields.count("checkerboard") == 31
    assert harness.draw_lanes(seed, 35, 6, "dcmip1-1") == (fields, got)


def test_dcmip12_lanes_check_the_hadley_layer():
    for seed in (1, 2**31 + 3, 2**32 + 7):
        fields, lanes = harness.draw_lanes(seed, 35, 6, "dcmip1-2")
        assert fields.count("hadley") == 1 \
            and fields.count("checkerboard") == 34
        assert fields.index("hadley") in lanes and len(lanes) == 6
        assert sum(lane < 17 for lane in lanes) >= 2 \
            and sum(lane >= 17 for lane in lanes) >= 2
    fields, lanes = harness.draw_lanes(5, 4, 6, "dcmip1-2")
    assert sorted(fields) == ["checkerboard"] * 3 + ["hadley"]
    assert lanes == [0, 1, 2, 3]


def test_element_map_undoes_a_shuffle():
    rm = _reference(4, "f64", 0, "dcmip1-1")
    E = rm.lon.shape[0]
    assert harness.element_map(rm.lon, rm.lat, rm.lon, rm.lat) is None
    g = torch.Generator().manual_seed(3)
    perm = torch.randperm(E, generator=g)
    pts = torch.stack([torch.randperm(16, generator=g) for _ in range(E)])

    def shuffle(x):
        return x.reshape(E, 16)[perm].gather(1, pts).reshape(E, 4, 4)
    plon, plat = shuffle(rm.lon), shuffle(rm.lat)
    emap = harness.element_map(plon, plat, rm.lon, rm.lat)
    X = torch.stack([plon, plat], 1)[:, :, None]        # [E, 2, 1, 4, 4]
    back = harness.to_reference_order(X, emap)
    assert torch.equal(back[:, 0, 0], rm.lon)
    assert torch.equal(back[:, 1, 0], rm.lat)


def test_a_map_that_is_not_one_to_one_is_refused():
    rm = _reference(2, "f64", 0, "dcmip1-1")
    lon, lat = rm.lon.clone(), rm.lat.clone()
    lon[1], lat[1] = lon[0], lat[0]
    with pytest.raises(harness.Refused, match="elements"):
        harness.element_map(lon, lat, rm.lon, rm.lat)
    # two points of an element moved to their midpoint: the element's
    # centre stays where it was, its points have no one-to-one map
    xyz = harness._unit_xyz(rm.lon[2, 0, 1:3], rm.lat[2, 0, 1:3]).mean(0)
    lon, lat = rm.lon.clone(), rm.lat.clone()
    lon[2, 0, 1:3] = torch.atan2(xyz[1], xyz[0]) % (2 * torch.pi)
    lat[2, 0, 1:3] = torch.asin(xyz[2] / torch.linalg.vector_norm(xyz))
    with pytest.raises(harness.Refused, match="points"):
        harness.element_map(lon, lat, rm.lon, rm.lat)


def test_a_run_whose_elements_do_not_map_is_refused(monkeypatch):
    places = harness.Program.places

    def twin(prog):
        lon, lat = places(prog)
        lon[1], lat[1] = lon[0], lat[0]
        return lon, lat
    monkeypatch.setattr(harness.Program, "places", twin)
    with pytest.raises(harness.Refused, match="one to one"):
        run(STD_12)
