"""Whole runs of a cell on the CPU at a small size (ne = 2, 4 or 6 tracers,
so every lane is checked), with the program's subcycle broken underneath:
`correct` has to come out false for each fault a one-chip cell can have,
from the first subcycle on and from the window's first on, and true for
the sound program.  Each on the T-layout pipeline ([E, 16, q*k]) and on
the std-layout verification path ([E, q, k, 4, 4]) with the settings of
the coming `ne30_dcmip12_f64` (f64, gather DSS on the gilbert order, the
full limiter iteration, DCMIP 1-2)."""

import time

import pytest

from benchmark import harness

SMALL = dict(config_overrides={"ne": 2},
             traffic_overrides={"qsize": 6, "warmup_subcycles": 2})
STD_12 = dict(
    config_overrides={"ne": 2, "use_pallas": False, "dtype": "f64",
                      "dss_mode": "gather", "elem_order": "gilbert",
                      "limiter_iter_cap": 0, "test_case": "dcmip1-2"},
    traffic_overrides={"qsize": 4, "winds": "dcmip1-2",
                       "warmup_subcycles": 2})
PIPELINES = pytest.mark.parametrize(
    "workload,settings", [("ne120_perf.q35", SMALL),
                          ("ne30_perf.q35", STD_12)], ids=["t", "std"])


def run(fault=None, seed=5, workload="ne120_perf.q35", settings=SMALL):
    return harness.run_cell(workload, seed, 0.3, 0, time.perf_counter(),
                            device="cpu", fault=fault, **settings)


def after(calls, broken):
    """A fault that breaks the subcycle from its `calls`-th call on."""
    def wrap(step):
        n = [0]

        def faulty(box, nstep):
            n[0] += 1
            if n[0] > calls:
                return broken(step, box, nstep)
            return step(box, nstep)
        return faulty
    return wrap


def by_tracer(Q):
    """(a view of the state with a tracer axis, that axis): [E, 16, q, k]
    of the T layout's [E, 16, q*k], or the std layout itself."""
    return (Q.unflatten(2, (-1, 72)), 2) if Q.dim() == 3 else (Q, 1)


def unchanged(step, box, nstep):
    """The state comes back as it went in."""
    Q = box[0]
    return Q, None, nstep + 3, Q.new_full((), 1.0)


def half_the_tracers(step, box, nstep):
    """The second half of the tracers is left out: returned as it went
    in."""
    keep, _ = by_tracer(box[0].clone())
    Q, ps, n, md = step(box, nstep)
    v, ax = by_tracer(Q)
    q = v.shape[ax]
    v.narrow(ax, q // 2, q - q // 2).copy_(keep.narrow(ax, q // 2,
                                                       q - q // 2))
    return Q, ps, n, md


def half_the_elements(step, box, nstep):
    """The second half of the elements is left out."""
    keep = box[0].clone()
    Q, ps, n, md = step(box, nstep)
    E = Q.shape[0]
    Q[E // 2:] = keep[E // 2:]
    return Q, ps, n, md


def one_value(step, box, nstep):
    """One value of tracer 1 (element 3, level 36) changed where the
    subcycle produces it, by 1% of that tracer's largest value."""
    Q, ps, n, md = step(box, nstep)
    v, ax = by_tracer(Q)
    t = v.select(ax, 1)
    t[(3, 5, 36) if ax == 2 else (3, 36, 1, 2)] += 0.01 * t.abs().max()
    return Q, ps, n, md


@PIPELINES
def test_the_sound_program_is_correct(workload, settings):
    r = run(workload=workload, settings=settings)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] >= 1


@PIPELINES
@pytest.mark.parametrize("calls", [0, 2], ids=["from_start", "window_only"])
@pytest.mark.parametrize("broken", [unchanged, half_the_tracers,
                                    half_the_elements, one_value],
                         ids=lambda f: f.__name__)
def test_a_broken_subcycle_is_not_correct(broken, calls, workload,
                                          settings):
    r = run(after(calls, broken), workload=workload, settings=settings)
    assert not r["correct"], r["check"]
    # the closing subcycle is judged whenever the fault is in it
    assert r["check"]["last_max"]["value"] > \
        r["check"]["last_max"]["limit"]


@PIPELINES
def test_a_non_finite_state_is_not_correct(workload, settings):
    def nan(step, box, nstep):
        Q, ps, n, md = step(box, nstep)
        Q[(0,) * Q.dim()] = float("nan")
        return Q, ps, n, md
    r = run(after(2, nan), workload=workload, settings=settings)
    assert not r["correct"] and r["check"]["finite"]["value"] == 0


def test_the_same_seed_places_the_same_fields():
    a = harness.draw_lanes(2**31 + 12345, 35, 6)
    assert a == harness.draw_lanes(2**31 + 12345, 35, 6)
    fields, lanes = a
    assert sorted(f for f in fields if f != "checkerboard") == \
        ["q1", "q2", "q3", "q4"]
    assert all(fields.index(f"q{i}") in lanes for i in (1, 2, 3, 4))
    assert len(lanes) == 6 and sum(lane < 17 for lane in lanes) >= 2 \
        and sum(lane >= 17 for lane in lanes) >= 2
    placed = {tuple(harness.draw_lanes(2**31 + s, 35, 6)[0])
              for s in range(20)}
    assert len(placed) == 20
