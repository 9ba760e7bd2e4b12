"""Whole runs of a cell on the CPU at a small size (ne = 2, 6 tracers, so
every lane is checked), with the program's subcycle broken underneath:
`correct` has to come out false for each fault a one-chip cell can have,
from the first subcycle on and from the window's first on, and true for
the sound program."""

import time

import pytest

from benchmark import harness

SMALL = dict(config_overrides={"ne": 2},
             traffic_overrides={"qsize": 6, "warmup_subcycles": 2})


def run(fault=None, seed=5, workload="ne120_perf.q35"):
    return harness.run_cell(workload, seed, 0.3, 0, time.perf_counter(),
                            device="cpu", fault=fault, **SMALL)


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


def unchanged(step, box, nstep):
    """The state comes back as it went in."""
    Qt = box[0]
    return Qt, None, nstep + 3, Qt.new_full((), 1.0)


def half_the_tracers(step, box, nstep):
    """The second half of the tracer lanes is left out: returned as it
    went in."""
    keep = box[0].clone()
    Qt, ps, n, md = step(box, nstep)
    L = Qt.shape[2]
    Qt[:, :, L // 2:] = keep[:, :, L // 2:]
    return Qt, ps, n, md


def half_the_elements(step, box, nstep):
    """The second half of the elements is left out."""
    keep = box[0].clone()
    Qt, ps, n, md = step(box, nstep)
    E = Qt.shape[0]
    Qt[E // 2:] = keep[E // 2:]
    return Qt, ps, n, md


def one_value(step, box, nstep):
    """One value of one tracer changed where the subcycle produces it, by
    1% of that tracer's largest value."""
    Qt, ps, n, md = step(box, nstep)
    lane = slice(72, 144)
    Qt[3, 5, 72 + 36] += 0.01 * Qt[:, :, lane].abs().max()
    return Qt, ps, n, md


def test_the_sound_program_is_correct():
    r = run()
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] >= 1


@pytest.mark.parametrize("calls", [0, 2], ids=["from_start", "window_only"])
@pytest.mark.parametrize("broken", [unchanged, half_the_tracers,
                                    half_the_elements, one_value],
                         ids=lambda f: f.__name__)
def test_a_broken_subcycle_is_not_correct(broken, calls):
    r = run(after(calls, broken))
    assert not r["correct"], r["check"]
    # the closing subcycle is judged whenever the fault is in it
    assert r["check"]["last_max"]["value"] > \
        r["check"]["last_max"]["limit"]


def test_a_non_finite_state_is_not_correct():
    def nan(step, box, nstep):
        Qt, ps, n, md = step(box, nstep)
        Qt[0, 0, 0] = float("nan")
        return Qt, ps, n, md
    r = run(after(2, nan))
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
