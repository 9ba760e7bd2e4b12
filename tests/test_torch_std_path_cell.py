"""The benchmark cell of the published NE30 DCMIP 1-2 real*8 run
(`ne30_dcmip12_f64.q4_dcmip12`) on the CPU at ne = 2: the harness runs it
through the port's std-layout path and the plain reference holds it; the
std subcycle's spans nest as the T subcycle's do and cover every operator
it runs; K10's roofline counts and its reader.

A CPU trace has no device operations, so the span walk of
`benchmark/spans.py` is fed the trace's host operators as if each were a
device operation launched where the operator starts."""

import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, spans
from benchmark.readers import limiter_roofline_pct
from benchmark.rooflines import limiter, peaks
from benchmark.trace import Trace

torch.set_num_threads(1)

CELL = "ne30_dcmip12_f64.q4_dcmip12"
SMALL = {"ne": 2}
SEED = 2**31 + 2023
E30 = 6 * 30 * 30

# span -> the span it nests in (None: the outermost), and how many a std
# subcycle of 3 tracer steps opens: the std remap's layout copies open a
# `remap.levels` before the T remap's own and a `remap.ppm` around the T
# remap's own
PARENT = {"subcycle": None, "tracer_step": "subcycle", "wind": "tracer_step",
          "stage": "tracer_step", "stage.bounds": "stage",
          "stage.hypervis": "stage", "stage.advect": "stage",
          "stage.limiter": "stage", "stage.dss": "stage",
          "remap": "subcycle", "remap.levels": "remap",
          "remap.health": "remap", "remap.ppm": "remap"}
PER_SUBCYCLE = {"subcycle": 1, "tracer_step": 3, "wind": 3, "stage": 9,
                "stage.bounds": 9, "stage.hypervis": 3, "stage.advect": 9,
                "stage.limiter": 9, "stage.dss": 9, "remap": 1,
                "remap.levels": 2, "remap.health": 1, "remap.ppm": 2}
# the spans that hold operators of their own: the leaves, and the tracer
# step's divergence of the winds and its time average outside every stage;
# besides, `remap` holds the T remap's view of ps_v (remap_levels_t returns
# ps_v.reshape(E, 4, 4) after its spans close), which launches no device
# work.  Views (VIEWS) are fed to spans.py as device operations of no
# duration: their device work, where a reshape copies, is their child
# operators'.
INNERMOST = {"tracer_step", "wind", "stage.bounds", "stage.hypervis",
             "stage.advect", "stage.limiter", "stage.dss", "remap.levels",
             "remap.health", "remap.ppm"}
VIEWS = {"aten::reshape", "aten::view"}


def run(fault=None):
    return harness.run_cell(CELL, SEED, 0, 0, time.perf_counter(),
                            device="cpu", fault=fault,
                            config_overrides=SMALL)


def test_the_cell_runs_the_std_path_and_is_correct():
    layouts = []

    def watch(step):
        def watched(box, nstep):
            layouts.append(tuple(box[0].shape))
            return step(box, nstep)
        return watched
    r = run(watch)
    assert r["correct"], r["check"]
    assert r["failed"] == 0
    # Qdp [E, q, k, 4, 4]: the std layout, 4 tracers, 72 levels
    assert layouts and all(s == (24, 4, 72, 4, 4) for s in layouts)


def test_the_cell_with_its_state_left_unchanged_is_not_correct():
    def unchanged(step):
        def same(box, nstep):
            Q = box[0]
            return Q, None, nstep + 3, Q.new_full((), 1.0)
        return same
    r = run(unchanged)
    assert not r["correct"]
    assert r["check"]["first_max"]["value"] > r["check"]["first_max"][
        "limit"]


@pytest.fixture(scope="module")
def std():
    """The cell's program at ne = 2 (the std subcycle and its state) and
    one subcycle of it under torch.profiler: (step, Q, profiled output,
    Chrome-trace events)."""
    cell = harness.load_cell(CELL, config_overrides=SMALL)
    fields, lanes = harness.draw_lanes(SEED, 4, harness.CHECK_LANES,
                                       "dcmip1-2")
    prog = harness.Program(cell, torch.device("cpu"), fields, lanes)
    assert not prog.t_layout
    Q = prog.box[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = prog.step(Q, 0)
    return prog.step, Q, out, prof.events()


def _annotations(events):
    return [(e.name, e.time_range.start, e.time_range.end, e.thread)
            for e in events if e.name in PARENT]


def _inside(ev, spans_):
    _, s, t, tid = ev
    return any(s0 <= s and t <= t0 and tid0 == tid
               for _, s0, t0, tid0 in spans_)


def test_std_spans_nest_and_count(std):
    _, _, _, events = std
    found = _annotations(events)
    got = {}
    for e in found:
        got[e[0]] = got.get(e[0], 0) + 1
    assert got == PER_SUBCYCLE
    for e in found:
        parent = PARENT[e[0]]
        if parent is not None:
            assert _inside(e, [p for p in found if p[0] == parent]), e


def test_every_operator_lies_in_a_span(std, tmp_path):
    """spans.py, fed the host operators as device operations, finds every
    span, no operator outside the program's spans, and operators of their
    own only in the leaves and the tracer step, and in `remap` views
    alone, of no device time."""
    step, Q, _, _ = std
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(Q, 0)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    raw = json.loads(path.read_text())["traceEvents"]
    events = [e for e in raw if e.get("cat") == "user_annotation"]
    ops = [e for e in raw if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    assert ops
    for i, e in enumerate(ops):
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "ts": e["ts"], "dur": 0,
                       "tid": e["tid"], "args": {"correlation": i}})
        events.append({"ph": "X", "cat": "kernel", "name": e["name"],
                       "ts": e["ts"],
                       "dur": 0 if e["name"] in VIEWS else e["dur"],
                       "args": {"correlation": i}})
    s = spans.summary(events)
    assert s["subcycles"] == 1
    assert set(s["device_ms_per_subcycle"]) == set(PARENT)
    assert set(s["innermost_ms_per_subcycle"]) - {"remap"} == INNERMOST
    assert s["innermost_ms_per_subcycle"].get("remap", 0.0) == 0.0
    assert s["outside_pct_of_busy"] == 0
    sp = spans.Spans(events)
    own = {e["name"] for e in ops
           if sp.threads[e["tid"]].stack(float(e["ts"]))[0] == "remap"}
    assert own <= VIEWS, own


def test_the_profiler_changes_no_bit(std):
    step, Q, on, _ = std
    off = step(Q, 0)
    for a, b in zip(off, on):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_k10_work_counted_only_inside_counting(std):
    """The std subcycle counts its row limiter's work (K10's plain version
    here) only inside counters.counting(): every (element, tracer, level)
    row of its 9 stages, 1 to 15 passes a row, and no bit changed."""
    from transport_se_tpu_torch import counters
    step, Q, _, _ = std
    counters.work_reset()
    off = step(Q, 0)
    assert set(counters.work_snapshot().values()) == {0}
    with counters.counting():
        on = step(Q, 0)
    for a, b in zip(off, on):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    w = counters.work_snapshot()
    counters.work_reset()
    rows = 9 * Q.shape[0] * Q.shape[1] * Q.shape[2]
    assert w["limiter_rows"] == rows
    assert rows < w["limiter_passes"] <= 15 * rows
    assert 0 <= w["limiter_capped"] <= rows


def test_k10_roofline_counts():
    """One launch at NE30 f64, 4 tracers, 72 levels: ptens in and out,
    spheremp, dp_star and the bounds in and out, 0.498 GB; chip_smoke
    phase 8's bound at that shape, 0.074 / 0.149 ms; 9 a subcycle."""
    rows = E30 * 4 * 72
    nbytes, nops = limiter.cost(E30, 4, 72, 8)
    assert nbytes == (2 * rows * 16 + E30 * 16 + E30 * 72 * 16
                      + 4 * rows) * 8 == 498_355_200
    assert nops == rows * peaks.OPS["limiter_iter"]
    for dtype, ms in (("f32", 0.0744), ("f64", 0.1488)):
        one = peaks.bound(*limiter.cost(E30, 4, 72, peaks.BYTES[dtype]),
                          dtype)
        assert one[1] == "bytes"
        assert one[0] == pytest.approx(ms, abs=5e-5)
        assert limiter.subcycle_bound_ms(E30, 4, 72, dtype) == \
            pytest.approx(9 * one[0])


def _trace(with_k10):
    """A made-up trace of 2 subcycles: K10 (3 ms) and an elementwise
    kernel, each launched from the host."""
    names = ["void at::native::elementwise_kernel<128, 2>(int)"]
    if with_k10:
        names.append("void (anonymous namespace)::limiter_kernel<double, "
                     "false>(double const*)")
    ev = []
    for i, n in enumerate(names):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunch",
                   "ts": 10 * i, "dur": 2, "tid": 1,
                   "args": {"correlation": i}})
        ev.append({"ph": "X", "cat": "kernel", "name": n,
                   "ts": 100 + 5000 * i, "dur": 3000,
                   "args": {"correlation": i}})
    return Trace.from_events(ev, 2, dict(E=E30, qsize=4, nlev=72,
                                         dtype="f64", rsplit=3))


def test_limiter_roofline_reader():
    assert limiter_roofline_pct.read(_trace(False)) is None
    bound = limiter.subcycle_bound_ms(E30, 4, 72, "f64")
    assert limiter_roofline_pct.read(_trace(True)) == pytest.approx(
        100 * 2 * bound / 3.0)
