"""The port's spans and K1's limiter counters, on the CPU.

`timing.span` marks the subcycle's layers for torch.profiler and costs one
check when no profiler records; the limiter's work counters count only
inside `counters.counting()`, never because a profiler records.  A CPU
trace has no device operations: the walk that gives device time by span
(`benchmark/spans.py`) is tested on a made-up trace in
benchmark/tests/test_benchmark_spans.py."""

import contextlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from transport_se_tpu_torch import counters, timing
from transport_se_tpu_torch.config import Config
from transport_se_tpu_torch.model import core
from transport_se_tpu_torch.model.core import (_tp, build_model, initial_qdp,
                                               make_subcycle_fn)
from transport_se_tpu_torch.model.wind_basis import WindBasis
from transport_se_tpu_torch.ops import euler

torch.set_num_threads(1)

# span -> the span it nests in (None: the outermost), and how many a face
# subcycle of 3 tracer steps opens
PARENT = {"subcycle": None, "tracer_step": "subcycle", "wind": "tracer_step",
          "stage": "tracer_step", "stage.bounds": "stage",
          "stage.hypervis": "stage", "stage.advect": "stage",
          "stage.dss": "stage", "remap": "subcycle",
          "remap.levels": "remap", "remap.health": "remap",
          "remap.ppm": "remap"}
PER_SUBCYCLE = {"subcycle": 1, "tracer_step": 3, "wind": 3, "stage": 9,
                "stage.bounds": 9, "stage.hypervis": 3, "stage.advect": 9,
                "stage.dss": 9, "remap": 1, "remap.levels": 1,
                "remap.health": 1, "remap.ppm": 1}


@pytest.fixture(scope="module")
def face():
    """The face T subcycle at ne = 2 (3 tracers, rsplit 3) and its state."""
    cfg = Config(ne=2, nlev=16, qsize=3, tstep=1200.0, vcoord="dcmip16",
                 test_case="dcmip1-1", nu_q=6e16, dtype="f64",
                 disable_diagnostics=True, dss_mode="face",
                 elem_order="raster", use_pallas=True)
    m = build_model(cfg, "cpu")
    Qt = _tp(initial_qdp(m), m.lon.shape[0], cfg.qsize * cfg.nlev)
    return m, make_subcycle_fn(m, io_layout="t"), Qt


def _chrome(prof, tmp_path):
    """The profiler's Chrome-trace events: {category: [(name, start, end,
    thread)]}, microseconds."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X":
            out.setdefault(e.get("cat"), []).append(
                (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 e.get("tid")))
    return out


def _inside(ev, spans):
    _, s, t, tid = ev
    return any(s0 <= s and t <= t0 and tid0 == tid
               for _, s0, t0, tid0 in spans)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_span_is_a_null_context_without_a_profiler(face, monkeypatch):
    m, step, Qt = face
    calls = []

    def fake(name, *a, **k):
        calls.append(name)
        return contextlib.nullcontext()
    monkeypatch.setattr(torch.profiler, "record_function", fake)
    assert not timing.tracing()
    assert timing.span("x") is timing.span("y")
    step(Qt, 0)
    assert calls == []
    _profiled(lambda: step(Qt, 0))
    assert sorted(set(calls)) == sorted(PER_SUBCYCLE)
    assert len(calls) == sum(PER_SUBCYCLE.values())


def test_subcycle_spans_nest_and_count(face, tmp_path):
    m, step, Qt = face
    _, prof = _profiled(lambda: step(Qt, 0))
    spans = [e for e in _chrome(prof, tmp_path)["user_annotation"]
             if e[0] in PARENT]
    got = {}
    for e in spans:
        got[e[0]] = got.get(e[0], 0) + 1
    assert got == PER_SUBCYCLE
    for e in spans:
        parent = PARENT[e[0]]
        if parent is not None:
            assert _inside(e, [p for p in spans if p[0] == parent]), e


def test_profiler_changes_no_bit(face):
    m, step, Qt = face
    off = step(Qt, 0)
    on, _ = _profiled(lambda: step(Qt, 0))
    for a, b in zip(off, on):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


def test_every_host_op_lies_in_its_span(face, tmp_path, monkeypatch):
    """Every operator the subcycle call runs lies inside its `subcycle`
    span, those of the wind basis inside `wind` and those of the remap's
    window check inside `remap.health`."""
    m, step, Qt = face
    ev = WindBasis.eval
    health = core.remap_health_t

    def marked(name, fn):
        def run(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return run
    monkeypatch.setattr(WindBasis, "eval", marked("test.eval", ev))
    monkeypatch.setattr(core, "remap_health_t",
                        marked("test.margin", health))
    _, prof = _profiled(
        lambda: marked("test.call", step)(Qt, 0))
    tr = _chrome(prof, tmp_path)
    ann, ops = tr["user_annotation"], tr["cpu_op"]
    for mark, span in (("test.call", "subcycle"), ("test.eval", "wind"),
                       ("test.margin", "remap.health")):
        marks = [e for e in ann if e[0] == mark]
        spans = [e for e in ann if e[0] == span]
        assert marks and spans
        held = [e for e in ops if _inside(e, marks)]
        assert held, mark
        for e in held:
            assert _inside(e, spans), (mark, e)


def test_limiter_work_counted_only_inside_counting(face):
    """A profiler alone counts nothing (a traced K1 is the one the main
    path runs); a counting() scope counts, changes no bit and closes with
    the scope."""
    m, step, Qt = face
    counters.work_reset()
    off = step(Qt, 0)
    _profiled(lambda: step(Qt, 0))
    assert set(counters.work_snapshot().values()) == {0}
    assert not counters.counting_on()
    with counters.counting():
        assert counters.counting_on()
        on = step(Qt, 0)
    assert not counters.counting_on()
    for a, b in zip(off, on):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    w = counters.work_snapshot()
    # 9 stages over every (element, lane) column, all valid
    rows = 9 * Qt.shape[0] * Qt.shape[2]
    assert w["limiter_rows"] == rows
    assert rows <= w["limiter_passes"] <= rows * euler.MAX_ITER
    assert 0 <= w["limiter_capped"] <= rows
    counters.work_reset()
    assert set(counters.work_snapshot().values()) == {0}


def _rows():
    """Rows of 16 points with unit weights and bounds [0, 1]: one in bounds
    (converged at pass 1), one whose clip is spread once (pass 2), one
    whose spread overshoots once more (pass 3), and one whose weights sum
    to 0 (not a valid row)."""
    x = torch.zeros(4, 16, dtype=torch.float64)
    x[0] = 0.5
    x[1, 0] = 2.0
    x[2, 0], x[2, 1:15] = 2.5, 0.95
    c = torch.ones(4, 16, dtype=torch.float64)
    c[3] = 0.0
    lo = torch.zeros(4, dtype=torch.float64)
    return x, c, lo, lo + 1.0


@pytest.mark.parametrize("max_iter, conv, work", [
    (15, [1, 2, 3], [6, 3, 0]),
    (2, [1, 2, 0], [5, 3, 1]),
    (1, [1, 0, 0], [3, 3, 2]),
])
def test_limiter_iterate_plain_counts(max_iter, conv, work):
    x, c, lo, hi = _rows()
    out = euler.limiter_iterate_plain(x, c, lo, hi, max_iter, count=True)
    valid, got = out[3], out[4]
    assert valid.tolist() == [True, True, True, False]
    assert got[:3].tolist() == conv
    assert euler.limiter_counts(got, valid, max_iter).tolist() == work
    # counting changes no bit of the limiter's result
    for a, b in zip(out[:4], euler.limiter_iterate_plain(x, c, lo, hi,
                                                         max_iter)):
        assert torch.equal(a, b)


def test_timers_region_is_a_span(tmp_path):
    t = timing.Timers()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.time("prim_run"):
            torch.ones(4).sum()
    names = [e[0] for e in _chrome(prof, tmp_path)["user_annotation"]]
    assert names.count("prim_run") == 1
    assert t.get("prim_run").count == 1
