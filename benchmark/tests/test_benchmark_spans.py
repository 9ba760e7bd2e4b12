"""The command line's reduction of the program's spans, on a made-up
trace: device time by span, the host's enqueue and the host-bound gaps
split at the first subcycle's end."""

import json

import pytest

from benchmark import spans
from benchmark.readers import (device_idle_pct, dss_face_roofline_pct,
                               euler_roofline_pct, glue_ms_per_subcycle)
from benchmark.trace import Trace

CFG = dict(E=5400, qsize=35, nlev=72, dtype="f32", rsplit=3)
OLD = (device_idle_pct, dss_face_roofline_pct, euler_roofline_pct,
       glue_ms_per_subcycle)


def _x(cat, name, ts, dur, tid=None, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if tid is not None:
        e["tid"] = tid
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _ops():
    """Six device operations launched by thread 1 (times in us): a fill
    from `wind`; K1 from `stage.advect`, launched after the device went
    idle (a host-bound gap in the first subcycle); a reduction from
    `remap.health` and a memset from outside every span, both queued
    before their gaps; an operation from outside every span launched
    after the device went idle; one from the second subcycle, the same."""
    launches = [(1, 30), (2, 200), (3, 660), (4, 1200), (5, 3350),
                (6, 3720)]
    dev = [(1, "void at::native::vectorized_elementwise_kernel<4>(int)",
            100, 50),
           (2, "void euler_kernel<float, false, false>(float const*)",
            250, 1000),
           (3, "void at::native::reduce_kernel<512, 1>(int)", 1350, 200),
           (4, "Memset (Device)", 1650, 100),
           (5, "void at::native::elementwise_kernel<128, 2>(int)", 3600,
            100),
           (6, "void at::native::elementwise_kernel<128, 2>(int)", 3800,
            100)]
    out = [_x("cuda_runtime", "cudaLaunchKernel", ts, 5, tid=1, corr=c)
           for c, ts in launches]
    out += [_x("gpu_memset" if "Memset" in n else "kernel", n, ts, d,
               corr=c) for c, n, ts, d in dev]
    return out


def _spans():
    """Two subcycles' spans on thread 1 and their device-side ranges."""
    host = [("subcycle", 0, 1000), ("tracer_step", 10, 590),
            ("wind", 20, 80), ("stage", 100, 500),
            ("stage.advect", 160, 140), ("remap", 600, 390),
            ("remap.health", 650, 50), ("subcycle", 3400, 350),
            ("wind", 3410, 40)]
    out = [_x("user_annotation", n, ts, d, tid=1) for n, ts, d in host]
    out += [_x("gpu_user_annotation", "stage", 250, 1000, tid=7),
            _x("gpu_user_annotation", "remap", 1350, 200, tid=7)]
    return out


def test_spans_change_no_old_reading():
    """user_annotation and gpu_user_annotation events are no device
    operations: every old reading is that of the trace without them."""
    traced = Trace.from_events(_ops() + _spans(), 2, CFG)
    bare = Trace.from_events(_ops(), 2, CFG)
    for k in ("ops", "busy_s", "span_s", "gaps"):
        assert getattr(traced, k) == getattr(bare, k), k
    assert traced.breakdown() == bare.breakdown()
    for r in OLD:
        assert r.read(traced) == r.read(bare), r.__name__


def test_device_time_by_span():
    sp = spans.Spans(_ops() + _spans())
    assert sp.device_s("wind") == pytest.approx(50e-6)
    assert sp.device_s("stage") == pytest.approx(1000e-6)
    assert sp.device_s("stage.advect") == pytest.approx(1000e-6)
    assert sp.device_s("tracer_step") == pytest.approx(1050e-6)
    assert sp.device_s("remap.health") == pytest.approx(200e-6)
    assert sp.device_s("subcycle") == pytest.approx(1350e-6)
    assert sp.outside_s() == pytest.approx(200e-6)
    assert sp.durations("subcycle") == pytest.approx([1000e-6, 350e-6])
    assert sp.steady_from() == 1000
    assert sp.end == 3900
    assert sp.host_bound_gaps() == [
        (150, "stage", pytest.approx(100e-6)),
        (1750, spans.OUTSIDE, pytest.approx(1850e-6)),
        (3700, "subcycle", pytest.approx(100e-6))]


def test_summary_splits_ramp_and_steady():
    s = spans.summary(_ops() + _spans())
    assert s["subcycles"] == 2
    assert s["busy_ms"] == pytest.approx(1.55)
    assert s["span_ms"] == pytest.approx(3.8)
    assert s["idle_ms"] == pytest.approx(2.25)
    assert s["device_ms_per_subcycle"]["wind"] == pytest.approx(0.025)
    assert s["device_ms_per_subcycle"]["remap.health"] == pytest.approx(0.1)
    assert s["innermost_ms_per_subcycle"]["stage.advect"] == \
        pytest.approx(0.5)
    assert s["outside_pct_of_busy"] == pytest.approx(100 * 200 / 1550)
    assert s["host_ms_per_subcycle_under_profiler"] == pytest.approx(0.675)
    hb = s["host_bound"]
    assert hb["ms"] == pytest.approx(2.05)
    assert hb["ramp_ms"] == pytest.approx(0.1)
    assert hb["steady_ms"] == pytest.approx(1.95)
    assert hb["steady_span_ms"] == pytest.approx(2.9)
    assert hb["steady_pct"] == pytest.approx(100 * 1950 / 2900)
    assert list(hb["by_span"]) == [spans.OUTSIDE, "stage", "subcycle"]
    assert hb["by_span"]["stage"] == {
        "gaps": 1, "ms": pytest.approx(0.1), "steady_ms": 0.0}
    assert hb["by_span"]["subcycle"]["steady_ms"] == pytest.approx(0.1)


def test_summary_of_a_trace_without_spans():
    """The parent's program marks nothing: every gap is outside the
    program, and what needs a span reads None."""
    s = spans.summary(_ops())
    assert s["subcycles"] == 0
    assert s["device_ms_per_subcycle"] == {}
    assert s["outside_pct_of_busy"] == pytest.approx(100.0)
    assert s["host_ms_per_subcycle_under_profiler"] is None
    hb = s["host_bound"]
    assert hb["ms"] == pytest.approx(2.05)
    assert hb["ramp_ms"] is None and hb["steady_pct"] is None
    assert list(hb["by_span"]) == [spans.OUTSIDE]


def test_command_line(tmp_path, capsys):
    path = tmp_path / "trace.cell.json"
    path.write_text(json.dumps({"traceEvents": _ops() + _spans()}))
    assert spans.main([str(path)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out == json.loads(json.dumps(spans.summary(_ops() + _spans())))
