"""The trace reduction and the per-layer readers on a made-up trace."""

import json

import pytest

from benchmark import harness
from benchmark.readers import (device_idle_pct, dss_face_roofline_pct,
                               euler_roofline_pct, glue_ms_per_subcycle)
from benchmark.rooflines import dss_face, euler
from benchmark.trace import Trace, port_kernels, short_name

CFG = dict(E=5400, qsize=35, nlev=72, dtype="f32", rsplit=3)


def _events():
    """Two kernels and a fill with a gap of 5 us before the fill, which
    aten::add launched from inside aten::foo; times in microseconds."""
    return [
        {"ph": "X", "cat": "cpu_op", "name": "aten::foo", "ts": 0, "dur": 100,
         "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 40, "dur": 20,
         "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 50, "dur": 2, "tid": 1, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "ts": 100, "dur": 4000,
         "name": "void tse::(anonymous namespace)::dss_face_kernel<float, "
                 "true, false, true, false, 4>(float const*)",
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "ts": 3000, "dur": 2000,
         "name": "void euler_kernel<float>(float const*)",
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memset", "ts": 5005, "dur": 995,
         "name": "Memset (Device)", "args": {"correlation": 3}},
    ]


def test_short_name_and_port_kernels():
    assert short_name("void tse::(anonymous namespace)::dss_face_kernel"
                      "<float, true>(float const*)") == "dss_face_kernel"
    assert short_name("void at::native::vectorized_elementwise_kernel<4, "
                      "at::native::AddFunctor<float>>(int)") == \
        "vectorized_elementwise_kernel"
    k = port_kernels()
    assert k["dss_face_kernel"] == "dss_face"
    assert k["euler_kernel"] == "euler"
    assert k["minmax_kernel"] == "minmax"
    assert k["nbr_minmax_kernel"] == "nbr_minmax"


def test_trace_sums_and_readers(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    tr = Trace.from_chrome(path, 2, CFG)
    assert tr.span_s == pytest.approx(5900e-6)
    assert tr.busy_s == pytest.approx(5895e-6)
    assert tr.gaps == [("aten::add", pytest.approx(5e-6))]
    assert device_idle_pct.read(tr) == pytest.approx(100 * 5 / 5900)
    assert glue_ms_per_subcycle.read(tr) == pytest.approx(0.995 / 2)
    k4 = dss_face.subcycle_bound_ms(5400, 35, 72, "f32")
    assert dss_face_roofline_pct.read(tr) == pytest.approx(
        100 * 2 * k4 / 4.0)
    k1 = euler.subcycle_bound_ms(5400, 35, 72, "f32")
    assert euler_roofline_pct.read(tr) == pytest.approx(100 * 2 * k1 / 2.0)
    b = tr.breakdown()
    assert [n for n, _ in b["device_ops"]] == [
        "dss_face_kernel", "euler_kernel", "Memset"]
    assert b["idle_gaps"] == [["aten::add", pytest.approx(5e-6)]]


def test_readers_return_none_without_their_kernel():
    ev = [e for e in _events() if "dss_face" not in e["name"]]
    tr = Trace.from_events(ev, 2, CFG)
    assert dss_face_roofline_pct.read(tr) is None
    assert euler_roofline_pct.read(tr) is not None


def test_every_per_layer_metric_has_a_reader():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    tr = Trace.from_events(_events(), 2, CFG)
    for met in spec["per_layer"]:
        mod = __import__(f"benchmark.readers.{met['name']}",
                         fromlist=["read"])
        assert mod.read(tr) is not None, met["name"]
