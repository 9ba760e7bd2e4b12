"""The frozen roofline counts reproduce the bounds the repository's
records give (PERF.md, chip_smoke.py phase 3) at NE30, 35 tracers, f32."""

import pytest

from benchmark.rooflines import dss_face, euler, peaks

E30 = 6 * 30 * 30


def test_k4_subcycle_bound_ne30_f32():
    assert sum(dss_face.SUBCYCLE.values()) == 12
    assert dss_face.subcycle_bound_ms(E30, 35, 72, "f32") == \
        pytest.approx(8.13, abs=0.005)


def test_k1_mean_bound_ne30_f32():
    es = peaks.BYTES["f32"]
    ms = [peaks.bound(*euler.cost(E30, 35, 72, es, s), "f32")
          for s in (0, 1, 2)]
    assert all(kind == "bytes" for _, kind in ms)
    assert sum(t for t, _ in ms) / 3 == pytest.approx(0.702, abs=0.0005)
    assert euler.subcycle_bound_ms(E30, 35, 72, "f32") == \
        pytest.approx(9 * 0.7023, rel=1e-3)


@pytest.mark.parametrize("dtype,ratio", [("f32", 1.0), ("f64", 2.0)])
def test_bounds_scale_with_elements_and_bytes(dtype, ratio):
    """NE120 has 16 times NE30's elements: every bound is bytes-bound and
    scales by 16, f64 by the width of its values."""
    for mod in (dss_face, euler):
        b30 = mod.subcycle_bound_ms(E30, 35, 72, dtype)
        b120 = mod.subcycle_bound_ms(16 * E30, 35, 72, dtype)
        assert b120 == pytest.approx(16 * b30, rel=1e-3)
        assert b30 == pytest.approx(
            ratio * mod.subcycle_bound_ms(E30, 35, 72, "f32"), rel=2e-3)
