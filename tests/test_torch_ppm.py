"""Plain version of the T-layout PPM remap kernel (K3) and the port's
level-minor remap == the JAX package's, on columns whose interfaces move
far enough to select every shift of the bounded cell search."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transport_se_tpu.ops import ppm as jppm
from transport_se_tpu.ops.pallas_ppm import remap_q_ppm_pallas_t
from transport_se_tpu_torch.ops import ppm as tppm
from transport_se_tpu_torch.ops import remap

torch.set_num_threads(1)

E, NQ, NK = 3, 4, 16


@functools.cache
def columns(seed=0, nq=NQ, nk=NK):
    """Qt [E,16,nq*nk], dp_star, dp_ref [E,16,nk] (f64 numpy): interface j
    of the target grid sits at source-cell coordinate j + delta_j,
    delta_j = amp*sin(pi*j/nk) with |amp| < min(2.9, 0.95*nk/pi) (monotone
    since |d delta/dj| = |amp|*pi/nk < 1; equal column totals).  At nk >= 16
    that is every shift of the kernel's search window -2..+3 (a
    displacement d selects cell floor(d)+1 above), inside ppm_fast_margin's
    guard."""
    rng = np.random.default_rng(seed)
    dp1 = rng.uniform(0.5, 1.5, (E, 16, nk)) * 100.0
    pio = np.concatenate([np.zeros((E, 16, 1)), np.cumsum(dp1, -1)], -1)
    j = np.arange(nk + 1)
    amax = min(2.9, 0.95 * nk / np.pi)
    amp = rng.uniform(-amax, amax, (E, 16, 1))
    coord = j + amp * np.sin(np.pi * j / nk)           # fixed ends
    pin = np.empty_like(pio)
    for idx in np.ndindex(E, 16):
        pin[idx] = np.interp(coord[idx], j, pio[idx])
    dp2 = np.diff(pin, axis=-1)
    q = rng.uniform(0.0, 1.0, (E, 16, nq, nk))
    q[..., 5:9] = 1.0                                   # flat stretches
    q[:, :, 0] = (np.arange(nk) % 2)[None, None]        # two-level wiggle
    Qt = (q * dp1[:, :, None, :]).reshape(E, 16, nq * nk)
    return Qt, dp1, dp2


def _t(a):
    return torch.from_numpy(np.array(a))


def test_columns_cover_every_shift():
    Qt, dp1, dp2 = columns()
    shift = remap._level_terms(_t(dp1), _t(dp2))[-1]
    assert set(shift.unique().tolist()) == {-2, -1, 0, 1, 2, 3}
    assert float(tppm.ppm_fast_margin(_t(dp1), _t(dp2))) > 0


# the plain version against the JAX kernel: the same formulation, with the
# prefix sums associated differently (the JAX kernel's MXU prefix, the
# port's sequential scan).  f64 relative to the field max; f32 relative to
# the largest column mass, the scale of those prefix sums, whose roundoff
# out[k] = massn[k] - massn[k-1] carries (at 72 levels a few f32 ulps of
# the column mass are 2e-5 of the field max)
PALLAS_TOL = {"f64": 1e-12, "f32": 1e-5}


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("alg", [0, 2])
@pytest.mark.parametrize("nq", [4, 1])
@pytest.mark.parametrize("nk", [16, 4, 7, 72])
def test_remap_t_matches_jax_pallas_kernel(nk, nq, alg, dtype):
    Qt, dp1, dp2 = columns(nq=nq, nk=nk)
    if nk >= 16:
        shift = remap._level_terms(_t(dp1), _t(dp2))[-1]
        assert set(shift.unique().tolist()) == {-2, -1, 0, 1, 2, 3}
    f = np.float64 if dtype == "f64" else np.float32
    Qt, dp1, dp2 = (a.astype(f) for a in (Qt, dp1, dp2))
    want = np.asarray(remap_q_ppm_pallas_t(
        jnp.asarray(Qt), jnp.asarray(dp1), jnp.asarray(dp2), alg=alg,
        interpret=True))
    got = remap.remap_q_ppm_t(_t(Qt), _t(dp1), _t(dp2), alg=alg).numpy()
    assert got.dtype == want.dtype == f
    scale = np.abs(want).max() if dtype == "f64" else \
        np.abs(Qt).reshape(E, 16, nq, nk).sum(-1).max()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=PALLAS_TOL[dtype] * scale)


@pytest.mark.parametrize("alg", [0, 2])
def test_remap_t_matches_jax_fast_path(alg):
    """K3's plain version == the JAX level-minor fast path remap_q_ppm
    (mirror identities and z2 written another way: roundoff)."""
    Qt, dp1, dp2 = columns()
    want = np.asarray(jppm.remap_q_ppm(
        jnp.asarray(Qt.reshape(E, 16, NQ, NK)), jnp.asarray(dp1),
        jnp.asarray(dp2), alg=alg)).reshape(E, 16, NQ * NK)
    got = remap.remap_q_ppm_t(_t(Qt), _t(dp1), _t(dp2), alg=alg).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-11 * np.abs(want).max())


@pytest.mark.parametrize("alg", [0, 2])
def test_port_fast_path_matches_jax(alg):
    Qt, dp1, dp2 = columns()
    q = Qt.reshape(E, 16, NQ, NK)
    want = np.asarray(jppm.remap_q_ppm(jnp.asarray(q), jnp.asarray(dp1),
                                       jnp.asarray(dp2), alg=alg))
    got = tppm.remap_q_ppm(_t(q), _t(dp1), _t(dp2), alg=alg).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_fast_margin_matches_jax():
    _, dp1, dp2 = columns()
    want = float(jppm.ppm_fast_margin(jnp.asarray(dp1), jnp.asarray(dp2)))
    got = float(tppm.ppm_fast_margin(_t(dp1), _t(dp2)))
    assert got == pytest.approx(want, rel=1e-12)
    # a 3-cell displacement leaves the window: negative margin
    dp2_far = np.concatenate([dp1[..., 3:4] + dp1[..., :3].sum(-1,
                                                             keepdims=True),
                              dp1[..., 4:], dp1[..., :3]], -1)
    assert float(tppm.ppm_fast_margin(_t(dp1), _t(dp2_far))) < 0


@pytest.mark.parametrize("alg", [0, 1, 2])
def test_remap_t_conserves_column_mass(alg):
    Qt, dp1, dp2 = columns()
    got = remap.remap_q_ppm_t(_t(Qt), _t(dp1), _t(dp2), alg=alg).numpy()
    cols = lambda a: a.reshape(E, 16, NQ, NK).sum(-1)  # noqa: E731
    np.testing.assert_allclose(cols(got), cols(Qt), rtol=1e-13)
    if alg == 1:   # the same remap as alg 0 in this mini-app
        np.testing.assert_array_equal(
            got, remap.remap_q_ppm_t(_t(Qt), _t(dp1), _t(dp2)).numpy())


def test_remap_t_f32_matches_f64():
    Qt, dp1, dp2 = columns()
    want = remap.remap_q_ppm_t(_t(Qt), _t(dp1), _t(dp2)).numpy()
    f = lambda a: _t(a).to(torch.float32)  # noqa: E731
    got = remap.remap_q_ppm_t(f(Qt), f(dp1), f(dp2)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_wrapper_rejects_bad_inputs():
    Qt, dp1, dp2 = columns()
    with pytest.raises(ValueError, match="multiple"):
        remap.remap_q_ppm_t(_t(Qt[..., :-1]), _t(dp1), _t(dp2))
    with pytest.raises(ValueError, match="alg"):
        remap.remap_q_ppm_t(_t(Qt), _t(dp1), _t(dp2), alg=3)
    with pytest.raises(TypeError):
        remap.remap_q_ppm_t(_t(Qt), _t(dp1).float(), _t(dp2))


# The plain version's count of the columns K3 walks again with IEEE
# divisions (ops/remap.rewalked, csrc/common.cuh Bits): crafted columns of
# one element (16 rows) of 2 tracers over 8 levels, each case one value or
# one width set, with the columns it sends to the IEEE walk.  f32 ranges:
# mass 2^-100..2^100, widths 2^-20..2^20, dd*dd 2^-120..2^120; f64 2^-+400
# and 2^-+800.
def _crafted(dtype):
    rng = np.random.default_rng(7)
    d = rng.uniform(80.0, 120.0, (1, 16, 8))
    q = 0.5 + 0.1 * rng.uniform(-1.0, 1.0, (1, 16, 2, 8))
    Qt = (q * d[:, :, None, :]).reshape(1, 16, 16)
    dpr = d[..., ::-1].copy()
    return tuple(torch.from_numpy(a).to(dtype) for a in (Qt, d, dpr))


def _set_q(value):
    def edit(Qt, d, dpr):
        Qt[0, 3, 8 + 4] = value        # tracer 1 of row 3, level 4
    return edit


def _tiny_dd(Qt, d, dpr):
    # row 6, tracer 0: mixing ratios of about 2^-62 (f32) / 2^-401 (f64)
    # on a gentle ramp (no extremum, so the parabolas keep their width), so
    # that dd*dd falls below 2^-120 / 2^-800 while every mass stays inside
    # its range
    scale = 2.0 ** (-62 if Qt.dtype == torch.float32 else -401)
    ramp = 1.0 + 0.1 * torch.arange(8, dtype=torch.float64)
    Qt[0, 6, :8] = (scale * ramp * d[0, 6]).to(Qt.dtype)


def _wide(Qt, d, dpr):
    big = 3.0e6 if Qt.dtype == torch.float32 else 1e121   # > 2^20 / 2^400
    d[0, 9, 2] += big
    dpr[0, 9, 5] += big                 # equal column totals


_F32_LO = 2.0 ** -100
REWALK_CASES = {
    # name: (edit, dtypes, columns walked again)
    "none": (lambda *a: None, ("f32", "f64"), 0),
    "plus_zero": (_set_q(0.0), ("f32", "f64"), 0),
    "minus_zero": (_set_q(-0.0), ("f32", "f64"), 1),
    "subnormal": (_set_q(1e-40), ("f32",), 1),
    "subnormal_f64": (_set_q(1e-310), ("f64",), 1),
    "ulp_below_2^-100": (_set_q(float(np.nextafter(np.float32(_F32_LO),
                                                   np.float32(0)))),
                         ("f32",), 1),
    "at_2^-100": (_set_q(_F32_LO), ("f32",), 0),
    "ulp_above_2^-100": (_set_q(float(np.nextafter(np.float32(_F32_LO),
                                                   np.float32(1)))),
                         ("f32",), 0),
    "dd_squared_tiny": (_tiny_dd, ("f32", "f64"), 1),
    "width_out_of_range": (_wide, ("f32", "f64"), 2),
}


@pytest.mark.parametrize("case,dtype", [
    (case, dtype) for case, (_, dtypes, _) in REWALK_CASES.items()
    for dtype in dtypes])
def test_plain_rewalk_count(case, dtype):
    """remap_q_ppm_t_plain inside counters.counting() counts every column
    once and the crafted case's columns as walked again; outside the scope
    it counts nothing, and counting changes no bit."""
    from transport_se_tpu_torch import counters
    edit, _, want = REWALK_CASES[case]
    f = {"f32": torch.float32, "f64": torch.float64}[dtype]
    Qt, d, dpr = _crafted(f)
    edit(Qt, d, dpr)
    counters.work_reset()
    off = remap.remap_q_ppm_t_plain(Qt, d, dpr)
    assert set(counters.work_snapshot().values()) == {0}
    with counters.counting():
        on = remap.remap_q_ppm_t_plain(Qt, d, dpr)
    w = counters.work_snapshot()
    counters.work_reset()
    assert torch.equal(off.view(-1).view(torch.uint8),
                       on.view(-1).view(torch.uint8))
    assert w["remap_columns"] == 16 * 2
    assert w["remap_rewalked"] == want, (case, dtype, w)
