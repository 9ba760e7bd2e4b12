"""CUDA kernels == their plain PyTorch versions on the card.

Needs a CUDA device and nvcc; skips elsewhere.  Imports no JAX, so on the
GPU machine it runs without the JAX package's test configuration:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from transport_se_tpu_torch import counters
from transport_se_tpu_torch.config import Config
from transport_se_tpu_torch.model.core import (_tp, build_model, initial_qdp,
                                               make_subcycle_fn)
from transport_se_tpu_torch.model.wind_basis import build_wind_basis
from transport_se_tpu_torch.ops import euler, remap

pytestmark = pytest.mark.gpu

# kernel vs plain, relative to the field max: both sides do the same
# operations in the same order (measured bitwise equal on an H100)
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _model(dtype, dev, dss_mode="gather"):
    order = {"elem_order": "raster"} if dss_mode == "face" else {}
    cfg = Config(ne=4, nlev=16, qsize=3, tstep=1200.0, vcoord="dcmip16",
                 test_case="dcmip1-1", nu_q=6e16, dtype=dtype,
                 disable_diagnostics=True, dss_mode=dss_mode, **order,
                 **({"limiter_iter_cap": 4} if dtype == "f32" else {}))
    return build_model(cfg, dev)


def _named(counts, want):
    """The counts of the kernels named in want, each with its plain
    version's (which must be 0)."""
    return {k: counts[k] for n in want for k in (n, n + "_plain")}


def _close(got, want):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= TOL[want.dtype] * scale, (err, scale)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_kernels_match_plain(cuda, dtype):
    m = _model(dtype, cuda)
    cfg = m.cfg
    E, nq, nk = m.lon.shape[0], cfg.qsize, cfg.nlev
    Qt = _tp(initial_qdp(m), E, nq * nk)
    _, _, u, v, divdp, divp = build_wind_basis(m).eval(
        torch.full((), 1200.0, dtype=m.dtype, device=cuda))
    dp0 = m.dp0col[None, None, :].expand(E, 16, nk)
    mn, mx = m.tables.neighbor_minmax(*m.tables.minmax_prep(Qt, dp0, nq))
    Q = (Qt.reshape(E, 16, nq, nk) / dp0[:, :, None, :]).reshape(Qt.shape)
    lap = euler.laplace_wk_t(Q, m.met, m.deriv)
    _close(lap, euler.laplace_wk_t_plain(Q, m.met, m.deriv))
    bih = m.tables.dss_scale_t(lap, m.rspheremp.reshape(E, 16))
    for s in (0, 1, 2):
        dp = (m.dp0col[None, None, :] - s * 600.0 * divp).contiguous()
        args = (Qt, (u, v), dp, divdp, mn, mx, m.met, m.deriv, 600.0)
        kw = dict(bih=bih if s == 2 else None, nu_coef=-1.08e20,
                  dp0=m.dp0ref, max_iter=cfg.limiter_iter_cap or 15)
        for g, w in zip(euler.fused_advect_limit(*args, **kw),
                        euler.fused_advect_limit_plain(*args, **kw)):
            _close(g, w)
    dps = (m.dp0col[None, None, :] - 3600.0 * divp).contiguous()
    dpr = dps.flip(-1).contiguous()          # same column totals
    for alg in (0, 2):
        _close(remap.remap_q_ppm_t(Qt, dps, dpr, alg=alg),
               remap.remap_q_ppm_t_plain(Qt, dps, dpr, alg=alg))


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_subcycle_kernels_match_plain_and_count(cuda, dtype):
    m = _model(dtype, cuda)
    Qt = _tp(initial_qdp(m), m.lon.shape[0], m.cfg.qsize * m.cfg.nlev)
    counters.reset()
    got = make_subcycle_fn(m)(Qt, 0)[0]
    counts = counters.snapshot()
    want = make_subcycle_fn(m, plain=True)(Qt, 0)[0]
    launches = {"fused_advect_limit": 9, "laplace_wk_t": 3,
                "remap_q_ppm_t": 1}
    assert _named(counts, launches) == {
        **launches, **{k + "_plain": 0 for k in launches}}
    _close(got, want)


# DCMIP 1-1's wind basis DSSes its 6 terms once, when the subcycle function
# is made; a face subcycle then runs 4 face DSS per step
FACE_SUBCYCLE = {"fused_advect_limit": 9, "laplace_wk_t": 0,
                 "remap_q_ppm_t": 1, "dss_face": 4 * 3 + 6,
                 "minmax_prep": 1, "neighbor_minmax": 6}


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_face_kernels_match_plain(cuda, dtype):
    """K4 in each variant the main path takes, K5 and K6."""
    m = _model(dtype, cuda, "face")
    cfg, tb = m.cfg, m.tables
    E, nq, nk = m.lon.shape[0], cfg.qsize, cfg.nlev
    Qt = _tp(initial_qdp(m), E, nq * nk)
    avg = Qt.flip(0).contiguous()
    rsp = m.rspheremp.reshape(E, 16)
    _, _, _, _, _, divp = build_wind_basis(m).eval(
        torch.full((), 1200.0, dtype=m.dtype, device=cuda))
    dp = (m.dp0col[None, None, :] - 600.0 * divp).contiguous()
    variants = [dict(), dict(dp=dp), dict(dp=dp, lap=True), dict(avg=avg),
                dict(avg=avg, dp=dp)]
    for kw in variants:
        if "dp" in kw:
            args = (Qt, rsp, kw["dp"], nq)
            opt = dict(avg=kw.get("avg"), lap=kw.get("lap", False))
            got = tb.dss_scale_minmax_t(*args, **opt)
            want = tb.dss_scale_minmax_t(*args, **opt, plain=True)
        else:
            got = (tb.dss_scale_t(Qt, rsp, avg=kw.get("avg")),)
            want = (tb.dss_scale_t(Qt, rsp, avg=kw.get("avg"), plain=True),)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                _close(g, w)
    mn, mx = tb.minmax_prep(Qt, dp, nq)
    for g, w in zip((mn, mx), tb.minmax_prep(Qt, dp, nq, plain=True)):
        assert torch.equal(g, w)
    for g, w in zip(tb.neighbor_minmax(mn, mx),
                    tb.neighbor_minmax(mn, mx, plain=True)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_face_subcycle_kernels_match_plain_and_count(cuda, dtype):
    m = _model(dtype, cuda, "face")
    Qt = _tp(initial_qdp(m), m.lon.shape[0], m.cfg.qsize * m.cfg.nlev)
    counters.reset()
    got = make_subcycle_fn(m)(Qt, 0)[0]
    counts = counters.snapshot()
    assert _named(counts, FACE_SUBCYCLE) == {
        **FACE_SUBCYCLE, **{k + "_plain": 0 for k in FACE_SUBCYCLE}}
    counters.reset()
    want = make_subcycle_fn(m, plain=True)(Qt, 0)[0]
    counts = counters.snapshot()
    # plain=True reaches the plain version of every kernel
    assert _named(counts, FACE_SUBCYCLE) == {
        **{k: 0 for k in FACE_SUBCYCLE},
        **{k + "_plain": n for k, n in FACE_SUBCYCLE.items()}}
    _close(got, want)


def test_kernel_wrapper_rejects_bad_inputs(cuda):
    m = _model("f32", cuda)
    x = torch.zeros(m.lon.shape[0], 16, 48, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        euler.laplace_wk_t(x.transpose(0, 1).contiguous().transpose(0, 1),
                           m.met, m.deriv)
    with pytest.raises(ValueError, match="on cpu"):
        euler.laplace_wk_t(x, m.met.cpu(), m.deriv)
