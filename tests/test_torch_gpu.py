"""CUDA kernels == their plain PyTorch versions on the card.

Needs a CUDA device and nvcc; skips elsewhere.  Imports no JAX, so on the
GPU machine it runs without the JAX package's test configuration:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from transport_se_tpu_torch import counters
from transport_se_tpu_torch.config import Config
from transport_se_tpu_torch.model import core
from transport_se_tpu_torch.model.core import (_tp, build_model, initial_qdp,
                                               make_subcycle_fn)
from transport_se_tpu_torch.model.wind_basis import build_wind_basis
from transport_se_tpu_torch.ops import euler, limiter, remap

pytestmark = pytest.mark.gpu

# kernel vs plain, relative to the field max: both sides do the same
# operations in the same order (measured bitwise equal on an H100)
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _model(dtype, dev, dss_mode="gather", use_pallas=True):
    """The T-layout perf pipeline (use_pallas) or, with use_pallas=False,
    the std-layout verification pipeline."""
    order = {"elem_order": "raster"} if dss_mode == "face" else {}
    cap = {"limiter_iter_cap": 4} if dtype == "f32" and use_pallas else {}
    cfg = Config(ne=4, nlev=16, qsize=3, tstep=1200.0, vcoord="dcmip16",
                 test_case="dcmip1-1", nu_q=6e16, dtype=dtype,
                 disable_diagnostics=True, dss_mode=dss_mode, **order,
                 use_pallas=use_pallas, **cap)
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
        assert torch.equal(remap.remap_q_ppm_t(Qt, dps, dpr, alg=alg),
                           remap.remap_q_ppm_t_plain(Qt, dps, dpr, alg=alg))


# K1's edge cases, each (nlev, qsize, options): one element (E = 1), alone
# and with more lanes than a block has threads (lane groups); fewer lanes
# than threads; level counts that do not divide 32 (a warp wraps from the
# last level to the first); a level whose weights sum to <= 0 (element 0
# with negative spheremp); the limiter's cap at 1 and 15; and a launch on
# a subset of the elements (the face+overlap path's boundary group), whose
# rows must equal the whole launch's
K1_CASES = {
    "e1": (16, 3, dict(sel=[5])),
    "e1_lane_groups": (8, 35, dict(sel=[5])),
    "one_tracer": (16, 1, {}),
    "nlev7": (7, 3, {}),
    "nlev72": (72, 2, {}),
    "sumc_le0": (16, 3, dict(neg=True)),
    "max_iter1": (16, 3, dict(max_iter=1)),
    "max_iter15": (16, 3, dict(max_iter=15)),
    "subset": (16, 3, dict(sel=[3, 7, 11, 20, 22])),
}


@pytest.mark.parametrize("case", list(K1_CASES))
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_k1_edge_shapes_bitwise(cuda, dtype, case):
    """K1 == fused_advect_limit_plain bitwise at each stage kind."""
    nlev, qsize, opt = K1_CASES[case]
    cfg = Config(ne=2, nlev=nlev, qsize=qsize, tstep=1200.0,
                 vcoord="acme72" if nlev == 72 else f"dcmip{nlev}",
                 test_case="dcmip1-1", nu_q=6e16, dtype=dtype,
                 disable_diagnostics=True, use_pallas=True)
    m = build_model(cfg, cuda)
    E, nq, nk = m.lon.shape[0], qsize, nlev
    Qt = _tp(initial_qdp(m), E, nq * nk)
    _, _, u, v, divdp, divp = build_wind_basis(m).eval(
        torch.full((), 1200.0, dtype=m.dtype, device=cuda))
    dp0 = m.dp0col[None, None, :].expand(E, 16, nk)
    mn, mx = m.tables.neighbor_minmax(*m.tables.minmax_prep(Qt, dp0, nq))
    Q = (Qt.reshape(E, 16, nq, nk) / dp0[:, :, None, :]).reshape(Qt.shape)
    bih = m.tables.dss_scale_t(euler.laplace_wk_t(Q, m.met, m.deriv),
                               m.rspheremp.reshape(E, 16))
    met = m.met.clone()
    if opt.get("neg"):
        met[0, euler.MET_ROWS.index("spheremp")] *= -1
    max_iter = opt.get("max_iter", 4 if dtype == "f32" else 15)
    idx = torch.as_tensor(opt.get("sel", range(E)), device=cuda)
    pick = lambda t: t.index_select(0, idx).contiguous()  # noqa: E731
    for s in (0, 1, 2):
        dp = (m.dp0col[None, None, :] - s * 600.0 * divp).contiguous()
        full = (Qt, (u, v), dp, divdp, mn, mx, met, m.deriv, 600.0)
        part = (pick(Qt), (pick(u), pick(v)), pick(dp), pick(divdp),
                pick(mn), pick(mx), pick(met), m.deriv, 600.0)
        kw = dict(bih=bih if s == 2 else None, nu_coef=-1.08e20,
                  dp0=m.dp0ref, max_iter=max_iter)
        counters.reset()
        whole = euler.fused_advect_limit(*full, **kw)
        got = euler.fused_advect_limit(
            *part, **dict(kw, bih=None if s < 2 else pick(bih)))
        assert counters.snapshot()["fused_advect_limit"] == 2
        want = euler.fused_advect_limit_plain(
            *part, **dict(kw, bih=None if s < 2 else pick(bih)))
        for g, w, a in zip(got, want, whole):
            assert torch.equal(g, w), (case, s, (g - w).abs().max().item())
            assert torch.equal(g, pick(a)), (case, s)
        if opt.get("neg"):
            # dp_star > 0, so element 0's weights spheremp*dp_star sum < 0
            assert bool(((dp - 600.0 * divdp)[0] > 0).all())


def _ppm_columns(E, nq, nk, corrupt=False, seed=0):
    """Qt [E,16,nq*nk], dp_star, dp_ref [E,16,nk] (f64, CPU): interface j
    of the target grid at source-cell coordinate j + amp*sin(pi*j/nk), with
    |amp| < min(2.9, nk/pi) (monotone, inside the cell-search window: at
    nk >= 16 every shift -2..+3).  corrupt: row (0, 3) gets a negative
    first target width, whose cell search asks for source cell -1 (the
    kernel clamps it to 0), and a much wider top source cell in row (0, 5)."""
    rng = np.random.default_rng(seed)
    dp1 = rng.uniform(0.5, 1.5, (E, 16, nk)) * 100.0
    pio = np.concatenate([np.zeros((E, 16, 1)), np.cumsum(dp1, -1)], -1)
    j = np.arange(nk + 1)
    amax = min(2.9, 0.95 * nk / np.pi)
    coord = j + rng.uniform(-amax, amax, (E, 16, 1)) * np.sin(np.pi * j / nk)
    pin = np.empty_like(pio)
    for idx in np.ndindex(E, 16):
        pin[idx] = np.interp(coord[idx], j, pio[idx])
    dp2 = np.diff(pin, axis=-1)
    q = rng.uniform(0.0, 1.0, (E, 16, nq, nk))
    q[..., 1:3] = 1.0                                   # a flat stretch
    q[:, :, 0] = (np.arange(nk) % 2)[None, None]        # two-level wiggle
    if corrupt:
        dp2[0, 3, 0] = -50.0
        dp2[0, 3, 1] += 1050.0
        dp1[0, 5, -1] += 1e4
    Qt = (q * dp1[:, :, None, :]).reshape(E, 16, nq * nk)
    return tuple(torch.from_numpy(a) for a in (Qt, dp1, dp2))


# K3's edge cases, each (E, qsize, nlev, case): one element; one tracer and
# 35; 4, 5, 7 and 72 levels; 44 levels (a main loop that its unroll does
# not divide); a field that is not 16-byte aligned; a row count that leaves
# the last block partial; displacements that select every shift -2..+3; a
# corrupt width whose source cell is clamped into the column; tracer mass
# outside the walk's inline-division range (tiny, huge, -0), whose columns
# the kernel walks again with IEEE divisions
K3_CASES = {
    "e1_nq35_nk72": (1, 35, 72, None),
    "nq1_nk72": (2, 1, 72, None),
    "nq3_nk44": (2, 3, 44, None),
    "unaligned_nk72": (1, 3, 72, "unaligned"),
    "nq35_nk4": (2, 35, 4, None),
    "nq4_nk5": (3, 4, 5, None),
    "nq35_nk7": (2, 35, 7, None),
    "partial_block": (4, 3, 16, "partial"),
    "every_shift": (3, 4, 16, "shifts"),
    "corrupt_width": (2, 3, 16, "corrupt"),
    "extreme_mass": (2, 3, 72, "extreme"),
}


@pytest.mark.parametrize("case", list(K3_CASES))
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_k3_edge_shapes_bitwise(cuda, dtype, case):
    """K3 == remap_q_ppm_t_plain bitwise (NaNs equal) at alg 0, 1 and 2."""
    E, nq, nk, kind = K3_CASES[case]
    f = {"f32": torch.float32, "f64": torch.float64}[dtype]
    Qt, dps, dpr = (a.to(cuda, f) for a in _ppm_columns(
        E, nq, nk, corrupt=kind == "corrupt"))
    if kind == "extreme":
        Qt[0, 0, 5:9] = 1e-30
        Qt[0, 0, 30] = 1e-35
        Qt[0, 1, 20] = 1e35
        Qt[1, 7, 40] = -0.0
        Qt[1, 2, 10] = 1e-200                    # f64 only (0 in f32)
    if kind == "unaligned":
        buf = torch.empty(Qt.numel() + 1, dtype=f, device=cuda)
        Qt = buf[1:].view_as(Qt).copy_(Qt)
        assert Qt.data_ptr() % 16
    if kind == "partial":
        rows = remap.kernel_config(nq, nk, f)["rows"]
        assert (E * 16) % rows, rows
    shift = remap._level_terms(dps, dpr)[-1]
    if kind == "shifts":
        assert set(shift.unique().tolist()) == {-2, -1, 0, 1, 2, 3}
    if kind == "corrupt":
        # pio_l = 0 > tgt at level 0: the search says -1, the clamp 0
        assert float(dpr[0, 3, 0]) < 0 and int(shift[0, 3, 0]) == 0
    for alg in (0, 1, 2):
        counters.reset()
        got = remap.remap_q_ppm_t(Qt, dps, dpr, alg=alg)
        assert counters.snapshot()["remap_q_ppm_t"] == 1
        want = remap.remap_q_ppm_t_plain(Qt, dps, dpr, alg=alg)
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        assert bool(same.all()), (case, alg, (got - want).abs().max().item())


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_subcycle_kernels_match_plain_and_count(cuda, dtype):
    m = _model(dtype, cuda)
    Qt = _tp(initial_qdp(m), m.lon.shape[0], m.cfg.qsize * m.cfg.nlev)
    counters.reset()
    got = make_subcycle_fn(m, io_layout="t")(Qt, 0)[0]
    counts = counters.snapshot()
    want = make_subcycle_fn(m, io_layout="t", plain=True)(Qt, 0)[0]
    launches = {"fused_advect_limit": 9, "laplace_wk_t": 3,
                "remap_q_ppm_t": 1, "limiter_optim": 0}
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
    got = make_subcycle_fn(m, io_layout="t")(Qt, 0)[0]
    counts = counters.snapshot()
    assert _named(counts, FACE_SUBCYCLE) == {
        **FACE_SUBCYCLE, **{k + "_plain": 0 for k in FACE_SUBCYCLE}}
    counters.reset()
    want = make_subcycle_fn(m, io_layout="t", plain=True)(Qt, 0)[0]
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


def _stage_rows(m):
    """The limiter rows of a real std-layout stage 0 (DCMIP 1-1 at t=0,
    neighbor bounds), so that rows clip and relax."""
    cfg = m.cfg
    Qdp = initial_qdp(m)
    dt2 = cfg.dt_tracer / 2.0
    vn0 = core.dcmip.winds(cfg.test_case, m.lon, m.lat, m.etam, 0.0) \
        * m.dp0col[None, :, None, None, None]
    divdp = core.so.divergence_sphere(vn0, m.deriv, m.Dinv, m.metdet,
                                      m.rmetdet)
    zero = Qdp.new_zeros(Qdp.shape[:3])
    Qtens, qmin, qmax, dp_star = core.euler_stage_tens(
        m, Qdp, zero, zero, divdp, divdp, vn0, dt2, 0)
    return (*core.limiter_args(m, Qtens, dp_star), qmin, qmax)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_k10_matches_plain(cuda, dtype):
    m = _model(dtype, cuda, use_pallas=False)
    ptens, sp, dps, qmin, qmax = _stage_rows(m)
    counters.reset()
    got = limiter.limiter_optim_stage(ptens, sp, dps, qmin, qmax)
    want = limiter.limiter_optim_stage(ptens, sp, dps, qmin, qmax,
                                       plain=True)
    assert counters.COUNTS["limiter_optim"] == 1
    for g, w in zip(got, want):
        _close(g, w)
    assert not torch.equal(got[0], ptens)          # rows were limited
    assert not torch.equal(got[1], qmin)           # and some relaxed
    # the JAX signature's [N, 16] operands give the same bits
    sph = sp[:, None, None].expand(ptens.shape).contiguous()
    dp = dps[:, None].expand(ptens.shape).contiguous()
    full = limiter.limiter_optim_iter_full(ptens, sph, qmin, qmax, dp)
    for g, w in zip(full, want):
        _close(g, w)
    # a degenerate row (weights summing to <= 0) passes ptens through
    sph2 = sph.clone()
    sph2[0, 0, 0] = -sph2[0, 0, 0]
    out = limiter.limiter_optim_iter_full(ptens, sph2, qmin, qmax, dp)[0]
    assert torch.equal(out[0, 0, 0], ptens[0, 0, 0])


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("dss_mode", ["gather", "segsum", "face"])
def test_std_subcycle_kernels_match_plain_and_count(cuda, dtype, dss_mode):
    """The std-layout step launches K10 on each of its 9 stages (and, in
    face mode, K4/K6), no plain version; plain=True the reverse."""
    m = _model(dtype, cuda, dss_mode, use_pallas=False)
    Q0 = initial_qdp(m)
    counters.reset()
    got = make_subcycle_fn(m)(Q0, 0)[0]
    counts = counters.snapshot()
    want_k = {"limiter_optim": 9, "fused_advect_limit": 0,
              "remap_q_ppm_t": 0}
    if dss_mode == "face":
        want_k.update(dss_face=15, neighbor_minmax=6)
    assert _named(counts, want_k) == {
        **want_k, **{k + "_plain": 0 for k in want_k}}
    counters.reset()
    want = make_subcycle_fn(m, plain=True)(Q0, 0)[0]
    assert counters.COUNTS["limiter_optim"] == 0
    assert counters.COUNTS["limiter_optim_plain"] == 9
    _close(got, want)
    if dss_mode == "segsum":
        assert torch.equal(make_subcycle_fn(m)(Q0, 0)[0], got)


def test_std_run_diagnostics_on_card(cuda):
    m = _model("f64", cuda, use_pallas=False)
    cfg = dataclasses.replace(m.cfg, nmax=6, statefreq=3,
                              disable_diagnostics=False)
    from transport_se_tpu_torch.model.driver import run_simulation
    res = run_simulation(cfg, cuda, model=dataclasses.replace(m, cfg=cfg),
                         verbose=False)
    assert res.log.steps == [0, 3, 6]
    assert res.log.max_relative_mass_drift() < 1e-12
    assert bool(torch.isfinite(res.q_final).all())


def _band_shards(m, S):
    """The banded face tables of every shard of m's raster grid."""
    from transport_se_tpu_torch.ops.dss_face import build_face_tables
    from transport_se_tpu_torch.parallel import face_sharded as fs
    from transport_se_tpu_torch.parallel.halo import build_shard_plan
    g, ne = m.grid, m.cfg.ne
    plan = build_shard_plan(g, S)
    ftd = build_face_tables(g.part_idx, g.part_mask, ne)
    stack = fs.build_sharded_face_tables(g, plan, ftd)
    roles = fs.band_roles(plan, ftd, ne)
    out = []
    for s in range(S):
        sl = slice(s * plan.eloc, (s + 1) * plan.eloc)
        t = fs.ShardedFaceTables.from_stack(stack, roles, s, plan.nhalo,
                                            m.device, met=m.met[sl],
                                            deriv=m.deriv)
        hg = torch.as_tensor(plan.halo_gid[s], device=m.device)
        out.append((sl, hg, t))
    return out


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("S", [4, 8])
def test_band_kernel_matches_plain(cuda, dtype, S):
    """K7 == dss_band_plain bitwise in its four variants on every shard
    (S=4: row-aligned chunks at ne=4; S=8: chunks cut rows)."""
    from transport_se_tpu_torch.ops import band
    m = _model(dtype, cuda, "face")
    E, nq, nk = m.lon.shape[0], m.cfg.qsize, m.cfg.nlev
    g = torch.Generator(device="cpu").manual_seed(S)
    x = torch.randn(E, 16, nq * nk, generator=g, dtype=m.dtype).to(cuda)
    dp = (1.0 + torch.rand(E, 16, nk, generator=g, dtype=m.dtype)).to(cuda)
    rsp = m.rspheremp.reshape(E, 16)
    for sl, hg, t in _band_shards(m, S):
        halo = torch.where((hg >= 0)[:, None, None],
                           x.index_select(0, hg.clamp(min=0)), 0.0)
        ext = torch.cat([x[sl], halo])
        for kw in ({}, dict(rsp=rsp[sl]), dict(rsp=rsp[sl], dp=dp[sl]),
                   dict(rsp=rsp[sl], dp=dp[sl], lap=True)):
            counters.reset()
            got = band.dss_band(x[sl], ext, t, nq=nq, **kw)
            assert counters.snapshot()["dss_band"] == 1
            want = band.dss_band_plain(x[sl], ext, t, nq=nq, **kw)
            halo_only = band.dss_band(x[sl], halo, t, nq=nq, **kw)
            if isinstance(got, torch.Tensor):
                got, want, halo_only = (got,), (want,), (halo_only,)
            for a, b, c in zip(got, want, halo_only):
                assert torch.equal(a, b) and torch.equal(c, b), kw


def _edge_band_fields(E, dtype, seed):
    """x [E, 16, 2*8] and dp [E, 16, 8] at the edges of K7's inline
    division, as tests/test_torch_band.py _edge_inputs makes them (that
    test holds the plain version to the JAX kernel on them): lanes of
    zeros, of -0, below and above the out range, scattered -0 and
    negative values; dp at both ends of its range and just outside it in
    some elements."""
    f = np.float32 if dtype == "f32" else np.float64
    big, lim = (100, 20) if dtype == "f32" else (400, 400)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, 16, 2, 8)).astype(f)
    x[:, :, 0, 3] = 0.0
    x[:, :, 1, 3] = -0.0
    x[:, :, 0, 4] = f(2.0 ** -(big + 20)) * rng.uniform(1, 2, (E, 16))
    x[:, :, 1, 4] = f(-2.0 ** (big + 1)) * rng.uniform(1, 1.5, (E, 16))
    x[::3, ::5, 0, 5] = -0.0
    x[::2, :, 1, 5] = -np.abs(x[::2, :, 1, 5])
    dp = rng.uniform(0.5, 2.0, (E, 16, 8)).astype(f)
    dp[:, :, 0] = f(2.0 ** lim)
    dp[:, :, 1] = f(2.0 ** -lim)
    dp[::5, 7, 2] = np.nextafter(f(2.0 ** lim), f(np.inf))
    dp[1::5, 9, 2] = np.nextafter(f(2.0 ** -lim), f(0))
    return x.reshape(E, 16, 16), dp


# K7's edge cases, each (ne, S, nq, nk, kind): one element and three as a
# shard of their own (kind: the elements; every other element is their
# halo); fewer lanes than a warp; lane counts that 4 (f32) or 2 (f64) do
# not divide, so a thread takes one lane; one level; one tracer; the NE30
# lanes (35 x 72, several passes and lane groups) at S = 1 and 8; fields
# that are not 16-byte aligned; and the inline division's edge operands
# (above) at S = 1, 2 and 8, so that some columns of a warp divide with
# IEEE divisions and others not, and some elements' dp leave the range
K7_CASES = {
    "e1": (2, 1, 3, 4, [5]),
    "few_elements": (2, 1, 3, 8, [0, 7, 13]),
    "S2_L12": (2, 2, 3, 4, None),
    "S1_L21": (2, 1, 3, 7, None),
    "S2_L30": (2, 2, 5, 6, None),
    "nk1": (2, 2, 5, 1, None),
    "nq1_nk72": (2, 2, 1, 72, None),
    "nq35_nk72_S1": (2, 1, 35, 72, None),
    "nq35_nk72_S8": (4, 8, 35, 72, None),
    "unaligned": (2, 2, 4, 8, "unaligned"),
    "edges_S1": (2, 1, 2, 8, "edges"),
    "edges_S2": (2, 2, 2, 8, "edges"),
    "edges_S8": (4, 8, 2, 8, "edges"),
}
K7_VARIANTS = ({}, dict(scale=True), dict(scale=True, minmax=True),
               dict(scale=True, minmax=True, lap=True))


def _k7_launches(case, dtype, dev):
    """[(x, halo, tables, kwargs, want)] of one K7 case on dev: every
    shard (or the sub-shard) in each of the four variants; want is the
    plain version's result (computed on dev)."""
    from transport_se_tpu_torch.grid.cubesphere import build_grid
    from transport_se_tpu_torch.ops import band
    from transport_se_tpu_torch.ops.dss_face import build_face_tables
    from transport_se_tpu_torch.parallel import face_sharded as fs
    from transport_se_tpu_torch.parallel.halo import build_shard_plan
    ne, S, nq, nk, kind = K7_CASES[case]
    f = {"f32": torch.float32, "f64": torch.float64}[dtype]
    g = build_grid(ne, order="raster")
    E = g.nelem
    plan = build_shard_plan(g, S)
    ftd = build_face_tables(g.part_idx, g.part_mask, ne)
    stack = fs.build_sharded_face_tables(g, plan, ftd)
    roles = fs.band_roles(plan, ftd, ne)
    if kind == "edges":
        xn, dpn = _edge_band_fields(E, dtype, seed=ne * 7 + S)
    else:
        rng = np.random.default_rng(ne * 7 + S + nq * nk)
        xn = rng.standard_normal((E, 16, nq * nk))
        dpn = rng.uniform(0.5, 2.0, (E, 16, nk))
    x = torch.from_numpy(xn).to(dev, f)
    dp = torch.from_numpy(dpn).to(dev, f)
    met = euler.metric_pack(**{k: torch.tensor(np.asarray(getattr(g, k)))
                               for k in ("Dinv", "metdet", "rmetdet",
                                         "spheremp")}).to(dev, f)
    rsp = torch.tensor(g.rspheremp.reshape(E, 16)).to(dev, f)
    deriv = torch.tensor(g.deriv).to(dev, f)
    if kind == "unaligned":
        buf = torch.empty(x.numel() + 1, dtype=f, device=dev)
        x = buf[1:].view_as(x).copy_(x)
        assert x.data_ptr() % 16
    out = []
    for r in range(S):
        sl = slice(r * plan.eloc, (r + 1) * plan.eloc)
        t = fs.ShardedFaceTables.from_stack(stack, roles, r, plan.nhalo, dev,
                                            met=met[sl], deriv=deriv)
        hg = torch.as_tensor(plan.halo_gid[r], device=dev)
        halo = torch.where((hg >= 0)[:, None, None],
                           x.index_select(0, hg.clamp(min=0)), 0.0)
        if kind == "unaligned":
            hb = torch.empty(halo.numel() + 1, dtype=f, device=dev)
            halo = hb[1:].view_as(halo).copy_(halo)
        for v in K7_VARIANTS:
            kw = dict(nq=nq, lap=v.get("lap", False))
            if v.get("scale"):
                kw["rsp"] = rsp[sl]
            if v.get("minmax"):
                kw["dp"] = dp[sl]
            xs = x[sl]
            if isinstance(kind, list):
                # the elements of kind as a shard of their own: their
                # partners among them local, the others from the halo x
                sel = torch.as_tensor(kind, device=dev)
                want = band.dss_band_plain(x, halo, t, **kw)
                want = want[sel] if "dp" not in kw else tuple(
                    w[sel] for w in want)
                slot = t.role.long()
                el = slot // 16
                loc = torch.full((E,), -1, dtype=torch.long, device=dev)
                loc[sel] = torch.arange(len(kind), device=dev)
                sub = torch.where(loc[el.clamp(min=0)] >= 0,
                                  loc[el.clamp(min=0)] * 16 + slot % 16,
                                  len(kind) * 16 + slot)
                sub = torch.where(slot >= 0, sub, -1)[sel]
                ts = dataclasses.replace(
                    t, eloc=len(kind), nhalo=E, role=sub.to(torch.int32),
                    met=t.met[sel])
                sk = {k: (a[sel] if isinstance(a, torch.Tensor) else a)
                      for k, a in kw.items()}
                out.append((x[sel], x, ts, sk, want))
            else:
                out.append((xs, halo, t, kw,
                            band.dss_band_plain(xs, halo, t, **kw)))
    return out


def _bits(a):
    return a.view(torch.int32 if a.element_size() == 4 else torch.int64)


@pytest.mark.parametrize("case", list(K7_CASES))
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_k7_edge_shapes_bitwise(cuda, dtype, case):
    """K7 == dss_band_plain bit for bit (-0 and +0 apart) in its four
    variants on every shard."""
    from transport_se_tpu_torch.ops import band
    for x, halo, t, kw, want in _k7_launches(case, dtype, cuda):
        counters.reset()
        got = band.dss_band(x, halo, t, **kw)
        assert counters.snapshot()["dss_band"] == 1
        if isinstance(want, torch.Tensor):
            got, want = (got,), (want,)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(_bits(a), _bits(b)), (
                case, sorted(kw), (a - b).abs().max().item())


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_sharded_face_subcycle_on_card(cuda, dtype):
    """The sharded face subcycle through K7 in 4 threads == in 1 thread,
    bitwise; K4 and K6 are not launched."""
    from transport_se_tpu_torch.parallel.comm import ThreadComm
    from transport_se_tpu_torch.parallel.sharded import make_sharded_subcycle
    m = _model(dtype, cuda, "face")
    outs = []
    for S, overlap in ((1, False), (4, False), (4, True)):
        runner = make_sharded_subcycle(m, ThreadComm(S, timeout=300),
                                       overlap=overlap)
        counters.reset()
        states = runner.step(runner.shard_qdp(initial_qdp(m)), 0)[0]
        c = counters.snapshot()
        assert c["dss_band"] == 4 * 3 * S and c["dss_face"] == 0
        assert c["neighbor_minmax"] == 0 and c["dss_band_plain"] == 0
        outs.append(runner.gather(states))
    assert torch.equal(outs[1], outs[0]) and torch.equal(outs[2], outs[0])
    single = make_subcycle_fn(m)(initial_qdp(m), 0)[0]
    _close(outs[0], single)


def _k10_edge_rows(E, q, k, dtype, seed):
    """limiter_optim_stage's arguments (ptens [E,q,k,16], spheremp [E,16],
    dp_star [E,k,16], qmin, qmax) from a numpy seed, with the edges of
    K10's inline division and iteration: rows of +0 and -0 tracer mass, of
    mass below and at the range's ends (2^-100 f32, 2^-400 f64), dp_star
    rows at and just beyond 2^-20 and 2^20 (f32), an element whose weights
    sum to <= 0, a row that converges at once and one that needs all 15
    passes (tests/test_torch_limiter.py holds the plain version to the JAX
    limiter on such rows)."""
    f = np.float32 if dtype == "f32" else np.float64
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (E, q, k, 16))
    dp = rng.uniform(0.5, 2.0, (E, k, 16))
    sp = rng.uniform(0.1, 1.0, (E, 16))
    qmin = np.quantile(x, 0.2, axis=-1)
    qmax = np.quantile(x, 0.8, axis=-1)
    qmin[::3] = 0.9                                   # infeasible: relaxed
    ptens = (x * dp[:, None]).astype(f)
    dp, sp = dp.astype(f), sp.astype(f)
    lo = 2.0 ** (-100 if dtype == "f32" else -400)
    hi = 2.0 ** (100 if dtype == "f32" else 400)
    rows = ptens.reshape(-1, 16)
    n = rows.shape[0]
    rows[0 % n] = 0.0
    rows[1 % n, ::3] = -0.0
    rows[2 % n] = -0.0
    rows[3 % n] = lo * rng.uniform(0.25, 0.99, 16)
    rows[4 % n, ::2] = lo
    rows[5 % n, 1::2] = hi * rng.uniform(0.5, 1.0, 8)
    if dtype == "f32":
        dr = dp.reshape(-1, 16)
        a, b = np.float32(2.0 ** -20), np.float32(2.0 ** 20)
        for i, w in enumerate((a, b, np.nextafter(a, np.float32(0)),
                               np.nextafter(b, np.float32(np.inf)))):
            dr[(6 + i) % dr.shape[0], :: 1 + i % 2] = w
    if E > 2:
        sp[1] = -sp[1]                                # weights sum < 0
        # element 2, tracer 0, level 0: a row of one pass, level k-1 of
        # 15 (tests/test_torch_limiter.py _long_row); the element's weights
        # are the long row's
        kk = np.arange(1, 16)
        c = np.concatenate([[1.0], 0.45 ** kk])
        sp[2] = c
        dp[2] = 1.0
        ptens[2, 0, 0] = rng.uniform(0.4, 0.6, 16)
        qmin[2, 0, 0], qmax[2, 0, 0] = 0.3, 0.7
        ptens[2, 0, k - 1] = np.concatenate(
            [[1.0 + 3e-2 * c[1:].sum()], 1.0 - (kk * 3e-2 - 3e-2 * 0.45
                                                / 0.55)])
        qmin[2, 0, k - 1], qmax[2, 0, k - 1] = 0.0, 1.0
    return ptens, sp, dp, qmin.astype(f), qmax.astype(f)


# K10's edge cases (E, q, k): dp_star rows a block takes (16 at q = 4, 64
# at q = 1) not dividing E*k; one tracer; one level; both; more tracers
# than a block's 64 rows (one dp_star row a block, several passes)
K10_CASES = {"E7_q4_k5": (7, 4, 5), "q1": (13, 1, 9), "k1": (11, 3, 1),
             "q1_k1": (67, 1, 1), "q70": (3, 70, 2), "ne30_levels": (5, 4, 72)}


@pytest.mark.parametrize("case", list(K10_CASES))
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_k10_edge_shapes_bitwise(cuda, dtype, case):
    """K10 == its plain version bit for bit (-0 and +0 apart), through the
    std stage's operands and through [N, 16] operands."""
    E, q, k = K10_CASES[case]
    f = {"f32": torch.float32, "f64": torch.float64}[dtype]
    ptens, sp, dp, mn, mx = (torch.from_numpy(a).to(cuda, f) for a in
                             _k10_edge_rows(E, q, k, dtype, E * q + k))
    want = limiter.limiter_optim_stage(ptens, sp, dp, mn, mx, plain=True)
    counters.reset()
    got = limiter.limiter_optim_stage(ptens, sp, dp, mn, mx)
    got += limiter.limiter_optim_iter_full(
        ptens, sp[:, None, None].expand(ptens.shape).contiguous(), mn, mx,
        dp[:, None].expand(ptens.shape).contiguous())
    assert counters.snapshot()["limiter_optim"] == 2
    for a, b in zip(got, want * 2):
        assert torch.equal(_bits(a), _bits(b)), (
            case, (a - b).abs().max().item())


def _k5_edge_fields(E, nq, nk, dtype, seed):
    """x [E,16,nq*nk], dp [E,16,nk] from a numpy seed, with the edges of
    K5's inline division (tests/test_torch_dss_face.py
    _division_edges): columns of +0, of -0 beside positive values, of
    +0/-0 ties for the min and the max, of tracer mass below and at the
    range's ends; in f32 dp at and just beyond 2^-20 and 2^20."""
    f = np.float32 if dtype == "f32" else np.float64
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 2.0, (E, 16, nq * nk)).astype(f)
    dp = rng.uniform(0.5, 2.0, (E, 16, nk)).astype(f)
    lo = 2.0 ** (-100 if dtype == "f32" else -400)
    hi = 2.0 ** (100 if dtype == "f32" else 400)
    cols = x.transpose(0, 2, 1).reshape(-1, 16)       # a view: columns
    n = cols.shape[0]
    cols[0 % n] = 0.0
    cols[1 % n, 3:9] = -0.0
    cols[2 % n] = -0.0
    cols[2 % n, 7] = 0.0                              # -0 first
    cols[3 % n, 3], cols[3 % n, 9] = 0.0, -0.0        # the min may tie
    cols[4 % n] = lo * rng.uniform(0.25, 0.99, 16)
    cols[5 % n, ::2] = lo
    cols[5 % n, 1::2] = hi
    if dtype == "f32":
        a, b = np.float32(2.0 ** -20), np.float32(2.0 ** 20)
        dp[-1, :4, 0] = a
        dp[-1, 4:8, 0] = b
        dp[-1, 8:12, 0] = np.nextafter(a, np.float32(0))
        dp[-1, 12:, 0] = np.nextafter(b, np.float32(np.inf))
    return x, dp


# K5's edge cases (E, nq, nk, shard): lane counts that 2 does not divide
# (one lane a thread) and that leave a pass partly idle; one level; the
# NE30 lanes (35 x 72); more levels than 48 KB of dp records (the large
# shared-memory launch); shard 3 of 8 of an NE4-sized field (a view into
# it); a field that is not 16-byte aligned
K5_CASES = {"L15": (5, 3, 5, None), "L28": (4, 7, 4, None),
            "nk1": (6, 3, 1, None), "ne30_lanes": (3, 35, 72, None),
            "nk900": (2, 2, 900, None), "shard": (96, 3, 16, 3),
            "unaligned": (4, 3, 8, "unaligned")}


@pytest.mark.parametrize("case", list(K5_CASES))
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_k5_edge_shapes_bitwise(cuda, dtype, case):
    """K5 == its plain version bit for bit (-0 and +0 apart)."""
    from transport_se_tpu_torch.ops import dss_face
    E, nq, nk, kind = K5_CASES[case]
    f = {"f32": torch.float32, "f64": torch.float64}[dtype]
    xn, dpn = _k5_edge_fields(E, nq, nk, dtype, E + nq * nk)
    x = torch.from_numpy(xn).to(cuda, f)
    dp = torch.from_numpy(dpn).to(cuda, f)
    if kind == "unaligned":
        buf = torch.empty(x.numel() + 1, dtype=f, device=cuda)
        x = buf[1:].view_as(x).copy_(x)
        assert x.data_ptr() % 16
    elif kind is not None:
        eloc = E // 8
        x, dp = (a[kind * eloc:(kind + 1) * eloc] for a in (x, dp))
    want = dss_face.minmax_prep_plain(x, dp, nq)
    counters.reset()
    got = dss_face.minmax_prep(x, dp, nq)
    assert counters.snapshot()["minmax_prep"] == 1
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b)), (
            case, (a - b).abs().max().item())


@functools.cache
def _face_tables(ne):
    """The face tables of the raster grid of ne on the card."""
    from transport_se_tpu_torch.grid.cubesphere import build_grid
    from transport_se_tpu_torch.ops.dss_face import FaceTables
    g = build_grid(ne, order="raster")
    return FaceTables.from_grid(g.part_idx, g.part_mask, ne,
                                torch.device("cuda", 0))


def _k6_edge_bounds(E, L, dtype, seed):
    """qmin, qmax [E, L] from a numpy seed: lanes of values >= 0 and of
    values <= 0, so that +0 and -0 tie for many minima and maxima, +0 and
    -0 scattered over the rest, a few +-inf, and the extremes of one lane
    at each cube-vertex element of face 0 (elements 0, ne-1, ne^2-ne,
    ne^2-1)."""
    f = np.float32 if dtype == "f32" else np.float64
    rng = np.random.default_rng(seed)
    out = []
    for sign in (1.0, -1.0):
        a = rng.standard_normal((E, L))
        a[:, 0::3] = sign * np.abs(a[:, 0::3])
        a[:, 1::3] = -sign * np.abs(a[:, 1::3])
        u = rng.random((E, L))
        a[u < 0.3] = 0.0
        a[(u >= 0.3) & (u < 0.6)] = -0.0
        a[(u >= 0.6) & (u < 0.61)] = np.inf
        a[(u >= 0.61) & (u < 0.62)] = -np.inf
        ne = int(round((E / 6) ** 0.5))
        for e in (0, ne - 1, ne * ne - ne, ne * ne - 1):
            a[e, -1] = -sign * 1e30
        out.append(a.astype(f))
    return out


# K6's edge cases (ne, L, kind): the ne = 2 sphere (every element on a
# seam) and NE30; one lane, lane counts that 16-byte vectors do not
# divide, the NE30 lanes (35 x 72) and one more; bounds that are not
# 16-byte aligned (one lane a thread)
K6_CASES = {f"ne{ne}_L{L}": (ne, L, None)
            for ne in (2, 30) for L in (1, 3, 72, 2520, 2521)}
K6_CASES.update(ne2_unaligned=(2, 72, "unaligned"),
                ne30_unaligned=(30, 2520, "unaligned"))


@pytest.mark.parametrize("case", list(K6_CASES))
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_k6_edge_shapes_bitwise(cuda, dtype, case):
    """K6 == its plain version bit for bit (-0 and +0 apart)."""
    from transport_se_tpu_torch.ops import dss_face
    ne, L, kind = K6_CASES[case]
    E = 6 * ne * ne
    f = {"f32": torch.float32, "f64": torch.float64}[dtype]
    ft = _face_tables(ne)
    mn, mx = (torch.from_numpy(a).to(cuda, f)
              for a in _k6_edge_bounds(E, L, dtype, ne * 10000 + L))
    if kind == "unaligned":
        bufs = [torch.empty(E * L + 1, dtype=f, device=cuda) for _ in "ab"]
        mn, mx = (b[1:].view(E, L).copy_(a) for a, b in zip((mn, mx), bufs))
        assert mn.data_ptr() % 16 and mx.data_ptr() % 16
    want = dss_face.neighbor_minmax_plain(mn, mx, ft)
    counters.reset()
    got = dss_face.neighbor_minmax(mn, mx, ft)
    assert counters.snapshot()["neighbor_minmax"] == 1
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b)), (
            case, (a - b).abs().max().item())
    if E * L > 100:
        for w in want:
            z = w[w == 0]
            assert torch.signbit(z).any() and (~torch.signbit(z)).any()
