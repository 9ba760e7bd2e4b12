"""Plain versions of the fused euler-stage kernel (K1) and the weak-Laplacian
kernel (K2) == the JAX package's Pallas kernels (interpret mode on CPU).

The JAX side is `fused_advect_limit(..., transposed=True, interpret=True)`
(its `_euler_kernel3`, and in f64 also its alternative forms
`_euler_kernel` and `_euler_kernel2`) and `laplace_wk_t`, fed the same
numpy inputs.  The
two sum the advection divergence in another order (the JAX kernel as a
block-diagonal matmul), and the JAX kernel sums sumc with jnp.sum where the
port uses the pairwise tree, so they agree to roundoff, and the limiter's
relaxed bounds to a few ulp.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transport_se_tpu.config import Config as JConfig
from transport_se_tpu.model import core as jcore
from transport_se_tpu.model import dcmip
from transport_se_tpu.ops import pallas_euler
from transport_se_tpu.ops import sphere_ops as jso
from transport_se_tpu.ops.pallas_euler import (fused_advect_limit,
                                               laplace_wk_t)
from transport_se_tpu_torch.convert import model_from_numpy
from transport_se_tpu_torch.ops import euler
from transport_se_tpu_torch.ops import sphere_ops as tso

from test_torch_host import port_config

torch.set_num_threads(1)

ARRAYS = ("lon", "lat", "deriv", "D", "Dinv", "metdet", "rmetdet",
          "spheremp", "rspheremp", "etam", "etai", "hyai", "hybi",
          "dp0col", "dp0ref")
DT = 600.0
NU_Q = 6e16


def _cfg(dtype, nlev=8, qsize=3):
    return JConfig(ne=2, nlev=nlev, qsize=qsize, tstep=1200.0,
                   vcoord=f"dcmip{nlev}", test_case="dcmip1-1", dtype=dtype,
                   nu_q=NU_Q,
                   **({"limiter_iter_cap": 4} if dtype == "f32" else {}))


@functools.cache
def _setup(dtype, nlev=8, qsize=3):
    """One tracer step's stage inputs, all as numpy in the model dtype."""
    jcfg = _cfg(dtype, nlev, qsize)
    cfg = port_config(jcfg)
    jm = jcore.build_model(jcfg)
    arrays = {k: np.asarray(getattr(jm, k)) for k in ARRAYS}
    arrays.update(part_idx=np.asarray(jm.tables.part_idx),
                  part_mask=np.asarray(jm.tables.part_mask),
                  nbr=np.asarray(jm.tables.nbr))
    tm = model_from_numpy(cfg, arrays, "cpu")
    E, nq, nk = 24, cfg.qsize, cfg.nlev
    Qdp = jcore.initial_qdp(jm)
    v = dcmip.winds(cfg.test_case, jm.lon, jm.lat, jm.etam, 0.0)
    vn0 = v * jm.dp0col[None, :, None, None, None]
    divdp = jso.divergence_sphere(vn0, jm.deriv, jm.Dinv, jm.metdet,
                                  jm.rmetdet)
    dp0 = jnp.broadcast_to(jm.dp0col[None, :, None, None], divdp.shape)
    Q = Qdp / dp0[:, None]
    qmin, qmax = jm.tables.neighbor_minmax(Q.min(axis=(-2, -1)),
                                           Q.max(axis=(-2, -1)))
    tp = lambda a, inner: np.asarray(jcore._tp(a, E, inner))  # noqa: E731
    ins = dict(Qt=tp(Qdp, nq * nk), u=tp(vn0[:, :, 0], nk),
               v=tp(vn0[:, :, 1], nk), divdp=tp(divdp, nk),
               dp0=tp(dp0, nk), qmin=np.asarray(qmin).reshape(E, nq * nk),
               qmax=np.asarray(qmax).reshape(E, nq * nk))
    return cfg, jm, tm, ins


@pytest.fixture(scope="module", params=["f64", "f32"])
def setup(request):
    return _setup(request.param)


def _jax_arrays(jm):
    return dict(Dinv=jm.Dinv, metdet=jm.metdet, rmetdet=jm.rmetdet,
                spheremp=jm.spheremp, deriv=jm.grid.deriv)


def _stage(cfg, jm, tm, ins, s):
    """Inputs of stage s: dp = dp0 - s*dt*divdp; stage 2 carries the DSS'd
    first Laplacian of Q (computed by the JAX kernel, fed to both)."""
    E, nq, nk = 24, cfg.qsize, cfg.nlev
    dp = ins["dp0"] - s * DT * ins["divdp"]
    bih = None
    nu = 0.0
    if s == 2:
        Q = (ins["Qt"].reshape(E, 16, nq, nk)
             / dp[:, :, None, :]).reshape(E, 16, nq * nk)
        lap = laplace_wk_t(jnp.asarray(Q), _jax_arrays(jm), interpret=True)
        bih = np.asarray(jm.tables.dss_scale_t(
            lap, jm.rspheremp.reshape(E, 16)))
        nu = -3 * DT * cfg.nu_q
    return dp, bih, nu


def _jax_stage(dtype, s, shape=()):
    """The JAX fused_advect_limit's outputs of stage s, as numpy, through
    the kernel form pallas_euler.KERNEL_VERSION selects; shape: (nlev,
    qsize) other than _setup's default."""
    cfg, jm, tm, ins = _setup(dtype, *shape)
    dp, bih, nu = _stage(cfg, jm, tm, ins, s)
    j = fused_advect_limit(
        jnp.asarray(ins["Qt"]), (jnp.asarray(ins["u"]), jnp.asarray(ins["v"])),
        jnp.asarray(dp), jnp.asarray(ins["divdp"]), jnp.asarray(ins["qmin"]),
        jnp.asarray(ins["qmax"]), _jax_arrays(jm), DT,
        rhs_viss=3 if s == 2 else 0,
        bih=None if bih is None else jnp.asarray(bih),
        bih_mode=2 if s == 2 else 0, nu_coef=nu, dp0=jm.dp0ref,
        transposed=True, nq=cfg.qsize, interpret=True,
        max_iter=cfg.limiter_iter_cap or 15)
    return [np.asarray(a) for a in j]


@functools.cache
def _run_both(dtype, s, shape=()):
    """(JAX outputs, port outputs) of stage s, as numpy."""
    cfg, jm, tm, ins = _setup(dtype, *shape)
    dp, bih, nu = _stage(cfg, jm, tm, ins, s)
    max_iter = cfg.limiter_iter_cap or 15
    j = _jax_stage(dtype, s, shape)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got = euler.fused_advect_limit(
        t(ins["Qt"]), (t(ins["u"]), t(ins["v"])), t(dp), t(ins["divdp"]),
        t(ins["qmin"]), t(ins["qmax"]), tm.met, tm.deriv, DT,
        bih=None if bih is None else t(bih), nu_coef=nu, dp0=tm.dp0ref,
        max_iter=max_iter)
    return j, [g.numpy() for g in got]


def _assert_stage_close(dtype, jax_out, port_out, joint_scale=False):
    """The bounds of test_fused_advect_limit_matches_jax.  joint_scale:
    both limiter bounds take the larger of their scales, for a tracer whose
    qmin is 0 wherever roundoff does not relax it."""
    (jout, jmin, jmax), (out, mn, mx) = jax_out, port_out
    if dtype == "f64":
        # the JAX package's own f64 parity bound (test_pallas_limiter.py:90)
        np.testing.assert_allclose(out, jout, rtol=1e-11, atol=1e-9)
    else:
        # f32, limiter capped at 4: roundoff of the reassociated divergence
        # (~1e-7 relative) can flip a clip in a capped column; measured
        # max difference 1e-6 of the field max at this size
        np.testing.assert_allclose(out, jout, rtol=0,
                                   atol=1e-5 * np.abs(jout).max())
    # relaxed bounds are mass/sumc, and mass carries the divergence's
    # reassociation as well as sumc's: measured within 4 ulp of the bound
    # scale (a bound at the edge of relaxation may relax on one side only,
    # which moves it by those same few ulp)
    eps = np.finfo(out.dtype).eps
    joint = max(np.abs(jmin).max(), np.abs(jmax).max())
    for got, want in ((mn, jmin), (mx, jmax)):
        scale = joint if joint_scale else np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=4 * eps,
                                   atol=4 * eps * scale)


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_fused_advect_limit_matches_jax(setup, stage):
    cfg = setup[0]
    _assert_stage_close(cfg.dtype, *_run_both(cfg.dtype, stage))


# (nlev, qsize): one tracer (fewer lanes than a warp), and an odd level
# count (a warp's lanes wrap from the last level to the first: the CUDA
# kernel reads level fields at lane % nlev)
SHAPES = {"q1": (8, 1), "nlev5": (5, 3), "q1_nlev5": (5, 1)}


@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_fused_advect_limit_matches_jax_shapes(dtype, shape, stage):
    """The bounds of test_fused_advect_limit_matches_jax at one tracer and
    at an odd level count.  The one tracer is DCMIP 1-1's first, whose
    lower bounds are 0 but where a column's mass, 0 up to roundoff, relaxes
    them (measured 4e-22 in f64, 3e-13 in f32, against an upper bound of
    0.99): their 4 ulp are of the upper bound's scale."""
    _assert_stage_close(dtype, *_run_both(dtype, stage, SHAPES[shape]),
                        joint_scale=True)


@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("version", [1, 2])
def test_fused_advect_limit_matches_jax_kernel_versions(version, stage,
                                                        monkeypatch):
    """The one CUDA stage kernel also stands for the JAX package's other
    forms of it, K8 `_euler_kernel` (version 1, rolls) and K9
    `_euler_kernel2` (version 2, broadcast/tree), which
    pallas_euler.KERNEL_VERSION selects; f64, the bounds of
    test_fused_advect_limit_matches_jax."""
    monkeypatch.setattr(pallas_euler, "KERNEL_VERSION", version)
    jout, jmin, jmax = _jax_stage("f64", stage)
    _, (out, mn, mx) = _run_both("f64", stage)
    np.testing.assert_allclose(out, jout, rtol=1e-11, atol=1e-9)
    eps = np.finfo(out.dtype).eps
    for got, want in ((mn, jmin), (mx, jmax)):
        np.testing.assert_allclose(got, want, rtol=4 * eps,
                                   atol=4 * eps * np.abs(want).max())


def test_fused_limiter_conserves_column_mass(setup):
    """sum over points of the output = sum of spheremp*qtens per column:
    every limiter exit redistributes the clip residual."""
    cfg, jm, tm, ins = setup
    _, (out, _, _) = _run_both(cfg.dtype, 1)
    # unlimited stage (limiter with bounds that never bind)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    dp = ins["dp0"] - DT * ins["divdp"]
    big = np.full_like(ins["qmin"], 1e30)
    free, _, _ = euler.fused_advect_limit(
        t(ins["Qt"]), (t(ins["u"]), t(ins["v"])), t(dp), t(ins["divdp"]),
        t(-big), t(big), tm.met, tm.deriv, DT)
    rtol = 1e-12 if cfg.dtype == "f64" else 2e-5
    np.testing.assert_allclose(out.sum(axis=1), free.numpy().sum(axis=1),
                               rtol=rtol, atol=rtol * np.abs(out).max())


def test_laplace_wk_t_matches_jax(setup):
    cfg, jm, tm, ins = setup
    s = ins["Qt"] / np.tile(ins["dp0"], (1, 1, cfg.qsize))
    want = np.asarray(laplace_wk_t(jnp.asarray(s), _jax_arrays(jm),
                                   interpret=True))
    got = euler.laplace_wk_t(torch.from_numpy(s), tm.met, tm.deriv).numpy()
    # same folded metric and roll order: equal up to the last bits
    rtol = 1e-13 if cfg.dtype == "f64" else 1e-5
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def test_laplace_wk_t_matches_unfolded_sphere_ops():
    """The folded S = spheremp*Dinv*Dinv^T form == laplace_sphere_wk (f64:
    two formulations, compared at roundoff)."""
    cfg, jm, tm, ins = _setup("f64")
    E, L = 24, cfg.qsize * cfg.nlev
    s = ins["Qt"] / np.tile(ins["dp0"], (1, 1, cfg.qsize))
    got = euler.laplace_wk_t(torch.from_numpy(s), tm.met, tm.deriv)
    s_std = torch.from_numpy(s).transpose(1, 2).reshape(E, L, 4, 4)
    want = tso.laplace_sphere_wk(s_std, tm.deriv, tm.Dinv, tm.spheremp)
    want = want.reshape(E, L, 16).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * float(want.abs().max()))


def test_wrapper_rejects_bad_inputs(setup):
    cfg, jm, tm, ins = setup
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    args = [t(ins["Qt"]), (t(ins["u"]), t(ins["v"])), t(ins["dp0"]),
            t(ins["divdp"]), t(ins["qmin"]), t(ins["qmax"]), tm.met,
            tm.deriv, DT]
    bad = list(args)
    bad[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        euler.fused_advect_limit(*bad)
    bad = list(args)
    bad[4] = args[4][:, :-1].contiguous()
    with pytest.raises(ValueError, match="shape"):
        euler.fused_advect_limit(*bad)
    bad = list(args)
    bad[0] = args[0].to(torch.float16)
    with pytest.raises(TypeError):
        euler.fused_advect_limit(*bad)
    with pytest.raises(ValueError, match="max_iter"):
        euler.fused_advect_limit(*args, max_iter=0)
    with pytest.raises(TypeError, match="dtype"):
        euler.laplace_wk_t(args[0], tm.met.to(torch.float16), tm.deriv)
