"""The fused euler-stage kernel (K1) and the weak-Laplacian kernel (K2).

Port of `transport_se_tpu/ops/pallas_euler.py`: `fused_advect_limit`
(`_euler_kernel3`) and `laplace_wk_t` (`_laplace_kernel`), on T-layout
fields [E, 16, L] (point axis second, lane = tracer*nlev + level).

Per (element, lane) column, K1 computes

    Vstar   = (u, v) / dp                          (euler_step :845-852)
    Qtens   = Qdp - dt * divergence_sphere(Vstar Qdp)
            + nu_coef * dp0(k) * lap_wk(bih) / spheremp   (stage 2 only)
    limited = limiter 8 on Qtens / dp_star         (:976-1094)
    out     = spheremp * limited, with the relaxed bounds

and K2 computes the weak Laplacian with the folded metric
S = spheremp * Dinv Dinv^T.  The CUDA kernels are `csrc/euler.cu`; the
plain PyTorch versions below compute the same function in the same
operation order, so on the card the two agree to roundoff.

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel, anything else raises.
"""

from __future__ import annotations

import torch

from ..constants import RREARTH

from .. import _build, counters
from ..counters import bump

# relative limiter convergence tolerance |addmass| <= tol*|mass|: the
# reference's f64-grade criterion (prim_advection_mod.F90:1009)
TOL_LIMITER = 5e-14
# the reference's iteration count np*np-1 (cfg.limiter_iter_cap = 0)
MAX_ITER = 15
N2 = 16

# metric pack rows ([E, 10, 16], see metric_pack)
MET_ROWS = ("d00", "d01", "d10", "d11", "metdet", "rmetdet", "spheremp",
            "s00", "s01", "s11")


def metric_pack(Dinv, metdet, rmetdet, spheremp):
    """[E, 10, 16] per-point metric rows, in MET_ROWS order.

    s00/s01/s11 is the folded Laplacian metric S = spheremp*Dinv*Dinv^T
    (the JAX package's `_smet`), computed in the model dtype."""
    E = Dinv.shape[0]
    d00, d01 = Dinv[..., 0, 0], Dinv[..., 0, 1]
    d10, d11 = Dinv[..., 1, 0], Dinv[..., 1, 1]
    s00 = (d00 * d00 + d01 * d01) * spheremp
    s01 = (d00 * d10 + d01 * d11) * spheremp
    s11 = (d10 * d10 + d11 * d11) * spheremp
    rows = (d00, d01, d10, d11, metdet, rmetdet, spheremp, s00, s01, s11)
    return torch.stack([r.reshape(E, N2) for r in rows], dim=1).contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _sum16(x):
    """Pairwise tree sum over the last axis of 16 points, point p = i*4+j:
    [..., 16] -> [...].  The association of `_sum16` in the JAX kernels and
    of `sum16` in csrc/common.cuh."""
    x4 = x.reshape(x.shape[:-1] + (4, 4))
    s = (x4[..., 0, :] + x4[..., 1, :]) + (x4[..., 2, :] + x4[..., 3, :])
    return (s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3])


def limiter_iterate_plain(x, c, minp, maxp, max_iter=MAX_ITER,
                          count=False):
    """Limiter 8 on rows over the last axis of 16 points: the plain
    version of `limiter_iterate` in csrc/common.cuh, which K1 and K10 run.

    x [..., 16] the tracer, c [..., 16] its weights, minp/maxp [...] the
    bounds.  The bounds are first relaxed so that each row's mass fits
    between them; then up to max_iter clip-and-redistribute iterations.
    Returns (x', minp', maxp', valid): valid is False for a row whose
    weights sum to <= 0, whose x' the caller discards.  With count, also
    conv [...] (int64): as `limiter_iterate` returns it, the pass at which
    the row converged (1 to max_iter), or 0 for a row that ran max_iter
    passes unconverged (capped); a mask of the rows still running keeps
    each row's first converging pass."""
    one = c.new_full((), 1.0)
    sumc = _sum16(c)
    mass = _sum16(c * x)
    valid = sumc > 0
    safe = torch.where(valid, sumc, one)
    minp = torch.where(mass < minp * safe, mass / safe, minp)
    maxp = torch.where(mass > maxp * safe, mass / safe, maxp)
    tol = TOL_LIMITER * torch.abs(mass)
    lo, hi = minp[..., None], maxp[..., None]
    conv_at = torch.zeros(x.shape[:-1], dtype=torch.int64,
                          device=x.device) if count else None
    for it in range(max_iter):
        # clip-residual form: (x - clip(x))*c equals the JAX over/under
        # terms term by term (exactly one of those is non-zero); converged
        # rows are fixed points of the body, so running it on every row
        # until all have converged equals the kernels' per-row early exit
        xcl = torch.clamp(x, lo, hi)
        addmass = _sum16((x - xcl) * c)
        conv = torch.abs(addmass) <= tol
        free = torch.where((addmass > 0)[..., None], xcl < hi, xcl > lo)
        wsum = _sum16(torch.where(free, c, 0.0))
        add = torch.where(wsum > 0,
                          addmass / torch.where(wsum > 0, wsum, one), 0.0)
        add = torch.where(conv, 0.0, add)[..., None]
        x = torch.where(free, xcl + add, xcl)
        if count:
            conv_at = torch.where((conv_at == 0) & conv, it + 1, conv_at)
        if bool((conv | ~valid).all()):
            break
    if count:
        return x, minp, maxp, valid, conv_at
    return x, minp, maxp, valid


def limiter_counts(conv, valid, max_iter):
    """[passes, rows, capped] (int64, counters.WORK) over the valid rows,
    from limiter_iterate_plain's conv: a row converged at pass k ran k
    passes, a capped row max_iter."""
    passes = torch.where(conv > 0, conv, max_iter)
    return torch.stack([(passes * valid).sum(), valid.sum(),
                        ((conv == 0) & valid).sum()])


_ROT = [[(l + d) % 4 for l in range(4)] for d in range(4)]


def _rot_coef(D, d, transpose):
    """coef[l] = D[l, (l+d)%4] (or D[(l+d)%4, l] transposed)."""
    idx = torch.tensor(_ROT[d], device=D.device)
    ar = torch.arange(4, device=D.device)
    return D[idx, ar] if transpose else D[ar, idx]


def _ddx_rot(x, D, transpose=False):
    """d/dx, out[(l, j)] = sum_i D[l, i] x[(i, j)] (or its transpose
    D[i, l]), summed in the JAX roll order: for row l the terms run over
    i = l, l+1, l+2, l+3 (mod 4).  Every derivative of K1/K2 uses it."""
    x4 = x.reshape(x.shape[0], 4, 4, x.shape[-1])
    acc = None
    for d in range(4):
        t = (_rot_coef(D, d, transpose).reshape(1, 4, 1, 1)
             * x4[:, _ROT[d]])
        acc = t if acc is None else acc + t
    return acc.reshape(x.shape)


def _ddy_rot(x, D, transpose=False):
    """d/dy, out[(i, l)] = sum_j D[l, j] x[(i, j)] (or its transpose),
    summed in the JAX roll order."""
    x4 = x.reshape(x.shape[0], 4, 4, x.shape[-1])
    acc = None
    for d in range(4):
        t = (_rot_coef(D, d, transpose).reshape(1, 1, 4, 1)
             * x4[:, :, _ROT[d]])
        acc = t if acc is None else acc + t
    return acc.reshape(x.shape)


def _lap_wk(q, s00, s01, s11, D):
    """Weak Laplacian of q [E, 16, L] with the folded metric s [E, 16, 1]
    (the JAX `_lap_wk`, roll form): grad, metric, then the transposed
    derivatives."""
    v1 = _ddx_rot(q, D)
    v2 = _ddy_rot(q, D)
    w1 = s00 * v1 + s01 * v2
    w2 = s01 * v1 + s11 * v2
    t2 = _ddx_rot(w1, D, True) + _ddy_rot(w2, D, True)
    return t2 * -(RREARTH * RREARTH)


def _met_rows(met, *names):
    return [met[:, MET_ROWS.index(n), :, None] for n in names]


def _rep(a, L):
    """[E, 16, nk] level field -> [E, 16, L] lanes (lane % nk)."""
    lane_k = torch.arange(L, device=a.device) % a.shape[-1]
    return a.index_select(-1, lane_k)


def fused_advect_limit_plain(Qt, uv, dp, divdp, qmin, qmax, met, deriv,
                             dt, bih=None, nu_coef=0.0, dp0=None,
                             max_iter=MAX_ITER):
    """Plain PyTorch version of the fused stage; see fused_advect_limit."""
    bump("fused_advect_limit_plain")
    u, v = uv
    L = Qt.shape[-1]
    d00, d01, d10, d11, metdet, rmetdet, sp = _met_rows(
        met, "d00", "d01", "d10", "d11", "metdet", "rmetdet", "spheremp")
    one = dp.new_full((), 1.0)

    rdp = one / dp
    us = _rep(u * rdp, L)
    vs = _rep(v * rdp, L)
    gu = us * Qt
    gv = vs * Qt
    c1 = (d00 * gu + d01 * gv) * metdet
    c2 = (d10 * gu + d11 * gv) * metdet
    div = ((_ddx_rot(c1, deriv) + _ddy_rot(c2, deriv)) * rmetdet) * RREARTH
    qtens = Qt - dt * div
    if bih is not None:
        s00, s01, s11 = _met_rows(met, "s00", "s01", "s11")
        lap2 = _lap_wk(bih, s00, s01, s11, deriv)
        nd = (nu_coef * _rep(dp0.expand(1, 1, -1), L))
        qtens = qtens + (nd * lap2) * (one / sp)

    # ---- limiter 8 on Q = qtens/dp_star (prim_advection_mod.F90:976) ----
    dps = dp - dt * divdp
    c = _rep(sp * dps, L)
    x = qtens * _rep(one / dps, L)
    # a column [E, 16, L] is a row of the limiter: points to the last axis
    count = counters.counting_on()
    x, qmin, qmax, valid, *conv = limiter_iterate_plain(
        x.movedim(1, -1), c.movedim(1, -1), qmin, qmax, max_iter,
        count=count)
    if count:
        counters.work_add(x.device, limiter_counts(conv[0], valid,
                                                   max_iter))
    out = torch.where(valid[:, None], x.movedim(-1, 1) * c, qtens * sp)
    return out, qmin, qmax


def laplace_wk_t_plain(s_t, met, deriv):
    """Plain PyTorch version of the weak Laplacian; see laplace_wk_t."""
    bump("laplace_wk_t_plain")
    s00, s01, s11 = _met_rows(met, "s00", "s01", "s11")
    return _lap_wk(s_t, s00, s01, s11, deriv)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def _check(name, t, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _device_kind(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {t.dtype}")
    return t.device.type


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def fused_advect_limit(Qt, uv, dp, divdp, qmin, qmax, met, deriv, dt,
                       bih=None, nu_coef=0.0, dp0=None, max_iter=MAX_ITER):
    """Fused advection RHS (+ stage-2 hyperviscosity) + limiter 8.

    Qt [E,16,L] tracer mass; uv = (u, v) mean-flux velocity*dp [E,16,nk]
    each; dp, divdp [E,16,nk] stage thickness and un-projected div(vn0);
    qmin/qmax [E,L] bounds; met [E,10,16] (metric_pack); deriv [4,4];
    dt the stage step.  bih [E,16,L]: the DSS'd first Laplacian, whose
    weak Laplacian adds nu_coef*dp0(k)*lap/spheremp (dp0 [nk]).  The lane
    of level k is any lane with lane % nk == k.  max_iter caps the
    clip-redistribute iterations; every exit keeps column mass.  Inside
    counters.counting() it launches K1's counting form, which adds the
    limiter's passes, columns and capped columns into counters.work_buffer
    (the plain version adds the same numbers).

    Returns (spheremp*limited [E,16,L], qmin' [E,L], qmax' [E,L]).
    """
    kind = _device_kind(Qt)
    E, _, L = Qt.shape
    nk = dp.shape[-1]
    dev, f = Qt.device, Qt.dtype
    u, v = uv
    for name, t, shape in (("Qt", Qt, (E, N2, L)), ("u", u, (E, N2, nk)),
                           ("v", v, (E, N2, nk)), ("dp", dp, (E, N2, nk)),
                           ("divdp", divdp, (E, N2, nk)),
                           ("qmin", qmin, (E, L)), ("qmax", qmax, (E, L)),
                           ("met", met, (E, 10, N2)),
                           ("deriv", deriv, (4, 4))):
        _check(name, t, shape, f, dev)
    if bih is not None:
        _check("bih", bih, (E, N2, L), f, dev)
        _check("dp0", dp0, (nk,), f, dev)
    if max_iter < 1:
        raise ValueError(f"max_iter must be >= 1, got {max_iter}")
    if kind == "cpu":
        return fused_advect_limit_plain(Qt, uv, dp, divdp, qmin, qmax, met,
                                        deriv, dt, bih=bih, nu_coef=nu_coef,
                                        dp0=dp0, max_iter=max_iter)
    out = torch.empty_like(Qt)
    qmin_o = torch.empty_like(qmin)
    qmax_o = torch.empty_like(qmax)
    fn = _build.entry("tse_fused_advect_limit", _DTYPES[f])
    has_bih = bih is not None
    work = counters.work_buffer(dev) if counters.counting_on() else None
    code = fn(Qt.data_ptr(), u.data_ptr(), v.data_ptr(), dp.data_ptr(),
              divdp.data_ptr(), met.data_ptr(), qmin.data_ptr(),
              qmax.data_ptr(), deriv.data_ptr(),
              dp0.data_ptr() if has_bih else None,
              bih.data_ptr() if has_bih else None,
              out.data_ptr(), qmin_o.data_ptr(), qmax_o.data_ptr(),
              E, L, nk, float(dt), float(nu_coef), 2 if has_bih else 0,
              int(max_iter), TOL_LIMITER, _stream(dev),
              None if work is None else work.data_ptr(), counters.WORK_SLOTS)
    _build.check(code, "fused_advect_limit")
    bump("fused_advect_limit")
    return out, qmin_o, qmax_o


def laplace_wk_t(s_t, met, deriv):
    """Weak Laplacian laplace_sphere_wk on T-layout fields s_t [E,16,B]
    with the folded metric rows of met [E,10,16]; deriv [4,4]."""
    kind = _device_kind(s_t)
    E, _, B = s_t.shape
    dev, f = s_t.device, s_t.dtype
    _check("s_t", s_t, (E, N2, B), f, dev)
    _check("met", met, (E, 10, N2), f, dev)
    _check("deriv", deriv, (4, 4), f, dev)
    if kind == "cpu":
        return laplace_wk_t_plain(s_t, met, deriv)
    out = torch.empty_like(s_t)
    fn = _build.entry("tse_laplace_wk_t", _DTYPES[f])
    code = fn(s_t.data_ptr(), met.data_ptr(), deriv.data_ptr(),
              out.data_ptr(), E, B, _stream(dev))
    _build.check(code, "laplace_wk_t")
    bump("laplace_wk_t")
    return out
