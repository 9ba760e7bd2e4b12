"""The plain reference of the production subcycle: tracer transport on the
cubed sphere, in plain PyTorch, std layout Qdp [E, q, k, 4, 4].

A frozen copy of the port's std-layout pipeline (the reference model's
`Prim_Advec_Tracers_remap_rk2`, `euler_step`, `qdp_time_avg` and
`vertical_remap`, prim_advection_mod.F90:579-1330) and of the DCMIP 1-1
and 1-2 fields (dcmip_123_mod.F90:85 and :279), written without the
port's kernels, tables or dispatch:

* three forward-Euler stages of dt/2 with rhs_multiplier 0, 1, 2, then
  (Qdp + 2 Qdp3) / 3; the limiter bounds of each stage from the element and
  its neighbours; the biharmonic hyperviscosity on stage 2;
* limiter 8 (prim_advection_mod.F90:976) on rows of 16 points, at most
  `limiter_iter_cap` clip-and-redistribute passes (0: the reference's
  np*np-1 = 15, :1009);
* the DSS as the sum over each global point's slots in ascending order;
  the neighbour bounds as the min/max over every element that shares a
  point with the element;
* the winds of the configuration's test case evaluated directly, with the
  reference's one-step lag;
* the PPM remap onto the hybrid levels every rsplit steps.

The test case (`test_case` of the configuration, "dcmip1-1" where it is
absent) chooses the horizontal winds and the named initial fields; a test
case not shipped here raises.  The subcycle needs nothing of a test case
beyond its horizontal winds: the levels are Lagrangian, so the vertical
motion is the divergence of the horizontal mass flux (dp_star) followed by
the remap, and the prescribed vertical velocity of 1-1 and 1-2 feeds only
the reference model's diagnostics.  Both tests set the surface pressure to
p0 (dcmip_123_mod.F90, test 1-1 and test 1-2 alike), so the stages start
from the same dp0col in both.

Each tracer advects on its own: dp and the winds are prescribed, and the
limiter, DSS, hyperviscosity and remap of a tracer touch only that tracer,
so the reference runs any subset of the tracers.  It imports nothing of the
program.  Derivatives are matrix products (`torch.einsum`), so the TF32
switch of the control reaches them.  Elements are in raster order
(`grid.py`); a program that keeps them in another order is mapped onto
this one by the harness.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from . import grid as gridmod

PI = gridmod.PI
REARTH = 6.376e6
RREARTH = 1.0 / REARTH
G = 9.80616
RGAS = 287.04
P0 = 100000.0
T0 = 300.0
SCALE_HEIGHT = RGAS * T0 / G

SECPDAY = 86400.0
# the reference's limiter passes, np*np-1 (prim_advection_mod.F90:1009): a
# limiter_iter_cap of 0 is this full iteration
LIMITER_PASSES = 15

# DCMIP 1-1 (dcmip_123_mod.F90:116-129)
TAU = 12.0 * SECPDAY
U0 = 2.0 * PI * REARTH / TAU
K0 = 10.0 * REARTH / TAU
OMEGA0 = 23000.0 * PI / TAU
RR, ZZ, Z0 = 0.5, 1000.0, 5000.0
LAMBDA0, LAMBDA1 = 5.0 * PI / 6.0, 7.0 * PI / 6.0
BS, ZTOP = 0.2, 12000.0

# DCMIP 1-2 (dcmip_123_mod.F90:309-319): a period of one day, zonal speed
# u0 (m/s), vertical speed w0 (m/s), K Hadley-like cells, the tracer layer
# between z1 and z2 (m) centred on z0, the model top ztop (m)
TAU_12 = 1.0 * SECPDAY
U0_12 = 40.0
W0_12 = 0.15
K_12 = 5.0
Z1_12, Z2_12 = 2000.0, 5000.0
Z0_12 = 0.5 * (Z1_12 + Z2_12)
ZTOP_12 = 12000.0

# The named initial fields of each test case in the reference model's
# tracer order, as its wrapper fills them (dcmip_wrapper_mod.F90:215-243):
# 1-1 q1-q4, 1-2 the checkerboard, then the Hadley layer; every further
# tracer holds the checkerboard.
LANE_FIELDS = {"dcmip1-1": ("q1", "q2", "q3", "q4"),
               "dcmip1-2": ("checkerboard", "hadley")}


def lane_fields(test_case, qsize):
    """The initial field of each of qsize tracers, in the reference
    model's order."""
    if test_case not in LANE_FIELDS:
        raise ValueError(f"the reference ships no test case {test_case!r}")
    names = list(LANE_FIELDS[test_case])
    return (names + ["checkerboard"] * qsize)[:qsize]

DATA = os.path.join(os.path.dirname(__file__), "data")
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _ascii_blocks(path):
    """The reference's coefficient files: blocks of 'count ! name' and
    count values."""
    tok = open(path).read().split()
    out, i = [], 0
    while i < len(tok):
        n = int(tok[i])
        i += 1
        while True:
            try:
                float(tok[i])
                break
            except ValueError:
                i += 1
        out.append(np.asarray([float(t) for t in tok[i:i + n]]))
        i += n
    return out


def acme72():
    """(hyai, hybi, hyam, hybm) of the ACME 72-level coordinate."""
    hyai, hybi = _ascii_blocks(os.path.join(DATA, "acme-72i.ascii"))
    hyam, hybm = _ascii_blocks(os.path.join(DATA, "acme-72m.ascii"))
    return hyai, hybi, hyam, hybm


@dataclasses.dataclass
class Model:
    cfg: dict
    lon: torch.Tensor        # [E, 4, 4]
    lat: torch.Tensor
    deriv: torch.Tensor      # [4, 4]
    Dinv: torch.Tensor       # [E, 4, 4, 2, 2]
    metdet: torch.Tensor
    rmetdet: torch.Tensor
    spheremp: torch.Tensor
    rspheremp: torch.Tensor
    etam: torch.Tensor       # [K]
    hyai: torch.Tensor       # [K+1]
    hybi: torch.Tensor
    dp0col: torch.Tensor     # [K] p0 * (etai[k+1] - etai[k])
    dp0ref: torch.Tensor     # [K] the hyperviscosity's dp0
    gid: torch.Tensor        # [E*16]
    members: torch.Tensor    # [ngid, 4], padded with E*16


def build_model(cfg: dict, device) -> Model:
    """The reference model of a configuration file's dict (ne, nlev,
    dtype, test_case) on device: grid and levels in float64, cast once."""
    if cfg["nlev"] != 72:
        raise ValueError("the reference ships the ACME 72-level coordinate")
    cfg = dict(cfg, test_case=cfg.get("test_case", "dcmip1-1"))
    lane_fields(cfg["test_case"], 0)        # raises for a case not shipped
    g = gridmod.build(cfg["ne"])
    hyai, hybi, hyam, hybm = acme72()
    etai = hyai + hybi
    f = DTYPES[cfg["dtype"]]

    def t(a):
        return torch.as_tensor(np.array(a, np.float64), dtype=f,
                               device=device)
    return Model(
        cfg=cfg, lon=t(g.lon), lat=t(g.lat), deriv=t(g.deriv),
        Dinv=t(g.Dinv), metdet=t(g.metdet), rmetdet=t(1.0 / g.metdet),
        spheremp=t(g.spheremp), rspheremp=t(g.rspheremp),
        etam=t(hyam + hybm), hyai=t(hyai), hybi=t(hybi),
        dp0col=t(P0 * (etai[1:] - etai[:-1])),
        dp0ref=t((hyai[1:] - hyai[:-1]) * P0 + (hybi[1:] - hybi[:-1]) * P0),
        gid=torch.as_tensor(g.gid, device=device),
        members=torch.as_tensor(g.members, device=device))


# ---------------------------------------------------------------------------
# DCMIP 1-1 and 1-2: initial tracers and winds
# ---------------------------------------------------------------------------

def _height(m: Model):
    """The levels' heights [1, K, 1, 1] (z = H log(p0/p))."""
    return SCALE_HEIGHT * torch.log(1.0 / m.etam[None, :, None, None])


def _checkerboard(m: Model, shape):
    term = torch.sin(9.0 * m.lon) * torch.sin(9.0 * m.lat)
    chk = torch.where(term < 0.0, m.lon.new_tensor(0.0),
                      m.lon.new_tensor(1.0))
    return torch.broadcast_to(chk[:, None], shape)


def initial_fields(m: Model):
    """The named initial mixing ratios of the model's test case, each
    [E, K, 4, 4] in the model dtype: 1-1 {"q1".."q4", "checkerboard"}, 1-2
    {"checkerboard", "hadley"} (`lane_fields` places them)."""
    if m.cfg["test_case"] == "dcmip1-2":
        return _fields_12(m)
    return _fields_11(m)


def winds(m: Model, time):
    """Horizontal winds (zonal, meridional) of the model's test case at
    time -> [E, K, 2, 4, 4]."""
    if m.cfg["test_case"] == "dcmip1-2":
        return _winds_12(m, time)
    return _winds_11(m, time)


def _fields_11(m: Model):
    """dcmip_123_mod.F90:214-250."""
    lon, lat = m.lon[:, None], m.lat[:, None]
    height = _height(m)
    sin_tmp = torch.sin(lat) * math.sin(0.0)
    cos_tmp = torch.cos(lat) * math.cos(0.0)
    r1 = torch.arccos(torch.clamp(
        sin_tmp + cos_tmp * torch.cos(lon - LAMBDA0), -1.0, 1.0))
    r2 = torch.arccos(torch.clamp(
        sin_tmp + cos_tmp * torch.cos(lon - LAMBDA1), -1.0, 1.0))
    zdev = ((height - Z0) / ZZ) ** 2
    d1 = torch.clamp((r1 / RR) ** 2 + zdev, max=1.0)
    d2 = torch.clamp((r2 / RR) ** 2 + zdev, max=1.0)
    q1 = 0.5 * (1.0 + torch.cos(PI * d1)) + 0.5 * (1.0 + torch.cos(PI * d2))
    q2 = 0.9 - 0.8 * q1 ** 2
    one, tenth = lat.new_tensor(1.0), lat.new_tensor(0.1)
    q3 = torch.where((d1 <= RR) | (d2 <= RR), one, tenth)
    q3 = torch.where((height > Z0) & (torch.abs(lat) < 0.125), tenth, q3)
    q3 = torch.broadcast_to(q3, q1.shape)
    q4 = 1.0 - 0.3 * (q1 + q2 + q3)
    return {"q1": q1, "q2": q2, "q3": q3, "q4": q4,
            "checkerboard": _checkerboard(m, q1.shape)}


def _winds_11(m: Model, time):
    """dcmip_123_mod.F90:161-184."""
    lon, lat, eta = m.lon[:, None], m.lat[:, None], m.etam[None, :, None, None]
    time = torch.as_tensor(time, dtype=lon.dtype, device=lon.device)
    p = P0 * eta
    ptop = P0 * torch.exp(lon.new_tensor(-ZTOP / SCALE_HEIGHT))
    plim = torch.maximum(p, ptop)
    lonp = lon - 2.0 * PI * time / TAU
    cos2t = torch.cos(2.0 * PI * time / TAU)
    cost = torch.cos(PI * time / TAU)
    bsp = BS * ptop
    ud = (OMEGA0 * REARTH / bsp) * torch.cos(lonp) * torch.cos(lat) ** 2 \
        * cos2t * (-torch.exp((plim - P0) / bsp)
                   + torch.exp((ptop - plim) / bsp))
    u = (K0 * torch.sin(lonp) ** 2 * torch.sin(2.0 * lat) * cost
         + U0 * torch.cos(lat) + ud)
    v = K0 * torch.sin(2.0 * lonp) * torch.cos(lat) * cost
    return torch.stack(torch.broadcast_tensors(u, v), dim=2)


def _fields_12(m: Model):
    """The Hadley layer, 0.5 (1 + cos(2 pi (z - z0) / (z2 - z1))) between
    z1 and z2 and 0 elsewhere, the same at every point of a level, and the
    checkerboard."""
    height = _height(m)
    shape = m.lon.shape[:1] + m.etam.shape + m.lon.shape[1:]
    layer = 0.5 * (1.0 + torch.cos(2.0 * PI * (height - Z0_12)
                                   / (Z2_12 - Z1_12)))
    q = torch.where((height > Z1_12) & (height < Z2_12), layer,
                    height.new_tensor(0.0))
    return {"checkerboard": _checkerboard(m, shape),
            "hadley": torch.broadcast_to(q, shape)}


def _winds_12(m: Model, time):
    """u = u0 cos(lat); v = -(rho0/rho) a w0 pi / (K ztop) cos(lat)
    sin(K lat) cos(pi z / ztop) cos(pi t / tau), with rho0/rho = p0/p at the
    temperature T0, and z and p held at the model top above it (p >= ptop,
    z <= ztop), as the 1-1 winds hold p."""
    lon, lat = m.lon[:, None], m.lat[:, None]
    time = torch.as_tensor(time, dtype=lon.dtype, device=lon.device)
    height = _height(m)
    p = P0 * m.etam[None, :, None, None]
    ptop = P0 * torch.exp(lon.new_tensor(-ZTOP_12 / SCALE_HEIGHT))
    rho0_rho = P0 / torch.maximum(p, ptop)
    ztop_frac = torch.clamp(height / ZTOP_12, max=1.0)
    u = U0_12 * torch.cos(lat)
    v = -rho0_rho * (REARTH * W0_12 * PI) / (K_12 * ZTOP_12) \
        * torch.cos(lat) * torch.sin(K_12 * lat) * torch.cos(PI * ztop_frac) \
        * torch.cos(PI * time / TAU_12)
    return torch.stack(torch.broadcast_tensors(u, v), dim=2)


# ---------------------------------------------------------------------------
# spectral-element operators (derivative_mod.F90)
# ---------------------------------------------------------------------------

def _ex(a, nd):
    """[E, ...] metric data broadcast against an nd-dim [E, B..., ...]."""
    extra = nd - a.dim()
    return a.reshape(a.shape[:1] + (1,) * extra + a.shape[1:]) \
        if extra > 0 else a


def _dinv(Dinv, nd):
    """[E, i, j, 2, 2] -> [E, 1.., 2, 2, i, j] against an nd-dim field."""
    return _ex(torch.movedim(Dinv, (-2, -1), (1, 2)), nd + 2)


def gradient_sphere(s, m: Model):
    v1 = torch.einsum('li,...ij->...lj', m.deriv, s) * RREARTH
    v2 = torch.einsum('...ij,lj->...il', s, m.deriv) * RREARTH
    Di = _dinv(m.Dinv, s.dim())
    return torch.stack([Di[..., 0, 0, :, :] * v1 + Di[..., 1, 0, :, :] * v2,
                        Di[..., 0, 1, :, :] * v1 + Di[..., 1, 1, :, :] * v2],
                       dim=-3)


def _contra(v, m: Model):
    Di = _dinv(m.Dinv, v.dim() - 1)
    u, w = v[..., 0, :, :], v[..., 1, :, :]
    return (Di[..., 0, 0, :, :] * u + Di[..., 0, 1, :, :] * w,
            Di[..., 1, 0, :, :] * u + Di[..., 1, 1, :, :] * w)


def divergence_sphere(v, m: Model):
    c1, c2 = _contra(v, m)
    md = _ex(m.metdet, c1.dim())
    div = torch.einsum('li,...ij->...lj', m.deriv, md * c1) \
        + torch.einsum('...ij,lj->...il', md * c2, m.deriv)
    return div * _ex(m.rmetdet, div.dim()) * RREARTH


def laplace_sphere_wk(s, m: Model):
    c1, c2 = _contra(gradient_sphere(s, m), m)
    sp = _ex(m.spheremp, c1.dim())
    t1 = torch.einsum('jm,...jn->...mn', m.deriv, sp * c1)
    t2 = torch.einsum('...mj,jn->...mn', sp * c2, m.deriv)
    return -(t1 + t2) * RREARTH


# ---------------------------------------------------------------------------
# assembly and bounds over shared points
# ---------------------------------------------------------------------------

def _points_major(x):
    """[E, B..., 4, 4] -> ([E*16, B] contiguous, B shape)."""
    E = x.shape[0]
    inner = x.shape[1:-2]
    return x.reshape(E, -1, 16).transpose(1, 2).reshape(E * 16, -1), inner


def dss_sum(x, m: Model):
    """Each point's value replaced by the sum over its slots."""
    xf, inner = _points_major(x)
    xz = torch.cat([xf, xf.new_zeros((1, xf.shape[1]))])
    s = xz[m.members[:, 0]]
    for k in range(1, 4):
        s = s + xz[m.members[:, k]]
    E = x.shape[0]
    out = s[m.gid].reshape(E, 16, -1).transpose(1, 2)
    return out.reshape(x.shape).contiguous()


def dss_scale(x, m: Model):
    """rspheremp * DSS(spheremp * x) of [E, B..., 4, 4]."""
    return dss_sum(x * _ex(m.spheremp, x.dim()), m) * _ex(m.rspheremp, x.dim())


def neighbor_minmax(qmin, qmax, m: Model):
    """Min/max of [E, B...] bounds over each element and every element
    that shares a point with it."""
    E = qmin.shape[0]
    elem = torch.div(m.members, 16, rounding_mode="floor")   # pad -> E
    out = []
    for q, fill, red in ((qmin, math.inf, torch.minimum),
                         (qmax, -math.inf, torch.maximum)):
        qf = q.reshape(E, -1)
        qz = torch.cat([qf, qf.new_full((1, qf.shape[1]), fill)])
        p = qz[elem[:, 0]]
        for k in range(1, 4):
            p = red(p, qz[elem[:, k]])
        per = p[m.gid].reshape(E, 16, -1)
        out.append((per.amin(1) if fill > 0 else per.amax(1))
                   .reshape(q.shape))
    return out[0], out[1]


# ---------------------------------------------------------------------------
# limiter 8 (prim_advection_mod.F90:976-1094)
# ---------------------------------------------------------------------------

TOL = 5e-14


def limiter(ptens, sphw, minp, maxp, dpmass, max_iter):
    """Limit Q = ptens/dpmass on rows [..., 16] with the weights
    sphw*dpmass -> (ptens', minp', maxp'): the bounds are relaxed so that
    each row's mass fits, then up to max_iter passes clip to the bounds
    and spread the clipped mass over the points that can take it (the last
    pass without a trailing clip).  A row whose weights sum to <= 0 stays
    as it was."""
    x = ptens / dpmass
    c = sphw * dpmass
    one = c.new_full((), 1.0)
    sumc = c.sum(-1)
    mass = (c * x).sum(-1)
    valid = sumc > 0
    safe = torch.where(valid, sumc, one)
    minp = torch.where(mass < minp * safe, mass / safe, minp)
    maxp = torch.where(mass > maxp * safe, mass / safe, maxp)
    tol = TOL * torch.abs(mass)
    lo, hi = minp[..., None], maxp[..., None]
    for _ in range(max_iter):
        xcl = torch.clamp(x, lo, hi)
        addmass = ((x - xcl) * c).sum(-1)
        free = torch.where((addmass > 0)[..., None], xcl < hi, xcl > lo)
        wsum = torch.where(free, c, 0.0).sum(-1)
        add = torch.where(wsum > 0,
                          addmass / torch.where(wsum > 0, wsum, one), 0.0)
        add = torch.where(torch.abs(addmass) <= tol, 0.0, add)[..., None]
        x = torch.where(free, xcl + add, xcl)
    return torch.where(valid[..., None], x * dpmass, ptens), minp, maxp


# ---------------------------------------------------------------------------
# the stages, the tracer step and the remap
# ---------------------------------------------------------------------------

def euler_step(m: Model, Qdp, qmin, qmax, divdp, divdp_proj, vn0, dt,
               stage: int, max_iter: int):
    """One stage -> (DSS[limited(Qdp - dt div(Vstar Qdp) + hypervis)],
    qmin', qmax')."""
    E, q, k = Qdp.shape[:3]
    dp = m.dp0col[None, :, None, None] - stage * dt * divdp_proj
    Q = Qdp / dp[:, None]
    qmin_l, qmax_l = Q.amin(dim=(-2, -1)), Q.amax(dim=(-2, -1))
    bih = None
    if stage == 1:
        qmin, qmax = torch.minimum(qmin, qmin_l), torch.maximum(qmax, qmax_l)
    else:
        qmin, qmax = neighbor_minmax(qmin_l, qmax_l, m)
    if stage == 2 and m.cfg["nu_q"] > 0:
        lap1 = dss_sum(laplace_sphere_wk(Q, m), m) \
            * m.rspheremp[:, None, None]
        lap2 = laplace_sphere_wk(lap1, m)
        bih = (-3 * dt * m.cfg["nu_q"] * m.dp0ref[None, None, :, None, None]
               * lap2 / m.spheremp[:, None, None])
    del Q
    vstar = vn0 / dp[:, :, None]
    Qtens = Qdp - dt * divergence_sphere(vstar[:, None] * Qdp[:, :, :, None],
                                         m)
    if bih is not None:
        Qtens = Qtens + bih
    dp_star = dp - dt * divdp
    out, qmin, qmax = limiter(
        Qtens.reshape(E, q, k, 16), m.spheremp.reshape(E, 1, 1, 16),
        qmin, qmax, dp_star.reshape(E, 1, k, 16), max_iter)
    return dss_scale(out.reshape(Qtens.shape), m), qmin, qmax


def tracer_step(m: Model, Qdp, vn0, dt_q, max_iter):
    """Prim_Advec_Tracers_remap_rk2 -> (Qdp', divdp_proj)."""
    divdp = divergence_sphere(vn0, m)
    divdp_proj = dss_scale(divdp, m)
    dt2 = dt_q / 2.0
    zero = Qdp.new_zeros(Qdp.shape[:3])
    Q1, mn, mx = euler_step(m, Qdp, zero, zero, divdp, divdp, vn0, dt2, 0,
                            max_iter)
    Q2, mn, mx = euler_step(m, Q1, mn, mx, divdp, divdp_proj, vn0, dt2, 1,
                            max_iter)
    del Q1
    Q3, _, _ = euler_step(m, Q2, mn, mx, divdp, divdp_proj, vn0, dt2, 2,
                          max_iter)
    return (Qdp + 2.0 * Q3) / 3.0, divdp_proj


def _ghosts(x):
    return torch.cat([x[..., 1:2], x[..., 0:1], x, x[..., -1:],
                      x[..., -2:-1]], dim=-1)


def ppm_coefs(a, d):
    """PPM parabola coefficients [..., 3, n] of cell means a and widths d
    [..., n+4] with two mirrored ghosts a side (compute_ppm, :267)."""
    n = d.shape[-1] - 4

    def w(arr, lo, hi):
        return arr[..., lo + 1:hi + 2]

    dj, djm1, djp1 = w(d, 0, n + 1), w(d, -1, n), w(d, 1, n + 2)
    aj, ajm1, ajp1 = w(a, 0, n + 1), w(a, -1, n), w(a, 1, n + 2)
    da = dj / (djm1 + dj + djp1) * (
        (2.0 * djm1 + dj) / (djp1 + dj) * (ajp1 - aj)
        + (dj + 2.0 * djp1) / (djm1 + dj) * (aj - ajm1))
    dma = torch.minimum(torch.minimum(torch.abs(da),
                                      2.0 * torch.abs(aj - ajm1)),
                        2.0 * torch.abs(ajp1 - aj)) * torch.sign(da)
    dma = torch.where((ajp1 - aj) * (aj - ajm1) <= 0.0, 0.0, dma)
    dj, djm1 = w(d, 0, n), w(d, -1, n - 1)
    djp1, djp2 = w(d, 1, n + 1), w(d, 2, n + 2)
    aj, ajp1 = w(a, 0, n), w(a, 1, n + 1)
    ai = aj + dj / (dj + djp1) * (ajp1 - aj) \
        + 1.0 / (djm1 + dj + djp1 + djp2) * (
            (2.0 * djp1 * dj) / (dj + djp1)
            * ((djm1 + dj) / (2.0 * dj + djp1)
               - (djp2 + djp1) / (2.0 * djp1 + dj)) * (ajp1 - aj)
            - dj * (djm1 + dj) / (2.0 * dj + djp1) * dma[..., 1:n + 2]
            + djp1 * (djp1 + djp2) / (dj + 2.0 * djp1) * dma[..., 0:n + 1])
    acell = w(a, 1, n)
    al, ar = ai[..., 0:n], ai[..., 1:n + 1]
    ext = (ar - acell) * (acell - al) <= 0.0
    al = torch.where(ext, acell, al)
    ar = torch.where(ext, acell, ar)
    dd = ar - al
    test = dd * (acell - 0.5 * (al + ar))
    curv = dd * dd / 6.0
    al = torch.where(test > curv, 3.0 * acell - 2.0 * ar, al)
    ar = torch.where(test < -curv, 3.0 * acell - 2.0 * al, ar)
    return torch.stack([1.5 * acell - 0.25 * (al + ar), ar - al,
                        -6.0 * acell + 3.0 * (al + ar)], dim=-2)


def remap_ppm(qdp, dp1, dp2):
    """Remap column masses qdp [..., Q, n] from widths dp1 [..., n] to dp2
    (equal column totals) by PPM (remap_Q_ppm, :98): each new interface
    lies in the source cell found by counting the source interfaces at or
    below it."""
    n = dp1.shape[-1]
    zeros = torch.zeros_like(dp1[..., :1])
    pio = torch.cat([zeros, torch.cumsum(dp1, -1)], -1)
    pin = torch.cat([zeros, torch.cumsum(dp2, -1)], -1)
    pin[..., -1] = pio[..., -1]
    tgt = pin[..., 1:].contiguous()
    pio_s = torch.cat([pio, pio[..., -1:] + 1.0], -1)
    cnt = torch.searchsorted(pio_s, tgt, right=True)
    kk = torch.clamp(cnt, max=n) - 1
    dpo_kk = torch.gather(dp1, -1, kk)
    z2 = (tgt - 0.5 * (torch.gather(pio, -1, kk)
                       + torch.gather(pio, -1, kk + 1))) / dpo_kk
    ao = qdp / dp1[..., None, :]
    masso = torch.cat([torch.zeros_like(qdp[..., :1]),
                       torch.cumsum(qdp, -1)], -1)
    a_ext = _ghosts(ao)
    coefs = ppm_coefs(a_ext, torch.broadcast_to(_ghosts(dp1)[..., None, :],
                                                a_ext.shape))
    kq = kk[..., None, :].expand(ao.shape)
    c = [torch.gather(coefs[..., i, :], -1, kq) for i in range(3)]
    z = z2[..., None, :]
    x1 = -0.5
    integ = (c[0] * (z - x1) + c[1] * (z * z - x1 * x1) / 2.0
             + c[2] * (z ** 3 - x1 ** 3) / 3.0)
    massn = torch.gather(masso, -1, kq) + integ * dpo_kk[..., None, :]
    return torch.diff(massn, dim=-1, prepend=torch.zeros_like(massn[..., :1]))


def vertical_remap(m: Model, Qdp, divdp_proj, dt_remap):
    """Remap Qdp from the Lagrangian levels onto the hybrid levels
    (:1242-1330) -> (Qdp', min_dp, the least layer thickness)."""
    dp_star = m.dp0col[None, :, None, None] - dt_remap * divdp_proj
    ps = m.hyai[0] * P0 + dp_star.sum(dim=1)
    dp_ref = ((m.hyai[1:] - m.hyai[:-1])[None, :, None, None] * P0
              + (m.hybi[1:] - m.hybi[:-1])[None, :, None, None] * ps[:, None])
    col = torch.movedim(Qdp, (1, 2), (3, 4))          # [E, 4, 4, q, k]
    out = remap_ppm(col, torch.movedim(dp_star, 1, 3),
                    torch.movedim(dp_ref, 1, 3))
    return torch.movedim(out, (3, 4), (1, 2)).contiguous(), dp_star.min()


def subcycle(m: Model, Qdp, nstep: int):
    """rsplit tracer steps and one remap from tracer step nstep ->
    (Qdp', nstep', min_dp).  Qdp [E, q, k, 4, 4], any subset of the
    tracers."""
    cfg = m.cfg
    dt = float(cfg["tstep"])
    divdp_proj = None
    for _ in range(cfg["rsplit"]):
        vn0 = winds(m, float(max(nstep - 1, 0)) * dt) \
            * m.dp0col[None, :, None, None, None]
        Qdp, divdp_proj = tracer_step(
            m, Qdp, vn0, dt, cfg["limiter_iter_cap"] or LIMITER_PASSES)
        nstep += 1
    Qdp, min_dp = vertical_remap(m, Qdp, divdp_proj, dt * cfg["rsplit"])
    return Qdp, nstep, min_dp
