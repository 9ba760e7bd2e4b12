"""DCMIP-2012 test-case 1-1 / 1-2 analytic fields.

Port of `transport_se_tpu/model/dcmip.py` (reference:
src/share/dcmip_123_mod.F90:85 `test1_advection_deformation`, :279
`test1_advection_hadley`; wrapper conventions
src/share/dcmip_wrapper_mod.F90:49,106): the initial tracers, the
prescribed winds and the vertical mass flux eta_dot_dpdn.  The std-layout
step evaluates the winds directly; the T-layout step evaluates the same
fields through the factored `model.wind_basis`, which reads the constants
below.

lon/lat are [E, np, np] tensors; level coordinates are [K]; time is a
float or a 0-dim tensor; outputs carry [E, K, ...] with the level axis
second ([E, q, K, n, n] for the tracers).
"""

from __future__ import annotations

import math

import torch

from ..constants import (DD_PI as PI, G, P0, REARTH, RGAS,
                                        SCALE_HEIGHT, T0)

SECPDAY = 86400.0

# ---- test 1-1 parameters (dcmip_123_mod.F90:116-129)
TAU_11 = 12.0 * SECPDAY
U0_11 = 2.0 * PI * REARTH / TAU_11
K0_11 = 10.0 * REARTH / TAU_11
OMEGA0_11 = 23000.0 * PI / TAU_11
RR_11 = 0.5
ZZ_11 = 1000.0
Z0_11 = 5000.0
LAMBDA0_11 = 5.0 * PI / 6.0
LAMBDA1_11 = 7.0 * PI / 6.0
BS_11 = 0.2
ZTOP_11 = 12000.0

# ---- test 1-2 parameters (dcmip_123_mod.F90:309-319)
TAU_12 = 1.0 * SECPDAY
U0_12 = 40.0
W0_12 = 0.15
K_12 = 5.0
Z1_12 = 2000.0
Z2_12 = 5000.0
Z0_12 = 0.5 * (Z1_12 + Z2_12)
ZTOP_12 = 12000.0


def _bcast(lon, lat, eta):
    """lon/lat [E,n,n], eta [K] -> broadcastable [E,K,n,n] pieces."""
    return lon[:, None], lat[:, None], eta[None, :, None, None]


def _time(time, like):
    return torch.as_tensor(time, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# test 1-1: 3D deformational flow
# ---------------------------------------------------------------------------

def winds_11(lon, lat, etam, time):
    """Horizontal winds (zonal, meridional) -> [E, K, 2, n, n]."""
    lon, lat, eta = _bcast(lon, lat, etam)
    time = _time(time, lon)
    p = P0 * eta
    ptop = P0 * torch.exp(lon.new_tensor(-ZTOP_11 / SCALE_HEIGHT))
    plim = torch.maximum(p, ptop)

    lonp = lon - 2.0 * PI * time / TAU_11
    cos2t = torch.cos(2.0 * PI * time / TAU_11)
    cost = torch.cos(PI * time / TAU_11)

    bsp = BS_11 * ptop
    ud = (OMEGA0_11 * REARTH / bsp) * torch.cos(lonp) * torch.cos(lat) ** 2 \
        * cos2t * (-torch.exp((plim - P0) / bsp)
                   + torch.exp((ptop - plim) / bsp))
    u = (K0_11 * torch.sin(lonp) ** 2 * torch.sin(2.0 * lat) * cost
         + U0_11 * torch.cos(lat) + ud)
    v = K0_11 * torch.sin(2.0 * lonp) * torch.cos(lat) * cost
    return torch.stack(torch.broadcast_tensors(u, v), dim=2)


def eta_dot_dpdn_11(lon, lat, etai, time):
    """-g*rho*w at interfaces -> [E, K+1, n, n] (diagnostics only)."""
    lon, lat, eta = _bcast(lon, lat, etai)
    time = _time(time, lon)
    p = P0 * eta
    ptop = P0 * torch.exp(lon.new_tensor(-ZTOP_11 / SCALE_HEIGHT))
    plim = torch.maximum(p, ptop)
    lonp = lon - 2.0 * PI * time / TAU_11
    cos2t = torch.cos(2.0 * PI * time / TAU_11)
    bsp = BS_11 * ptop
    s = (1.0 + torch.exp((ptop - P0) / bsp) - torch.exp((plim - P0) / bsp)
         - torch.exp((ptop - plim) / bsp))
    w = -((RGAS * T0) / (G * plim)) * OMEGA0_11 * torch.sin(lonp) \
        * torch.cos(lat) * cos2t * s
    rho = p / (RGAS * T0)
    return torch.broadcast_to(-G * rho * w, lon.shape[:1] + (eta.shape[1],)
                              + lon.shape[2:])


def tracers_11(lon, lat, etam):
    """Initial tracers q1..q4 -> [E, 4, K, n, n]."""
    lon, lat, eta = _bcast(lon, lat, etam)
    height = SCALE_HEIGHT * torch.log(1.0 / eta)

    sin_tmp = torch.sin(lat) * math.sin(0.0)
    cos_tmp = torch.cos(lat) * math.cos(0.0)
    r1 = torch.arccos(torch.clamp(
        sin_tmp + cos_tmp * torch.cos(lon - LAMBDA0_11), -1.0, 1.0))
    r2 = torch.arccos(torch.clamp(
        sin_tmp + cos_tmp * torch.cos(lon - LAMBDA1_11), -1.0, 1.0))
    zdev = ((height - Z0_11) / ZZ_11) ** 2
    d1 = torch.clamp((r1 / RR_11) ** 2 + zdev, max=1.0)
    d2 = torch.clamp((r2 / RR_11) ** 2 + zdev, max=1.0)

    q1 = 0.5 * (1.0 + torch.cos(PI * d1)) + 0.5 * (1.0 + torch.cos(PI * d2))
    q2 = 0.9 - 0.8 * q1 ** 2
    one, tenth = lat.new_tensor(1.0), lat.new_tensor(0.1)
    q3 = torch.where((d1 <= RR_11) | (d2 <= RR_11), one, tenth)
    q3 = torch.where((height > Z0_11) & (torch.abs(lat) < 0.125), tenth, q3)
    q3 = torch.broadcast_to(q3, q1.shape)
    q4 = 1.0 - 0.3 * (q1 + q2 + q3)
    return torch.stack([q1, q2, q3, q4], dim=1)


# ---------------------------------------------------------------------------
# test 1-2: Hadley-like meridional circulation
# ---------------------------------------------------------------------------

def winds_12(lon, lat, etam, time):
    lon, lat, eta = _bcast(lon, lat, etam)
    time = _time(time, lon)
    height = SCALE_HEIGHT * torch.log(1.0 / eta)
    p = P0 * eta
    ptop = P0 * torch.exp(lon.new_tensor(-ZTOP_12 / SCALE_HEIGHT))
    rho_ratio = P0 / torch.maximum(p, ptop)          # rho0/rho

    u = U0_12 * torch.cos(lat)
    hstar = torch.clamp(height / ZTOP_12, max=1.0)
    v = -rho_ratio * (REARTH * W0_12 * PI) / (K_12 * ZTOP_12) \
        * torch.cos(lat) * torch.sin(K_12 * lat) * torch.cos(PI * hstar) \
        * torch.cos(PI * time / TAU_12)
    return torch.stack(torch.broadcast_tensors(u, v), dim=2)


def eta_dot_dpdn_12(lon, lat, etai, time):
    lon, lat, eta = _bcast(lon, lat, etai)
    time = _time(time, lon)
    height = SCALE_HEIGHT * torch.log(1.0 / eta)
    p = P0 * eta
    ptop = P0 * torch.exp(lon.new_tensor(-ZTOP_12 / SCALE_HEIGHT))
    rho = torch.maximum(p, ptop) / (RGAS * T0)
    rho0 = P0 / (RGAS * T0)
    hstar = torch.clamp(height / ZTOP_12, max=1.0)
    w = (rho0 / rho) * (W0_12 / K_12) \
        * (-2.0 * torch.sin(K_12 * lat) * torch.sin(lat)
           + K_12 * torch.cos(lat) * torch.cos(K_12 * lat)) \
        * torch.sin(PI * hstar) * torch.cos(PI * time / TAU_12)
    out = -G * rho * w
    return torch.broadcast_to(out, lon.shape[:1] + (eta.shape[1],)
                              + lon.shape[2:])


def tracer_12(lon, lat, etam):
    """The Hadley layer tracer -> [E, 1, K, n, n]."""
    lon, lat, eta = _bcast(lon, lat, etam)
    height = SCALE_HEIGHT * torch.log(1.0 / eta)
    q = torch.where((height < Z2_12) & (height > Z1_12),
                    0.5 * (1.0 + torch.cos(2.0 * PI * (height - Z0_12)
                                           / (Z2_12 - Z1_12))),
                    lat.new_tensor(0.0))
    q = torch.broadcast_to(q, lon.shape[:1] + (eta.shape[1],)
                           + lon.shape[2:])
    return q[:, None]


def checkerboard(lon, lat, nlev):
    """sign(sin(9 lon) * sin(9 lat)) >= 0 -> 1 else 0; [E, K, n, n]."""
    term = torch.sin(9.0 * lon) * torch.sin(9.0 * lat)
    q2d = torch.where(term < 0.0, lon.new_tensor(0.0), lon.new_tensor(1.0))
    return torch.broadcast_to(q2d[:, None], q2d.shape[:1] + (nlev,)
                              + q2d.shape[1:])


def initial_tracer_fields(test_case, lon, lat, etam, qsize):
    """The initial tracers one at a time: a list of qsize [E, K, n, n]
    fields, views where tracers share one (wrapper semantics: dcmip1-1
    fills tracers 5.. with the checkerboard, dcmip1-2 fills tracer 1 and
    tracers 3.. with it)."""
    nlev = etam.shape[0]
    chk = checkerboard(lon, lat, nlev)
    if test_case == "dcmip1-1":
        qs = tracers_11(lon, lat, etam)
        parts = [qs[:, i] for i in range(4)] + [chk] * max(0, qsize - 4)
    elif test_case == "dcmip1-2":
        parts = [chk, tracer_12(lon, lat, etam)[:, 0]] \
            + [chk] * max(0, qsize - 2)
    else:
        raise ValueError(f"unknown test case {test_case}")
    return parts[:qsize]


def initial_tracers(test_case, lon, lat, etam, qsize):
    """Full initial tracer stack [E, qsize, K, n, n]
    (initial_tracer_fields stacked)."""
    return torch.stack(initial_tracer_fields(test_case, lon, lat, etam,
                                             qsize), dim=1)


def winds(test_case, lon, lat, etam, time):
    if test_case == "dcmip1-1":
        return winds_11(lon, lat, etam, time)
    elif test_case == "dcmip1-2":
        return winds_12(lon, lat, etam, time)
    raise ValueError(f"unknown test case {test_case}")


def eta_dot_dpdn(test_case, lon, lat, etai, time):
    if test_case == "dcmip1-1":
        return eta_dot_dpdn_11(lon, lat, etai, time)
    elif test_case == "dcmip1-2":
        return eta_dot_dpdn_12(lon, lat, etai, time)
    raise ValueError(f"unknown test case {test_case}")
