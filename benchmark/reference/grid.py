"""The cubed-sphere grid of the plain reference, in numpy.

A frozen copy of the equiangular gnomonic geometry of the port's host
grid module (GLL points, face coordinates, metric with the reference model's
area renormalisation), with a plainer point identification: coordinates
quantised far above their rounding noise and far below the spacing of
distinct points, and the count of unique points checked against the
cubed sphere's.  Elements are in raster order within each face (ex fast,
ey slow), faces 1..6, as the production face DSS keeps them; point p of an
element is i*4 + j, i along the face's first coordinate.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

PI = 3.141592653589793238462643383279
NP = 4


def gll_points_weights():
    """The 4 GLL points and weights on [-1, 1] (exact closed forms,
    evaluated in extended precision, truncated to float64)."""
    ld = np.longdouble
    s = np.sqrt(ld(1) / ld(5))
    x = np.array([-1, -s, s, 1], dtype=ld)
    w = np.array([1, 5, 5, 1], dtype=ld) / ld(6)
    return x, np.asarray(w, np.float64)


def gll_derivative_matrix(x):
    """deriv[l, i] = ell_i'(x_l) of the 4 GLL cardinal functions."""
    n = NP - 1
    ld = np.longdouble
    # Legendre P_3 at the points: (5 x^3 - 3 x) / 2
    pn = (5 * x ** 3 - 3 * x) / 2
    D = np.zeros((NP, NP), dtype=ld)
    for l in range(NP):
        for i in range(NP):
            if l != i:
                D[l, i] = pn[l] / (pn[i] * (x[l] - x[i]))
    D[0, 0] = -ld(n) * ld(n + 1) / 4
    D[n, n] = ld(n) * ld(n + 1) / 4
    return np.asarray(D, np.float64)


def face_xyz(face, a, b):
    """Unit-sphere coordinates of equiangular face coordinates (a, b)."""
    ta, tb = np.tan(np.asarray(a, np.float64)), np.tan(np.asarray(b, np.float64))
    one = np.ones_like(ta)
    dirs = {1: (one, ta, tb), 2: (-ta, one, tb), 3: (-one, -ta, tb),
            4: (ta, -one, tb), 5: (tb, ta, -one), 6: (-tb, ta, one)}
    X, Y, Z = (np.zeros_like(ta) for _ in range(3))
    for f, (fx, fy, fz) in dirs.items():
        m = face == f
        X[m], Y[m], Z[m] = fx[m], fy[m], fz[m]
    r = np.sqrt(X * X + Y * Y + Z * Z)
    return X / r, Y / r, Z / r


def jacobian(face, x1, x2):
    """Sphere components (zonal, meridional) of the face coordinate basis
    vectors d/dx1, d/dx2 of the gnomonic map: [..., 2, 2]."""
    D = np.zeros(face.shape + (2, 2))
    t1, t2 = np.tan(x1), np.tan(x2)
    r2 = 1.0 + t1 * t1 + t2 * t2
    r = np.sqrt(r2)
    c1, c2 = np.cos(x1), np.cos(x2)
    eq = face <= 4
    D[eq, 0, 0] = (1.0 / (r * c1))[eq]
    D[eq, 1, 0] = (-t1 * t2 / (c1 * r2))[eq]
    D[eq, 1, 1] = (1.0 / (r2 * c1 * c2 * c2))[eq]
    pol = np.sqrt(t1 * t1 + t2 * t2)
    at_pole = pol == 0
    ps = np.where(at_pole, 1.0, pol)
    for f, sign in ((6, 1.0), (5, -1.0)):
        m = face == f
        rows = (np.where(at_pole, 1.0, sign * -t2 / (ps * c1 * c1 * r)),
                np.where(at_pole, 0.0, sign * t1 / (ps * c2 * c2 * r)),
                np.where(at_pole, 0.0, sign * -t1 / (ps * c1 * c1 * r2)),
                np.where(at_pole, 1.0, sign * -t2 / (ps * c2 * c2 * r2)))
        for (i, j), v in zip(((0, 0), (0, 1), (1, 0), (1, 1)), rows):
            D[m, i, j] = v[m]
    return D


@dataclasses.dataclass
class Grid:
    ne: int
    lon: np.ndarray        # [E, 4, 4]
    lat: np.ndarray
    deriv: np.ndarray      # [4, 4]
    Dinv: np.ndarray       # [E, 4, 4, 2, 2] sphere -> contravariant
    metdet: np.ndarray     # [E, 4, 4]
    spheremp: np.ndarray
    rspheremp: np.ndarray  # 1 / the assembled spheremp
    gid: np.ndarray        # [E*16] global point of each (element, point)
    members: np.ndarray    # [ngid, 4] the slots of each point, ascending,
                           # padded with E*16


def build(ne: int) -> Grid:
    E = 6 * ne * ne
    x, w = gll_points_weights()
    deriv = gll_derivative_matrix(x)
    p = np.arange(ne * ne)
    ex, ey = np.tile(p % ne, 6), np.tile(p // ne, 6)
    face = np.repeat(np.arange(1, 7), ne * ne)
    delta = np.longdouble(PI) / (2 * ne)
    half = np.longdouble(PI) / 4
    # the points as float64 first, as the reference model reads them
    x64 = np.asarray(np.asarray(x, np.float64), np.longdouble)
    a = -half + delta * (ex[:, None] + (x64[None, :] + 1) / 2)
    b = -half + delta * (ey[:, None] + (x64[None, :] + 1) / 2)
    A = np.broadcast_to(a[:, :, None], (E, NP, NP))
    B = np.broadcast_to(b[:, None, :], (E, NP, NP))
    F = np.broadcast_to(face[:, None, None], (E, NP, NP))
    Af, Bf = np.asarray(A, np.float64), np.asarray(B, np.float64)

    X, Y, Z = face_xyz(F, A, B)
    lon = np.arctan2(Y, X)
    lon = np.where(lon < 0, lon + 2 * PI, lon)
    lat = np.arcsin(np.clip(Z, -1.0, 1.0))

    # coincident points agree to ~1e-15; distinct ones differ by at least
    # 0.16*delta in some coordinate, so a quantum of delta/100 separates
    # them with room on both sides
    q = float(delta) / 100.0
    keys = np.floor(np.stack([X, Y, Z], -1).reshape(-1, 3) / q + 0.5)
    _, gid = np.unique(keys.astype(np.int64), axis=0, return_inverse=True)
    gid = gid.reshape(-1)
    ngid = int(gid.max()) + 1
    if ngid != 6 * (ne * (NP - 1)) ** 2 + 2:
        raise RuntimeError(f"point identification: {ngid} points")
    order = np.argsort(gid, kind="stable")
    starts = np.searchsorted(gid[order], np.arange(ngid))
    mult = np.bincount(gid, minlength=ngid)
    members = np.full((ngid, 4), E * 16, np.int64)
    for s in range(4):
        has = mult > s
        members[has, s] = order[starts[has] + s]

    # metric: Jacobian of the reference square onto the face, then the
    # area renormalisation to 4 pi
    D = jacobian(F, Af, Bf) * (float(delta) / 2.0)
    det = D[..., 0, 0] * D[..., 1, 1] - D[..., 0, 1] * D[..., 1, 0]
    mp = np.broadcast_to(w[:, None] * w[None, :], (E, NP, NP))
    alpha = 4 * PI / math.fsum((mp * np.abs(det)).reshape(-1).tolist())
    D = D * np.sqrt(alpha)
    det = det * alpha
    Dinv = np.empty_like(D)
    Dinv[..., 0, 0] = D[..., 1, 1] / det
    Dinv[..., 0, 1] = -D[..., 0, 1] / det
    Dinv[..., 1, 0] = -D[..., 1, 0] / det
    Dinv[..., 1, 1] = D[..., 0, 0] / det
    metdet = np.abs(det)
    spheremp = mp * metdet
    acc = np.zeros(ngid)
    np.add.at(acc, gid, spheremp.reshape(-1))
    rspheremp = (1.0 / acc[gid]).reshape(E, NP, NP)
    return Grid(ne=ne, lon=lon, lat=lat, deriv=deriv, Dinv=Dinv,
                metdet=metdet, spheremp=spheremp, rspheremp=rspheremp,
                gid=gid, members=members)
