"""Gauss-Lobatto-Legendre quadrature and the GLL derivative matrix.

The port's own copy of `transport_se_tpu/grid/quadrature.py` (numpy only), kept
bit-identical to it (tests/test_torch_host.py).

TPU-native equivalent of the reference quadrature/derivative setup
(reference: src/share/quadrature_mod.F90:284 `gausslobatto`,
src/share/derivative_mod.F90:116 `derivinit`).  Everything here is host-side
numpy, computed in extended precision (longdouble) and truncated to float64,
mirroring the reference's longdouble->real*8 policy.

Conventions
-----------
`deriv[l, i]` is d(ell_i)/dx evaluated at GLL point x_l, where ell_i is the
Lagrange cardinal function of point i.  The reference stores the transpose,
Dvv(i,l) (derivative_mod.F90:19-25); all einsums in ops/ are written against
this row-major convention:

    d/dx S = deriv @ S          (derivative along the first GLL axis)
    d/dy S = S @ deriv.T        (derivative along the second GLL axis)
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["gll_points_weights", "gll_derivative_matrix", "lagrange_eval"]


def _legendre_and_deriv(n: int, x):
    """Legendre polynomial P_n and P_n' at x (recurrence, any float dtype)."""
    p0 = np.ones_like(x)
    p1 = x.copy()
    if n == 0:
        return p0, np.zeros_like(x)
    for k in range(2, n + 1):
        p0, p1 = p1, ((2 * k - 1) * x * p1 - (k - 1) * p0) / k
    # derivative: (x^2-1)/n * P_n' = x P_n - P_{n-1}
    denom = x * x - 1.0
    denom = np.where(denom == 0, 1.0, denom)  # endpoints handled by caller
    dp = n * (x * p1 - p0) / denom
    return p1, dp


@functools.lru_cache(maxsize=None)
def gll_points_weights(npts: int):
    """GLL points and weights on [-1, 1], float64 (computed in longdouble).

    Matches quadrature_mod.F90:284-477 (which also computes in extended
    precision).  For npts=4 these are the exact values +-1, +-sqrt(1/5) with
    weights 1/6, 5/6.
    """
    if npts < 2:
        raise ValueError("need at least 2 GLL points")
    n = npts - 1
    ld = np.longdouble
    # Chebyshev-Gauss-Lobatto initial guess, then Newton on P'_n(x) = 0
    x = -np.cos(np.pi * np.arange(npts, dtype=ld) / ld(n))
    for _ in range(100):
        xi = x[1:-1]
        # interior points are roots of P_n'
        _, dp = _legendre_and_deriv(n, xi)
        # d/dx P_n' = P_n'' = (2x P_n' - n(n+1) P_n)/(1-x^2)
        pn, dpn = _legendre_and_deriv(n, xi)
        d2p = (2 * xi * dpn - n * (n + 1) * pn) / (1 - xi * xi)
        dx = dp / d2p
        x[1:-1] = xi - dx
        if np.max(np.abs(dx)) < np.finfo(ld).eps * 4:
            break
    pn, _ = _legendre_and_deriv(n, x)
    w = 2.0 / (ld(n) * ld(n + 1) * pn * pn)
    return np.asarray(x, dtype=np.float64), np.asarray(w, dtype=np.float64)


@functools.lru_cache(maxsize=None)
def gll_derivative_matrix(npts: int) -> np.ndarray:
    """deriv[l, i] = ell_i'(x_l), float64 (longdouble internally).

    Equals the transpose of the reference Dvv (derivative_mod.F90:154-155).
    """
    n = npts - 1
    ld = np.longdouble
    x = -np.cos(np.pi * np.arange(npts, dtype=ld) / ld(n))
    # recompute points in longdouble (same Newton as above)
    for _ in range(100):
        xi = x[1:-1]
        pn, dpn = _legendre_and_deriv(n, xi)
        d2p = (2 * xi * dpn - n * (n + 1) * pn) / (1 - xi * xi)
        dx = dpn / d2p
        x[1:-1] = xi - dx
        if np.max(np.abs(dx)) < np.finfo(ld).eps * 4:
            break
    pn, _ = _legendre_and_deriv(n, x)
    D = np.zeros((npts, npts), dtype=ld)
    for l in range(npts):
        for i in range(npts):
            if l != i:
                D[l, i] = pn[l] / (pn[i] * (x[l] - x[i]))
    D[0, 0] = -ld(n) * ld(n + 1) / 4
    D[n, n] = ld(n) * ld(n + 1) / 4
    return np.asarray(D, dtype=np.float64)


def lagrange_eval(xgll: np.ndarray, xeval: np.ndarray) -> np.ndarray:
    """Matrix L[m, i] = ell_i(xeval_m) of cardinal functions at new points."""
    xgll = np.asarray(xgll, dtype=np.longdouble)
    xeval = np.asarray(xeval, dtype=np.longdouble)
    npts = xgll.size
    L = np.ones((xeval.size, npts), dtype=np.longdouble)
    for i in range(npts):
        for k in range(npts):
            if k != i:
                L[:, i] *= (xeval - xgll[k]) / (xgll[i] - xgll[k])
    return np.asarray(L, dtype=np.float64)
