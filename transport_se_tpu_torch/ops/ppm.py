"""Monotone PPM vertical remap, vectorized over columns and tracers.

Port of `transport_se_tpu/ops/ppm.py:30-262` (reference:
prim_advection_mod.F90:98 `remap_Q_ppm`, :221 `compute_ppm_grids`, :267
`compute_ppm`, :349 `integrate_parabola`): the level-minor fast path
`remap_q_ppm` with its bounded cell search (interface displacements of
-2..+2 cells), `ppm_fast_margin`, the health check that guards that
window, and `remap_q_ppm_general`, the unbounded search of
`ppm_search="general"` (the reference's walking loop, :159-173, as a
count).  `remap_q_ppm` and `ppm_fast_margin` are the plain references
that the remap kernel and the health kernel (`ops/remap.py`), which both
pipelines run, are held against in the tests; `remap_q_ppm_general` is the
general search of both pipelines (`model/core.py remap_lanes_t`).
"""

from __future__ import annotations

import torch


def _cat_ghosts(x):
    """[..., n] -> [..., n+4] with the two mirrored ghosts each side."""
    return torch.cat([x[..., 1:2], x[..., 0:1], x, x[..., -1:],
                      x[..., -2:-1]], dim=-1)


def compute_ppm_coefs(ao_ext, dpo_ext, alg: int = 0):
    """PPM parabola coefficients per cell: [..., 3, nlev].

    ao_ext/dpo_ext: [..., nlev+4] cell means/widths with 2 mirrored ghosts
    each side (0-based g = Fortran j + 1).  alg 2 makes the two cells at
    each boundary piecewise constant (prim_advection_mod.F90:336-342).
    """
    d = dpo_ext
    a = ao_ext
    nlev = d.shape[-1] - 4

    def w(arr, lo, hi):  # Fortran-index window [lo, hi] inclusive
        return arr[..., lo + 1:hi + 2]

    dj, djm1, djp1 = w(d, 0, nlev + 1), w(d, -1, nlev), w(d, 1, nlev + 2)
    aj, ajm1, ajp1 = w(a, 0, nlev + 1), w(a, -1, nlev), w(a, 1, nlev + 2)
    c1 = dj / (djm1 + dj + djp1)
    c2 = (2.0 * djm1 + dj) / (djp1 + dj)
    c3 = (dj + 2.0 * djp1) / (djm1 + dj)
    da = c1 * (c2 * (ajp1 - aj) + c3 * (aj - ajm1))
    dma = torch.minimum(torch.minimum(torch.abs(da),
                                      2.0 * torch.abs(aj - ajm1)),
                        2.0 * torch.abs(ajp1 - aj)) * torch.sign(da)
    dma = torch.where((ajp1 - aj) * (aj - ajm1) <= 0.0, 0.0, dma)

    dj, djm1 = w(d, 0, nlev), w(d, -1, nlev - 1)
    djp1, djp2 = w(d, 1, nlev + 1), w(d, 2, nlev + 2)
    aj, ajp1 = w(a, 0, nlev), w(a, 1, nlev + 1)
    c4 = dj / (dj + djp1)
    c5 = 1.0 / (djm1 + dj + djp1 + djp2)
    c6 = (2.0 * djp1 * dj) / (dj + djp1)
    c7 = (djm1 + dj) / (2.0 * dj + djp1)
    c8 = (djp2 + djp1) / (2.0 * djp1 + dj)
    c9 = dj * (djm1 + dj) / (2.0 * dj + djp1)
    c10 = djp1 * (djp1 + djp2) / (dj + 2.0 * djp1)
    dma_j = dma[..., 0:nlev + 1]
    dma_jp1 = dma[..., 1:nlev + 2]
    ai = aj + c4 * (ajp1 - aj) + c5 * (c6 * (c7 - c8) * (ajp1 - aj)
                                       - c9 * dma_jp1 + c10 * dma_j)

    acell = w(a, 1, nlev)
    al = ai[..., 0:nlev]
    ar = ai[..., 1:nlev + 1]
    local_extremum = (ar - acell) * (acell - al) <= 0.0
    al = torch.where(local_extremum, acell, al)
    ar = torch.where(local_extremum, acell, ar)
    dd = ar - al
    test = dd * (acell - 0.5 * (al + ar))
    curv = dd * dd / 6.0
    al = torch.where(test > curv, 3.0 * acell - 2.0 * ar, al)
    ar = torch.where(test < -curv, 3.0 * acell - 2.0 * al, ar)
    coef0 = 1.5 * acell - 0.25 * (al + ar)
    coef1 = ar - al
    coef2 = -6.0 * acell + 3.0 * (al + ar)
    if alg == 2:
        edge = torch.zeros(nlev, dtype=torch.bool, device=d.device)
        edge[[0, 1, nlev - 2, nlev - 1]] = True
        coef0 = torch.where(edge, acell, coef0)
        coef1 = torch.where(edge, 0.0, coef1)
        coef2 = torch.where(edge, 0.0, coef2)
    return torch.stack([coef0, coef1, coef2], dim=-2)


def _shift_left_clamp(a, n=1):
    """a[..., j] -> a[..., j+n] with the last entry clamped."""
    return torch.cat([a[..., n:]] + [a[..., -1:]] * n, dim=-1)


def _shift_right_clamp(a, n=1):
    """a[..., j] -> a[..., j-n] with the first entry clamped."""
    return torch.cat([a[..., :1]] * n + [a[..., :-n]], dim=-1)


def _make_sel(b_up3, b_up2, b_up1, b_dn1, b_dn2):
    """Selector for a[..., k0 + shift], shift in [-2, 3] (ops/ppm.py)."""
    def sel(a):
        up23 = torch.where(b_up3, _shift_left_clamp(a, 3),
                           _shift_left_clamp(a, 2))
        up = torch.where(b_up2, up23, _shift_left_clamp(a, 1))
        dn = torch.where(b_dn2, _shift_right_clamp(a, 2),
                         _shift_right_clamp(a, 1))
        return torch.where(b_up1, up, torch.where(b_dn1, dn, a))
    return sel


def _interfaces(dp1, dp2):
    """pio/pin [..., nlev+1] with the forced-equal column totals."""
    zeros = torch.zeros_like(dp1[..., :1])
    pio = torch.cat([zeros, torch.cumsum(dp1, dim=-1)], dim=-1)
    pin = torch.cat([zeros, torch.cumsum(dp2, dim=-1)], dim=-1)
    pin[..., -1] = pio[..., -1]
    return pio, pin


def remap_q_ppm(qdp, dp1, dp2, alg: int = 0):
    """Remap tracer mass qdp [..., Q, nlev] from layer widths dp1 [..., nlev]
    to dp2 [..., nlev] (same column totals), conserving each column's mass.
    The enclosing source cell of each new interface is found by a bounded
    shift-select over displacements of -2..+2 cells (see ppm_fast_margin).
    """
    pio, pin = _interfaces(dp1, dp2)
    dpo_ext = _cat_ghosts(dp1)
    tgt = pin[..., 1:]
    pio_l = pio[..., :-1]
    pio_r = pio[..., 1:]
    b_up1 = pio_r <= tgt
    b_up1[..., -1] = False
    b_up2 = (_shift_left_clamp(pio_r) <= tgt) & b_up1
    b_up2[..., -2:] = False
    b_up3 = (_shift_left_clamp(pio_r, 2) <= tgt) & b_up2
    b_up3[..., -3:] = False
    b_dn1 = pio_l > tgt
    b_dn2 = (_shift_right_clamp(pio_l) > tgt) & b_dn1
    sel = _make_sel(b_up3, b_up2, b_up1, b_dn1, b_dn2)

    dpo_kk = sel(dp1)
    pio_kk = sel(pio_l)
    pio_kk1 = sel(pio_r)
    z2 = (tgt - 0.5 * (pio_kk + pio_kk1)) / dpo_kk

    ao = qdp / dp1[..., None, :]
    masso = torch.cat([torch.zeros_like(qdp[..., :1]),
                       torch.cumsum(qdp, dim=-1)], dim=-1)
    ao_ext = _cat_ghosts(ao)
    dpo_ext_q = torch.broadcast_to(dpo_ext[..., None, :], ao_ext.shape)
    coefs = compute_ppm_coefs(ao_ext, dpo_ext_q, alg)

    selq = _make_sel(b_up3[..., None, :], b_up2[..., None, :],
                     b_up1[..., None, :], b_dn1[..., None, :],
                     b_dn2[..., None, :])
    masso_kk = selq(masso[..., :-1])
    c0 = selq(coefs[..., 0, :])
    c1 = selq(coefs[..., 1, :])
    c2 = selq(coefs[..., 2, :])
    z2q = z2[..., None, :]
    x1 = -0.5
    integ = (c0 * (z2q - x1) + c1 * (z2q * z2q - x1 * x1) / 2.0
             + c2 * (z2q ** 3 - x1 ** 3) / 3.0)
    massn = masso_kk + integ * dpo_kk[..., None, :]
    return torch.diff(massn, dim=-1,
                      prepend=torch.zeros_like(massn[..., :1]))


def ppm_fast_margin(dp1, dp2):
    """Safety margin (Pa) of the bounded-shift fast path: the minimum over
    interior interfaces of the distance from the target interface to the
    edges of the source window pio[j-2]..pio[j+4].  Negative means the
    fast path is invalid and the run must abort."""
    nlev = dp1.shape[-1]
    pio, pin = _interfaces(dp1, dp2)
    tgt = pin[..., 1:-1]
    idx = torch.arange(nlev - 1, device=dp1.device)
    lo = pio[..., torch.clamp(idx - 2, min=0)]
    hi = pio[..., torch.clamp(idx + 4, max=nlev)]
    return torch.minimum(tgt - lo, hi - tgt).min()


def _integrate_parabola(coefs, x1, x2):
    """Definite integral of the parabola in normalized coordinates."""
    a0 = coefs[..., 0, :]
    a1 = coefs[..., 1, :]
    a2 = coefs[..., 2, :]
    return (a0 * (x2 - x1) + a1 * (x2 * x2 - x1 * x1) / 2.0
            + a2 * (x2 ** 3 - x1 ** 3) / 3.0)


def remap_q_ppm_general(qdp, dp1, dp2, alg: int = 0):
    """remap_q_ppm with the unbounded cell search: the source cell of each
    new interface is the count of source interfaces at or below it, so any
    deformation of the Lagrangian levels remaps correctly."""
    nlev = dp1.shape[-1]
    pio, pin = _interfaces(dp1, dp2)
    # the top-of-column sentinel (:142-144)
    pio_s = torch.cat([pio, pio[..., -1:] + 1.0], dim=-1)
    dpo_ext = _cat_ghosts(dp1)

    tgt = pin[..., 1:]
    cnt = (pio_s[..., None, :] <= tgt[..., :, None]).sum(dim=-1)
    kk0 = torch.clamp(cnt, max=nlev) - 1             # 0-based source cell

    dpo_kk = torch.gather(dp1, -1, kk0)
    pio_kk = torch.gather(pio, -1, kk0)
    pio_kk1 = torch.gather(pio, -1, kk0 + 1)
    z2 = (tgt - 0.5 * (pio_kk + pio_kk1)) / dpo_kk

    ao = qdp / dp1[..., None, :]
    masso = torch.cat([torch.zeros_like(qdp[..., :1]),
                       torch.cumsum(qdp, dim=-1)], dim=-1)
    ao_ext = _cat_ghosts(ao)
    coefs = compute_ppm_coefs(
        ao_ext, torch.broadcast_to(dpo_ext[..., None, :], ao_ext.shape), alg)

    kk0q = kk0[..., None, :].expand(ao.shape)
    coefs_kk = torch.stack([torch.gather(coefs[..., c, :], -1, kk0q)
                            for c in range(3)], dim=-2)
    masso_kk = torch.gather(masso, -1, kk0q)
    z2q = torch.broadcast_to(z2[..., None, :], ao.shape)
    dpo_kkq = torch.broadcast_to(dpo_kk[..., None, :], ao.shape)
    massn = masso_kk + _integrate_parabola(coefs_kk, -0.5, z2q) * dpo_kkq
    return torch.diff(massn, dim=-1,
                      prepend=torch.zeros_like(massn[..., :1]))
