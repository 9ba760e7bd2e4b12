"""Spectral-element spherical operators as batched tensor contractions.

Port of `transport_se_tpu/ops/sphere_ops.py` (reference:
src/share/derivative_mod.F90 — `gradient_sphere` :1660, `divergence_sphere`
:2364, `divergence_sphere_wk` :2027, `laplace_sphere_wk` :2418,
`vorticity_sphere` :2250).  The std-layout euler stage runs them; the wind
basis uses them at model build, the history's flow fields for the
vorticity, and the tests as the unfolded reference of the kernels' weak
Laplacian.

Conventions (grid/quadrature.py): deriv[l, i] = ell_i'(x_l), so
  d/dx S = einsum('li,...ij->...lj', deriv, S)
  d/dy S = einsum('...ij,lj->...il', S, deriv)
Vector fields carry the component axis just before (i, j); D/Dinv are
[E, i, j, 2, 2] with rows = sphere components, columns = contravariant.
"""

from __future__ import annotations

import torch

from ..constants import RREARTH


def _ddx(s, deriv):
    return torch.einsum('li,...ij->...lj', deriv, s)


def _ddy(s, deriv):
    return torch.einsum('...ij,lj->...il', s, deriv)


def _expand(metric_field, target_ndim):
    """Broadcast [E, i, j(, r, c)] metric data against [E, B..., i, j]."""
    extra = target_ndim - metric_field.dim()
    if extra <= 0:
        return metric_field
    return metric_field.reshape(metric_field.shape[:1] + (1,) * extra
                                + metric_field.shape[1:])


def _dinv_rows_first(Dinv, ndim):
    """[E, i, j, 2, 2] -> [E, 1..., 2, 2, i, j] against an ndim-dim field."""
    return _expand(torch.movedim(Dinv, (-2, -1), (1, 2)), ndim + 2)


def gradient_sphere(s, deriv, Dinv):
    """Spherical gradient of scalar s[E, ..., i, j] -> [E, ..., 2, i, j]."""
    v1 = _ddx(s, deriv) * RREARTH
    v2 = _ddy(s, deriv) * RREARTH
    Di = _dinv_rows_first(Dinv, s.dim())
    ds1 = Di[..., 0, 0, :, :] * v1 + Di[..., 1, 0, :, :] * v2
    ds2 = Di[..., 0, 1, :, :] * v1 + Di[..., 1, 1, :, :] * v2
    return torch.stack([ds1, ds2], dim=-3)


def _to_contra(v, Dinv, ndim):
    Di = _dinv_rows_first(Dinv, ndim)
    u = v[..., 0, :, :]
    w = v[..., 1, :, :]
    c1 = Di[..., 0, 0, :, :] * u + Di[..., 0, 1, :, :] * w
    c2 = Di[..., 1, 0, :, :] * u + Di[..., 1, 1, :, :] * w
    return c1, c2


def divergence_sphere(v, deriv, Dinv, metdet, rmetdet):
    """Spherical divergence of v[E, ..., 2, i, j] -> [E, ..., i, j]."""
    c1, c2 = _to_contra(v, Dinv, v.dim() - 1)
    md = _expand(metdet, c1.dim())
    div = _ddx(md * c1, deriv) + _ddy(md * c2, deriv)
    return div * _expand(rmetdet, div.dim()) * RREARTH


def divergence_sphere_wk(v, deriv, Dinv, spheremp):
    """Weak (integrated-by-parts) divergence: -<grad(phi), v>."""
    c1, c2 = _to_contra(v, Dinv, v.dim() - 1)
    sp = _expand(spheremp, c1.dim())
    t1 = torch.einsum('jm,...jn->...mn', deriv, sp * c1)
    t2 = torch.einsum('...mj,jn->...mn', sp * c2, deriv)
    return -(t1 + t2) * RREARTH


def laplace_sphere_wk(s, deriv, Dinv, spheremp):
    """Weak Laplacian with a constant viscosity coefficient."""
    return divergence_sphere_wk(gradient_sphere(s, deriv, Dinv), deriv,
                                Dinv, spheremp)


def vorticity_sphere(v, deriv, D, rmetdet):
    """Spherical vorticity of v[E, ..., 2, i, j] -> [E, ..., i, j]."""
    Dx = _expand(torch.movedim(D, (-2, -1), (1, 2)), v.dim() + 1)
    u = v[..., 0, :, :]
    w = v[..., 1, :, :]
    # covariant: vco = D^T (u, w)
    vco1 = Dx[..., 0, 0, :, :] * u + Dx[..., 1, 0, :, :] * w
    vco2 = Dx[..., 0, 1, :, :] * u + Dx[..., 1, 1, :, :] * w
    vort = _ddx(vco2, deriv) - _ddy(vco1, deriv)
    return vort * _expand(rmetdet, vort.dim()) * RREARTH
