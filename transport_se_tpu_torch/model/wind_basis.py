"""Factored prescribed-wind evaluation for the T-layout pipeline.

Port of `transport_se_tpu/model/wind_basis.py`.  The DCMIP 1-1 / 1-2 wind
fields (reference: dcmip_123_mod.F90:161-184, :321-341) separate exactly
into sums of (2D horizontal field) x (vertical profile) x (scalar function
of t) after expanding the rotating-longitude terms with angle addition.
Divergence and DSS are linear, so the same basis gives divdp and the
DSS-projected divdp_proj from per-term divergence fields computed once at
model build; a step then evaluates the basis in one launch of the wind
kernel (`ops/wind.py`, `csrc/wind.cu`), which writes the four fields the T
path reads.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from ..constants import DD_PI as PI, P0, REARTH, SCALE_HEIGHT

from ..ops import sphere_ops as so
from ..ops.wind import wind_eval_t, wind_eval_t_plain
from . import dcmip


@dataclasses.dataclass(frozen=True)
class WindBasis:
    """Per-term tensors, T layout, on the model's device.

    u2d/v2d: [T, E, 16]  horizontal coefficient fields
    fk:      [T, K]      vertical profiles
    g2d:     [T, E, 16]  divergence_sphere of (u2d, v2d)
    gp2d:    [T, E, 16]  DSS-projected (rsp * DSS(sp * g2d))
    prof:    [T, K]      fk * dp0 (the profile of vn0 and of divdp)
    tfns:    scalar time functions, one per term
    dp0:     [K]
    plain:   evaluate with the plain version (wind_eval_t_plain) on any
             device
    """
    u2d: torch.Tensor
    v2d: torch.Tensor
    fk: torch.Tensor
    g2d: torch.Tensor
    gp2d: torch.Tensor
    prof: torch.Tensor
    tfns: Sequence[Callable]
    dp0: torch.Tensor
    plain: bool = False

    def time_values(self, t):
        """t: 0-dim tensor (model dtype) -> the time functions' values
        [T], on the device (no host sync)."""
        return torch.stack([torch.as_tensor(fn(t), dtype=self.dp0.dtype,
                                            device=self.dp0.device)
                            for fn in self.tfns])

    def eval(self, t):
        """t: 0-dim tensor (model dtype) -> (un0_t, vn0_t, divdp_t,
        divdp_proj_t), all [E, 16, K]; un0/vn0 carry the dp0 weight (the
        mean-flux vn0)."""
        fn = wind_eval_t_plain if self.plain else wind_eval_t
        return fn(self.u2d, self.v2d, self.g2d, self.gp2d,
                  self.time_values(t), self.fk, self.prof, self.dp0)


def build_wind_basis(m, plain: bool = False) -> WindBasis:
    """Precompute the factored wind basis for m.cfg.test_case (plain:
    the DSS of the divergence terms and every evaluation run their plain
    versions).

    dcmip1-1 terms (lon' = lon - omega t, C = OMEGA0*REARTH/(BS*ptop)):
      1: (U0 cos(lat), 0)                 x 1    x 1
      2: (K0/2 sin(2lat), 0)              x 1    x c(pi t/tau)
      3: (-K0/2 sin2lat cos2lon, K0 coslat sin2lon) x 1 x c(pi t/tau) c(2wt)
      4: (-K0/2 sin2lat sin2lon, -K0 coslat cos2lon) x 1 x c(pi t/tau) s(2wt)
      5: (C cos^2lat coslon, 0)           x F(k) x c(wt)^2
      6: (C cos^2lat sinlon, 0)           x F(k) x s(wt) c(wt)
    dcmip1-2 terms:
      1: (U0 cos(lat), 0)  x 1     x 1
      2: (0, A(lat))       x B(k)  x c(pi t/tau)
    """
    cfg = m.cfg
    f = m.dtype
    E = m.lon.shape[0]
    lon = m.lon.reshape(E, 16)
    lat = m.lat.reshape(E, 16)
    etam = np.asarray(m.hv.etam, np.float64)
    K = etam.shape[0]
    zeros = torch.zeros((E, 16), dtype=f, device=m.device)
    ones_k = np.ones(K)

    if cfg.test_case == "dcmip1-1":
        tau = dcmip.TAU_11
        om = 2.0 * PI / tau
        ptop = P0 * np.exp(-dcmip.ZTOP_11 / SCALE_HEIGHT)
        bsp = dcmip.BS_11 * ptop
        C = dcmip.OMEGA0_11 * REARTH / bsp
        plim = np.maximum(P0 * etam, ptop)
        F = -np.exp((plim - P0) / bsp) + np.exp((ptop - plim) / bsp)
        K0 = dcmip.K0_11
        terms = [
            (dcmip.U0_11 * torch.cos(lat), zeros, ones_k,
             lambda t: 1.0 + 0 * t),
            (0.5 * K0 * torch.sin(2 * lat), zeros, ones_k,
             lambda t: torch.cos(PI * t / tau)),
            (-0.5 * K0 * torch.sin(2 * lat) * torch.cos(2 * lon),
             K0 * torch.cos(lat) * torch.sin(2 * lon), ones_k,
             lambda t: torch.cos(PI * t / tau) * torch.cos(2 * om * t)),
            (-0.5 * K0 * torch.sin(2 * lat) * torch.sin(2 * lon),
             -K0 * torch.cos(lat) * torch.cos(2 * lon), ones_k,
             lambda t: torch.cos(PI * t / tau) * torch.sin(2 * om * t)),
            (C * torch.cos(lat) ** 2 * torch.cos(lon), zeros, F,
             lambda t: torch.cos(om * t) ** 2),
            (C * torch.cos(lat) ** 2 * torch.sin(lon), zeros, F,
             lambda t: torch.sin(om * t) * torch.cos(om * t)),
        ]
    elif cfg.test_case == "dcmip1-2":
        tau = dcmip.TAU_12
        height = SCALE_HEIGHT * np.log(1.0 / etam)
        ptop = P0 * np.exp(-dcmip.ZTOP_12 / SCALE_HEIGHT)
        rho_ratio = P0 / np.maximum(P0 * etam, ptop)
        hstar = np.minimum(height / dcmip.ZTOP_12, 1.0)
        B = rho_ratio * np.cos(PI * hstar)
        A = -(REARTH * dcmip.W0_12 * PI) / (dcmip.K_12 * dcmip.ZTOP_12) \
            * torch.cos(lat) * torch.sin(dcmip.K_12 * lat)
        terms = [
            (dcmip.U0_12 * torch.cos(lat), zeros, ones_k,
             lambda t: 1.0 + 0 * t),
            (zeros, A, B, lambda t: torch.cos(PI * t / tau)),
        ]
    else:
        raise ValueError(cfg.test_case)

    # divergence and DSS act per level on (u2d*fk, v2d*fk)*dp0 =
    # fk(k)*dp0(k) * div(u2d, v2d): only the 2D fields need storing
    dp0 = np.asarray(m.hv.dp0, np.float64)
    sp16 = m.spheremp.reshape(E, 16, 1)
    rsp16 = m.rspheremp.reshape(E, 16)
    cols = {k: [] for k in ("u2d", "v2d", "fk", "g2d", "gp2d", "prof")}
    tfns = []
    as_f = lambda a: torch.as_tensor(a, dtype=f, device=m.device)  # noqa: E731
    for (u2, v2, fk, tf) in terms:
        vfield = torch.stack([u2.reshape(E, 1, 4, 4), v2.reshape(E, 1, 4, 4)],
                             dim=2).to(f)
        g2d = so.divergence_sphere(vfield, m.deriv, m.Dinv, m.metdet,
                                   m.rmetdet)
        g2d_t = g2d.reshape(E, 1, 16).transpose(1, 2)
        gp2d_t = m.tables.dss_scale_t(g2d_t * sp16, rsp16, plain=plain)
        cols["u2d"].append(as_f(u2))
        cols["v2d"].append(as_f(v2))
        cols["fk"].append(as_f(fk))
        cols["g2d"].append(g2d_t[:, :, 0])
        cols["gp2d"].append(gp2d_t[:, :, 0])
        cols["prof"].append(as_f(fk * dp0))
        tfns.append(tf)
    return WindBasis(**{k: torch.stack(v) for k, v in cols.items()},
                     tfns=tuple(tfns), dp0=as_f(dp0), plain=plain)
