"""Runtime diagnostics: global tracer mass, variance and extrema, the
startup self-checks, and the history's flow fields.

Port of `transport_se_tpu/diagnostics.py` (reference:
prim_state_mod.F90:73 `prim_printstate`, the "Q, Q diss, dQ^2/dt" line at
:381, and :573 `prim_diag_scalars`; global_norms_mod.F90:39 global
integral, :96 `test_global_integral`, :232 `print_cfl`).  The f64 global
integral goes through `utils.repro_sum`, whose sum is the same in any
order and on any device; the extrema are exact.  Values computed here
differ from the JAX package's only where the inputs do (for example the
level sums of the column mass, which PyTorch and XLA associate
differently).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .constants import (CP, DD_PI, G, KAPPA, RREARTH,
                                        SCALE_HEIGHT, T0)

from .model import dcmip
from .ops import sphere_ops as so
from .ops.dss import dss_scale
from .utils import repro_sum


def to_numpy(x):
    """A tensor on any device, or an array-like, as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def global_integral(m, h):
    """Area-normalized global integral sum(spheremp*h)/(4*pi) of h [E, n, n]
    (or [E, B..., n, n], one integral per batch entry)."""
    sp = m.spheremp
    nd = h.dim()
    sp = sp.reshape((sp.shape[0],) + (1,) * (nd - 3) + sp.shape[1:])
    return repro_sum(h * sp, axis=(0, -2, -1)) / (4.0 * DD_PI)


def tracer_diagnostics(m, Qdp, Q):
    """Per-tracer (mass, variance, min, max), the prim_diag_scalars set:
    mass(q) = I[sum_k Qdp]/g (kg/m^2), var(q) = I[sum_k Qdp*Q]."""
    col_mass = Qdp.sum(dim=2)             # [E, q, n, n]
    col_var = (Qdp * Q).sum(dim=2)
    mass = global_integral(m, col_mass) / G
    var = global_integral(m, col_var)
    qmin = Q.amin(dim=(0, 2, 3, 4))
    qmax = Q.amax(dim=(0, 2, 3, 4))
    return mass, var, qmin, qmax


def print_cfl(m, cfg, umax: float = 120.0, verbose: bool = True):
    """Startup stability-limit self-check: the advective and hyperviscous dt
    limits from the metric's Dinv pseudo-norm and the published GLL
    derivative eigenvalues (np=4: lambda_max=2.74, lambda_vis=30.0).
    Returns (dt_tracer_limit, dt_hypervis_limit) in seconds."""
    lambda_max = {2: 0.5, 3: 1.5, 4: 2.74}.get(m.grid.np, 0.0)
    lambda_vis = {3: 12.0, 4: 30.0}.get(m.grid.np, 0.0)
    Dinv = to_numpy(m.Dinv).astype(np.float64)     # [E, i, j, 2, 2]
    gx = Dinv[..., 0, :]
    gy = Dinv[..., 1, :]
    norm = np.sqrt((gx * gx).sum(-1) + (gy * gy).sum(-1)
                   + 2.0 * np.abs((gx * gy).sum(-1)))
    max_normDinv = float(norm.max())
    min_gw = float(np.asarray(m.grid.gll_w).min())

    dt_euler = min_gw / (umax * max_normDinv * RREARTH)
    dt_tracer = 1.0 / (umax * max_normDinv * lambda_max * RREARTH)
    normDinv_hypervis = (lambda_vis ** 2) * (RREARTH * max_normDinv) ** 4
    dt_hv = (1.0 / (cfg.nu_q * normDinv_hypervis)
             if cfg.nu_q > 0 else np.inf)
    # subcycled hyperviscosity scales the limit on the full tracer step
    dt_hv = dt_hv * cfg.hypervis_subcycle_q
    if verbose:
        print("CFL estimates in terms of S=time step stability region")
        print(f"SSP preservation (120m/s) RKSSP euler step dt  < S * "
              f"{dt_euler:10.2f} s")
        print(f"Stability: advective (120m/s)   dt_tracer < S * "
              f"{dt_tracer:10.2f} s")
        if cfg.nu_q > 0:
            print(f"Stability: nu_q   hyperviscosity dt < S * {dt_hv:10.2f} s")
    return dt_tracer, dt_hv


def test_global_integral(m) -> float:
    """Sphere-area self-check: the integral of 1 is 4*pi to roundoff.
    Returns the relative error."""
    return abs(float(global_integral(m, torch.ones_like(m.spheremp))) - 1.0)


def print_state(m, Qdp, ps_v, vn0=None):
    """prim_printstate analog: min/max/(area-weighted) mean of the surface
    pressure, the winds and each tracer's Qdp, as text."""
    lines = []

    def stat(name, x, wsum=None):
        x = to_numpy(x)
        s = f"{name:>6}= {x.min(): .15e} {x.max(): .15e}"
        if wsum is not None:
            s += f" {float(wsum): .15e}"
        lines.append(s)

    ps = torch.as_tensor(ps_v, dtype=m.dtype, device=m.device)
    stat("ps", ps, global_integral(m, ps))
    if vn0 is not None:
        v = to_numpy(vn0)
        stat("u", v[:, :, 0])
        stat("v", v[:, :, 1])
    Q = to_numpy(Qdp)
    for q in range(Q.shape[1]):
        stat(f"Q{q+1}dp", Q[:, q])
    return "\n".join(lines)


def energy_diagnostics(m, nstep: int, ps_v=None):
    """Global KE / IE / PE integrals (prim_state_mod.F90:399
    `prim_energy_halftimes`) of the prescribed, isothermal atmosphere;
    monitoring quantities, not a budget.  Returns {"KE", "IE", "PE"}."""
    cfg = m.cfg
    t = max(nstep - 1, 0) * cfg.tstep
    v = dcmip.winds(cfg.test_case, m.lon, m.lat, m.etam, t)  # [E,k,2,n,n]
    dp = m.dp0col[None, :, None, None]
    ke_col = (0.5 * (v[:, :, 0] ** 2 + v[:, :, 1] ** 2) * dp).sum(dim=1)
    ke = float(global_integral(m, ke_col)) / G
    # isothermal atmosphere: IE = cp*T0*M/g; PE from phi = g*H*log(1/eta)
    mass_col = torch.broadcast_to(dp, v[:, :, 0].shape).sum(dim=1)
    ie = CP * T0 * float(global_integral(m, mass_col)) / G
    phi = G * SCALE_HEIGHT * torch.log(1.0 / m.etam)
    pe_col = (phi[None, :, None, None] * dp).sum(dim=1)
    pe = float(global_integral(m, pe_col)) / G
    return {"KE": ke, "IE": ie, "PE": pe}


def flow_fields(m, nstep: int):
    """History flow fields at step `nstep`: winds, C0 vorticity and
    divergence, omega, T, kinetic energy and potential temperature
    (prim_movie_mod.F90:395+).  Under prescribed winds these are analytic
    and assembled, not prognostic.  Returns a dict of numpy arrays
    [E, nlev, n, n]."""
    cfg = m.cfg
    t = max(nstep - 1, 0) * cfg.tstep
    v = dcmip.winds(cfg.test_case, m.lon, m.lat, m.etam, t)  # [E,k,2,n,n]
    zeta = so.vorticity_sphere(v, m.deriv, m.D, m.rmetdet)
    div = so.divergence_sphere(v, m.deriv, m.Dinv, m.metdet, m.rmetdet)
    zeta = dss_scale(zeta, m.spheremp, m.rspheremp, m.tables)
    div = dss_scale(div, m.spheremp, m.rspheremp, m.tables)
    omega = dcmip.eta_dot_dpdn(cfg.test_case, m.lon, m.lat, m.etam, t)
    T = torch.full(zeta.shape, T0, dtype=zeta.dtype, device=zeta.device)
    ke = 0.5 * (v[:, :, 0] ** 2 + v[:, :, 1] ** 2)
    Th = T * (m.etam[None, :, None, None] ** (-KAPPA))
    fields = {"u": v[:, :, 0], "v": v[:, :, 1], "zeta": zeta, "div": div,
              "omega": omega, "T": T, "ke": ke, "Th": Th}
    return {k: to_numpy(x) for k, x in fields.items()}


@dataclasses.dataclass
class StateLog:
    """Accumulates printstate lines; verifies conservation over the run."""
    steps: list = dataclasses.field(default_factory=list)
    masses: list = dataclasses.field(default_factory=list)
    variances: list = dataclasses.field(default_factory=list)

    def record(self, nstep, mass, var, qmin, qmax, dt, verbose=True,
               prev=None):
        """One printstate line per tracer.  `prev` = (mass, var) at the
        diagnosed subcycle's start, so "Q diss" is the change over the
        subcycle per tracer step dt; without prev, the change since the
        previous record."""
        mass = to_numpy(mass)
        var = to_numpy(var)
        if verbose:
            for q in range(mass.size):
                if prev is not None:
                    m0, v0 = to_numpy(prev[0]), to_numpy(prev[1])
                    dm = mass[q] - m0[q]
                    dv = var[q] - v0[q]
                    print(f"Q{q+1},Q diss, dQ^2/dt: {mass[q]:.14E} kg/m^2 "
                          f"{dm/dt:15.7E} {dv/dt:15.7E}")
                elif self.masses:
                    dm = (mass[q] - self.masses[-1][q])
                    dv = (var[q] - self.variances[-1][q])
                    print(f"Q{q+1},Q diss, dQ^2/dt: {mass[q]:.14E} kg/m^2 "
                          f"{dm/dt:15.7E} {dv/dt:15.7E}")
                else:
                    print(f"Q{q+1}: {mass[q]:.14E} kg/m^2  "
                          f"min={to_numpy(qmin)[q]:.6e} "
                          f"max={to_numpy(qmax)[q]:.6e}")
        self.steps.append(int(nstep))
        self.masses.append(mass)
        self.variances.append(var)

    def max_relative_mass_drift(self):
        m = np.asarray(self.masses)
        return float(np.abs((m - m[0]) / m[0]).max())
