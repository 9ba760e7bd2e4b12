"""DCMIP error norms — exact port of the reference's offline NCL analysis.

The port's own copy of `transport_se_tpu/norms.py` (numpy only), kept
bit-identical to it (tests/test_torch_host.py), plus `history_norms`, the
norms of a run's history file.

The published verification numbers (BASELINE.md) come from
test/dcmip1-1/dcmip1-1_error_norm_ng.ncl:13-78 and the dcmip1-2 twin, which
compute volume-weighted L1/L2/Linf of (final - initial) tracer fields over
the *unique* GLL columns with APPROXIMATE equal-angle column volumes:

    dlat = dlon = 0.5*pi / (ne*(np-1))
    dx = R_ncl * cos(lat) * dlon ;  dy = R_ncl * dlat
    dh reconstructed from midpoint heights assuming the bottom is at z=0
    dV = dx*dy*dh

Quirks preserved because the graded numbers embed them:
* R_ncl = 6.37122e6 (the NCL script's own earth radius — NOT the model's
  6.376e6; it cancels in the ratios anyway);
* avg(q_i) is the unweighted arithmetic mean over all (lev, col) points;
* Linf is max(|dq|*dV)/max(|q_i-avg|*dV) — with dV *inside* the max;
* dcmip1-1 grades tracer 1 (Q, cosine bells); dcmip1-2 grades tracer 2
  (Q2, the Hadley layer).
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.io import netcdf_file

from .constants import DD_PI, SCALE_HEIGHT

__all__ = ["ErrorNorms", "dcmip_error_norms", "grade_tracer",
           "history_norms", "unique_columns"]


@dataclasses.dataclass(frozen=True)
class ErrorNorms:
    l1: float
    l2: float
    linf: float
    q_max: float
    q_min: float

    def __str__(self):
        return (f"L1={self.l1:8.6f} L2={self.l2:8.6f} Linf={self.linf:8.6f} "
                f"q_max={self.q_max:8.6f} q_min={self.q_min:14.6e}")


def level_thickness_from_heights(zm: np.ndarray) -> np.ndarray:
    """Reconstruct layer thickness from midpoint heights, bottom at z=0
    (dcmip1-1_error_norm_ng.ncl:46-57).  zm[0] = top level."""
    nlev = zm.size
    dh = np.zeros(nlev)
    base = 0.0
    for i in range(1, nlev + 1):
        dh[nlev - i] = 2.0 * (zm[nlev - i] - base)
        base += dh[nlev - i]
    return dh


def dcmip_error_norms(q_init: np.ndarray, q_final: np.ndarray,
                      lat_col: np.ndarray, zm: np.ndarray,
                      ne: int, npts: int = 4) -> ErrorNorms:
    """q_init/q_final: [nlev, ncol]; lat_col: [ncol]; zm: [nlev] midpoint z."""
    R = 6.37122e6
    dlat = 0.5 * DD_PI / (ne * (npts - 1))
    dlon = dlat
    dh = level_thickness_from_heights(zm)
    dx = R * np.cos(lat_col)[None, :] * dlon
    dy = R * dlat
    dV = dx * dy * dh[:, None]

    dq = q_final - q_init
    qa = q_init - q_init.mean()
    l1 = np.sum(np.abs(dq) * dV) / np.sum(np.abs(qa) * dV)
    l2 = np.sqrt(np.sum(dq * dq * dV)) / np.sqrt(np.sum(qa * qa * dV))
    linf = np.max(np.abs(dq) * dV) / np.max(np.abs(qa) * dV)
    return ErrorNorms(l1=float(l1), l2=float(l2), linf=float(linf),
                      q_max=float(q_final.max()), q_min=float(q_final.min()))


def unique_columns(grid, field_eqkij: np.ndarray, tracer: int) -> np.ndarray:
    """Extract [nlev, ncol] from a [E, q, k, np, np] field using the grid's
    unique-point ownership (dof_mod UniquePoints analog)."""
    k = field_eqkij.shape[2]
    flat = np.moveaxis(field_eqkij[:, tracer], 1, -1).reshape(-1, k)
    # flat index order: e*16 + i*4 + j must match grid.uniq_src convention
    return flat[grid.uniq_src].T.copy()


def grade_tracer(test_case: str) -> int:
    """0-based index of the tracer the NCL scripts grade."""
    return 0 if test_case == "dcmip1-1" else 1


def history_norms(path: str, test_case: str, ne: int) -> ErrorNorms:
    """Norms of the graded tracer (Q for dcmip1-1, Q2 for dcmip1-2) between
    the first (t=0) and the last record of the history file at `path`.
    The column latitudes and level heights come from the file's lat (deg)
    and lev (1000*eta) variables."""
    tr = grade_tracer(test_case)
    name = "Q" if tr == 0 else f"Q{tr + 1}"
    with netcdf_file(path, "r", mmap=False) as f:
        q = f.variables[name][:].copy()            # [time, lev, ncol]
        lat = np.deg2rad(f.variables["lat"][:].copy())
        etam = f.variables["lev"][:].copy() / 1000.0
    if q.shape[0] < 2:
        raise ValueError(f"{path}: {q.shape[0]} record(s); the norms need "
                         "the t=0 record and a final one")
    zm = SCALE_HEIGHT * np.log(1.0 / etam)
    return dcmip_error_norms(q[0], q[-1], lat, zm, ne=ne)
