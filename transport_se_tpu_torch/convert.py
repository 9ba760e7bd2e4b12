"""Carry a model and tracer state across between numpy and the port.

`model_from_numpy` builds the port's `Model` from the arrays of a model as
numpy (for example the JAX package's `Model` via `np.asarray`), so that the
two packages can run on identical tables and state.  `build_model` builds
its arrays from the grid modules and comes through here too.  The state
converters take the T layout [E, 16, q*k] (`state_*`) or the std layout
Qdp [E, q, k, 4, 4] (`qdp_*`).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import Config
from .grid.cubesphere import build_grid
from .model.core import Model, check_config, hvcoord
from .ops.dss import DssTables
from .ops.euler import metric_pack

MODEL_ARRAYS = ("lon", "lat", "deriv", "D", "Dinv", "metdet", "rmetdet",
                "spheremp", "rspheremp", "etam", "etai", "hyai", "hybi",
                "dp0col", "dp0ref")
TABLE_ARRAYS = ("part_idx", "part_mask", "nbr")


def model_from_numpy(cfg: Config, arrays: dict, device, grid=None) -> Model:
    """The port's Model from numpy arrays: the MODEL_ARRAYS fields (cast to
    cfg's dtype) and the DssTables' part_idx/part_mask/nbr.  With
    cfg.dss_mode "face" the tables also carry the face tables, built from
    part_idx/part_mask; these must then be a raster-order grid's, as
    Config requires (ValueError otherwise).  grid is the host-side Grid
    the arrays came from (the history writer and the CFL check read it);
    None builds cfg's."""
    check_config(cfg)
    missing = [k for k in MODEL_ARRAYS + TABLE_ARRAYS if k not in arrays]
    if missing:
        raise KeyError(f"model arrays missing: {missing}")
    dt = cfg.np_dtype
    t = {k: torch.as_tensor(np.array(arrays[k], dtype=dt), device=device)
         for k in MODEL_ARRAYS}
    met = metric_pack(t["Dinv"], t["metdet"], t["rmetdet"], t["spheremp"])
    tables = DssTables.from_numpy(
        np.asarray(arrays["part_idx"]), np.asarray(arrays["part_mask"]),
        np.asarray(arrays["nbr"]), device, mode=cfg.dss_mode, ne=cfg.ne,
        met=met, deriv=t["deriv"])
    if grid is None:
        grid = build_grid(cfg.ne, order=cfg.elem_order)
    return Model(cfg=cfg, grid=grid, hv=hvcoord(cfg), tables=tables,
                 met=met, **t)


def state_from_numpy(qt: np.ndarray, device, dtype=None) -> torch.Tensor:
    """T-layout tracer state [E, 16, q*k] -> contiguous tensor."""
    qt = np.asarray(qt)
    if qt.ndim != 3 or qt.shape[1] != 16:
        raise ValueError(f"expected [E, 16, q*k], got {qt.shape}")
    return torch.as_tensor(np.array(qt, order="C"), dtype=dtype,
                           device=device)


def state_to_numpy(qt: torch.Tensor) -> np.ndarray:
    """T-layout tracer state tensor -> numpy [E, 16, q*k]."""
    if qt.dim() != 3 or qt.shape[1] != 16:
        raise ValueError(f"expected [E, 16, q*k], got {tuple(qt.shape)}")
    return qt.detach().cpu().numpy()


def qdp_from_numpy(qdp: np.ndarray, device, dtype=None) -> torch.Tensor:
    """Std-layout tracer mass Qdp [E, q, k, 4, 4] -> contiguous tensor."""
    qdp = np.asarray(qdp)
    if qdp.ndim != 5 or qdp.shape[-2:] != (4, 4):
        raise ValueError(f"expected [E, q, k, 4, 4], got {qdp.shape}")
    return torch.as_tensor(np.array(qdp, order="C"), dtype=dtype,
                           device=device)


def qdp_to_numpy(qdp: torch.Tensor) -> np.ndarray:
    """Std-layout tracer mass tensor -> numpy [E, q, k, 4, 4]."""
    if qdp.dim() != 5 or tuple(qdp.shape[-2:]) != (4, 4):
        raise ValueError(f"expected [E, q, k, 4, 4], got {tuple(qdp.shape)}")
    return qdp.detach().cpu().numpy()
