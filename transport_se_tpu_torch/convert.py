"""Carry a model and tracer state across between numpy and the port.

`model_from_numpy` builds the port's `Model` from the arrays of a model as
numpy (for example the JAX package's `Model` via `np.asarray`), so that the
two packages can run on identical tables and state.  `build_model` builds
its arrays from the grid modules and comes through here too.
"""

from __future__ import annotations

import numpy as np
import torch

from transport_se_tpu.config import Config

from .model.core import Model, hvcoord
from .ops.dss import DssTables
from .ops.euler import metric_pack

MODEL_ARRAYS = ("lon", "lat", "deriv", "D", "Dinv", "metdet", "rmetdet",
                "spheremp", "rspheremp", "etam", "etai", "hyai", "hybi",
                "dp0col", "dp0ref")
TABLE_ARRAYS = ("part_idx", "part_mask", "nbr")


def model_from_numpy(cfg: Config, arrays: dict, device) -> Model:
    """The port's Model from numpy arrays: the MODEL_ARRAYS fields (cast to
    cfg's dtype) and the DssTables' part_idx/part_mask/nbr.  With
    cfg.dss_mode "face" the tables also carry the face tables, built from
    part_idx/part_mask; these must then be a raster-order grid's, as
    Config requires (ValueError otherwise)."""
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
    return Model(cfg=cfg, hv=hvcoord(cfg), tables=tables, met=met, **t)


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

