"""Direct Stiffness Summation (DSS) and neighbor min/max: the gather and
face modes.

Port of `transport_se_tpu/ops/dss.py` `DssTables` (reference:
edge_mod.F90:366 edgeVpack, :648 edgeVunpack, bndry_mod.F90:21
bndry_exchangeV, viscosity_mod.F90:748 neighbor_minmax).  Fields are in the
T layout [E, 16, B]: point axis second, (tracer, level) lanes minor.

* mode "gather": each GLL point has at most 3 coincident partner slots; the
  assembly adds the masked partner values in fixed partner order, which
  makes it bitwise equal to the JAX gather DSS.  Plain PyTorch.
* mode "face" (elements in raster face order): the face-shift DSS with its
  fused epilogues, the bound prep and the neighbor min/max run the kernels
  of `ops/dss_face.py` (K4, K5, K6).  Every face method takes `plain`:
  True runs the kernels' plain PyTorch versions on any device.

The segsum mode of the JAX package is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import dss_face as fk
from .dss_face import FaceTables

_NOT_PORTED = ("DSS mode {!r} is not ported to transport_se_tpu_torch yet "
               "(ROADMAP.md A5, the std-layout path); use dss_mode='face' "
               "or 'gather'")


@dataclasses.dataclass(frozen=True)
class DssTables:
    """Assembly tables from grid.cubesphere, on the model's device.

    part_idx [E*16, 3] int64 partner slots, part_mask [E*16, 3] bool,
    nbr [E, 9] int64 neighbor elements (self first, self-padded).  Face
    mode adds `face` (FaceTables) and, for the Laplacian epilogue of
    dss_scale_minmax_t, the metric pack `met` [E, 10, 16] and `deriv`."""
    part_idx: torch.Tensor
    part_mask: torch.Tensor
    nbr: torch.Tensor
    mode: str = "gather"
    face: Optional[FaceTables] = None
    met: Optional[torch.Tensor] = None
    deriv: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.mode not in ("gather", "face"):
            raise NotImplementedError(_NOT_PORTED.format(self.mode))
        if self.mode == "face" and self.face is None:
            raise ValueError("mode 'face' needs its face tables")

    @staticmethod
    def from_numpy(part_idx, part_mask, nbr, device, mode: str = "gather",
                   ne: int = 0, met=None, deriv=None) -> "DssTables":
        """The tables of a grid as numpy; face mode builds the FaceTables
        of the ne grid from part_idx/part_mask (raster order, else
        ValueError)."""
        def t(a, dt):
            return torch.as_tensor(np.array(a, dtype=dt), device=device)
        face = (FaceTables.from_grid(part_idx, part_mask, ne, device)
                if mode == "face" else None)
        return DssTables(part_idx=t(part_idx, np.int64),
                         part_mask=t(part_mask, np.bool_),
                         nbr=t(nbr, np.int64), mode=mode, face=face,
                         met=met, deriv=deriv)

    def dss_sum_t(self, x_t, plain=False):
        """out[p] = x[p] + sum of x over the slots coincident with p."""
        if self.mode == "face":
            fn = fk.dss_face_plain if plain else fk.dss_face
            return fn(x_t, self.face)
        E, nn, B = x_t.shape
        xf = x_t.reshape(E * nn, B)
        contrib = None
        for s in range(self.part_idx.shape[1]):
            c = torch.where(self.part_mask[:, s, None],
                            xf.index_select(0, self.part_idx[:, s]), 0.0)
            contrib = c if contrib is None else contrib + c
        return (xf + contrib).reshape(x_t.shape)

    def dss_scale_t(self, x_t, rsp, avg=None, plain=False):
        """rsp * DSS(x_t); rsp [E, 16].  avg: the fused qdp_time_avg,
        out = (avg + 2*rsp*DSS(x_t))/3 (prim_advection_mod.F90:645-662)."""
        if self.mode == "face":
            fn = fk.dss_face_plain if plain else fk.dss_face
            return fn(x_t, self.face, rsp=rsp, avg=avg)
        out = self.dss_sum_t(x_t) * rsp[:, :, None]
        if avg is not None:
            out = (avg + 2.0 * out) / 3.0
        return out

    def dss_scale_minmax_t(self, x_t, rsp, dp, nq, avg=None, lap=False,
                           plain=False):
        """rsp*DSS(x_t) (with the fused time average given avg) plus the
        next stage's limiter-bound prep -> (out, qmin, qmax, lap):
        qmin/qmax [E, q*k] are the min/max over the 16 points of out/dp
        (dp [E,16,nlev] broadcast over tracers).  lap=True: face mode also
        returns the weak Laplacian of out/dp, the biharmonic stage's first
        Laplacian; the gather mode returns None there and its caller runs
        the weak-Laplacian kernel instead, as the JAX gather mode does."""
        if self.mode == "face":
            fn = fk.dss_face_plain if plain else fk.dss_face
            r = fn(x_t, self.face, rsp=rsp, avg=avg, dp=dp,
                   met=self.met if lap else None,
                   deriv=self.deriv if lap else None)
            return r if lap else r + (None,)
        out = self.dss_scale_t(x_t, rsp, avg=avg)
        qmn, qmx = self.minmax_prep(out, dp, nq)
        return out, qmn, qmx, None

    def minmax_prep(self, x_t, dp, nq, plain=False):
        """Per-element min/max over points of Q = x_t/dp -> ([E,B], [E,B])."""
        if self.mode == "face":
            fn = fk.minmax_prep_plain if plain else fk.minmax_prep
            return fn(x_t, dp, nq)
        return fk._q_minmax(x_t, dp, nq)

    def neighbor_minmax(self, qmin, qmax, plain=False):
        """Min/max over each element and its (up to 8) neighbors."""
        if self.mode == "face":
            fn = fk.neighbor_minmax_plain if plain else fk.neighbor_minmax
            return fn(qmin, qmax, self.face)
        return (qmin[self.nbr].amin(dim=1), qmax[self.nbr].amax(dim=1))

    def global_min(self, x):
        return x.min()
