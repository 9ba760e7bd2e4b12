"""Direct Stiffness Summation (DSS) and neighbor min/max: the gather,
segsum and face modes.

Port of `transport_se_tpu/ops/dss.py` `DssTables` (reference:
edge_mod.F90:366 edgeVpack, :648 edgeVunpack, bndry_mod.F90:21
bndry_exchangeV, viscosity_mod.F90:748 neighbor_minmax).  The T-layout
methods (`*_t`) take fields [E, 16, B]: point axis second, (tracer, level)
lanes minor.  The std-layout methods (`dss_sum`, `neighbor_minmax` on
[E, ...] bounds) take the JAX package's [E, B..., 4, 4] fields; `dss_sum`
runs the T-layout assembly on the transposed field.

* mode "gather": each GLL point has at most 3 coincident partner slots; the
  assembly adds the masked partner values in fixed partner order, which
  makes it bitwise equal to the JAX gather DSS.  Plain PyTorch.
* mode "segsum": every point gets the sum of all the points that share its
  position, added in ascending point order.  The JAX package scatter-adds
  by global point id (`segment_sum`); on a card that is an atomic add in
  an order that changes from run to run, so the port sums each point's
  sorted member list (itself and its partners) instead: every copy of a
  shared point gets the same value, and every run the same bits.  Against
  the JAX segment_sum this agrees to roundoff.  Plain PyTorch.
* mode "face" (elements in raster face order): the face-shift DSS with its
  fused epilogues, the bound prep and the neighbor min/max run the kernels
  of `ops/dss_face.py` (K4, K5, K6).  Every face method takes `plain`:
  True runs the kernels' plain PyTorch versions on any device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import dss_face as fk
from .dss_face import FaceTables

MODES = ("gather", "segsum", "face")


def segsum_members(part_idx, part_mask):
    """Each point's members (itself and its coincident partners) in
    ascending point order -> (members [P, 4] int64, mask [P, 4] bool);
    absent slots hold the point itself, masked off."""
    part_idx = np.asarray(part_idx, np.int64)
    part_mask = np.asarray(part_mask, bool)
    npts, nslot = part_idx.shape
    me = np.arange(npts, dtype=np.int64)[:, None]
    key = np.concatenate([me, np.where(part_mask, part_idx, npts)], axis=1)
    idx = np.concatenate([me, np.where(part_mask, part_idx, me)], axis=1)
    order = np.argsort(key, axis=1, kind="stable")
    return (np.take_along_axis(idx, order, axis=1),
            np.take_along_axis(key, order, axis=1) < npts)


@dataclasses.dataclass(frozen=True)
class DssTables:
    """Assembly tables from grid.cubesphere, on the model's device.

    part_idx [E*16, 3] int64 partner slots, part_mask [E*16, 3] bool,
    nbr [E, 9] int64 neighbor elements (self first, self-padded).  Segsum
    mode adds `seg_idx`/`seg_mask` [E*16, 4] (segsum_members).  Face mode
    adds `face` (FaceTables) and, for the Laplacian epilogue of
    dss_scale_minmax_t, the metric pack `met` [E, 10, 16] and `deriv`."""
    part_idx: torch.Tensor
    part_mask: torch.Tensor
    nbr: torch.Tensor
    mode: str = "gather"
    face: Optional[FaceTables] = None
    met: Optional[torch.Tensor] = None
    deriv: Optional[torch.Tensor] = None
    seg_idx: Optional[torch.Tensor] = None
    seg_mask: Optional[torch.Tensor] = None
    # no halo payload to duplicate on one device (see ShardedDssTables)
    overlap_face = False

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"dss mode {self.mode!r} not in {MODES}")
        if self.mode == "face" and self.face is None:
            raise ValueError("mode 'face' needs its face tables")
        if self.mode == "segsum" and self.seg_idx is None:
            raise ValueError("mode 'segsum' needs its member tables")

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
        seg = {}
        if mode == "segsum":
            mem, mask = segsum_members(part_idx, part_mask)
            seg = dict(seg_idx=t(mem, np.int64), seg_mask=t(mask, np.bool_))
        return DssTables(part_idx=t(part_idx, np.int64),
                         part_mask=t(part_mask, np.bool_),
                         nbr=t(nbr, np.int64), mode=mode, face=face,
                         met=met, deriv=deriv, **seg)

    def dss_sum(self, x, plain=False):
        """DSS of a std-layout field x [E, B..., n, n] (through the T-layout
        assembly of the mode)."""
        E = x.shape[0]
        x_t = x.reshape(E, -1, 16).transpose(1, 2).contiguous()
        out = self.dss_sum_t(x_t, plain=plain)
        return out.transpose(1, 2).contiguous().reshape(x.shape)

    def dss_sum_t(self, x_t, plain=False):
        """out[p] = x[p] + sum of x over the slots coincident with p (in
        segsum mode: the sum over p's members in ascending point order)."""
        if self.mode == "face":
            fn = fk.dss_face_plain if plain else fk.dss_face
            return fn(x_t, self.face)
        E, nn, B = x_t.shape
        xf = x_t.reshape(E * nn, B)
        if self.mode == "segsum":
            acc = xf.index_select(0, self.seg_idx[:, 0])
            for s in range(1, self.seg_idx.shape[1]):
                acc = acc + torch.where(
                    self.seg_mask[:, s, None],
                    xf.index_select(0, self.seg_idx[:, s]), 0.0)
            return acc.reshape(x_t.shape)
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
        """Min/max over each element and its (up to 8) neighbors; qmin/qmax
        [E, ...] (face mode runs K6 on them as [E, B])."""
        if self.mode == "face":
            fn = fk.neighbor_minmax_plain if plain else fk.neighbor_minmax
            E, shape = qmin.shape[0], qmin.shape
            gmin, gmax = fn(qmin.reshape(E, -1).contiguous(),
                            qmax.reshape(E, -1).contiguous(), self.face)
            return gmin.reshape(shape), gmax.reshape(shape)
        return (qmin[self.nbr].amin(dim=1), qmax[self.nbr].amax(dim=1))

    def global_min(self, x):
        return x.min()


def dss_scale(x, spheremp, rspheremp, tables: DssTables, plain=False):
    """The assembled projection rspheremp * DSS(spheremp * x) of a
    std-layout field [E, B..., n, n] (make_C0, viscosity_mod.F90:445)."""
    nd = x.dim()
    sp = spheremp.reshape(spheremp.shape[:1] + (1,) * (nd - 3)
                          + spheremp.shape[1:])
    return dss_scale_pre(x * sp, rspheremp.reshape(sp.shape), tables, plain)


def dss_scale_pre(xw, rsp, tables: DssTables, plain=False):
    return tables.dss_sum(xw, plain=plain) * rsp


def neighbor_minmax(qmin, qmax, tables: DssTables, plain=False):
    """Min/max over each element and its (up to 8) point-sharing
    neighbors; qmin/qmax [E, batch...]."""
    return tables.neighbor_minmax(qmin, qmax, plain=plain)
