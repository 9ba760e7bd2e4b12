"""The sharded subcycle: one program per shard, the element axis cut into
contiguous chunks of the canonical order.

Port of `transport_se_tpu/parallel/sharded.py` (reference: the MPI rank
decomposition of prim_main.F90 + bndry_mod.F90).  Levels and tracers stay
local to a shard.  Each shard runs `model.core.make_subcycle_fn` unchanged
against its slice of the model's element arrays (`core.shard_model`) and
its `ShardedDssTables`, whose halo rounds and global minimum go through a
communicator (`parallel/comm.py`): `ThreadComm` runs the shards as threads
of one process on one device, `DistComm` one shard per process.  Results do
not depend on the shard count (the reference's bit-for-bit-across-task-
counts property, README:46-48): the face path assembles every shard with
the banded face DSS (K7) in one association, the gather path with the
single-device partner order.

The pipeline and its state layout are chosen as on one device: the T
layout [eloc, 16, q*k] for use_pallas with limiter 8 and no diagnostics,
else the std layout [eloc, q, k, 4, 4].  The runner carries that layout as
`io_layout` and converts by it, never by an array's shape.

Overlap (`overlap=True`) has two forms.  On the face path it is the
face+overlap composition (each stage's producer runs once more on the
boundary group, whose result is the halo payload).  On the gather path it
is a boundary-first element order (the plan's `nbound`) with a split stage
(JAX core.py:322-350): K1 runs on the boundary group, the halo exchange of
its output is started, and K1 runs on the interior before the exchange is
waited for, so a communicator that exchanges beside the device (DistComm
over NCCL) hides it behind the interior.  `overlap=None` chooses as the
JAX package does on the face path: on for the T pipeline while the
boundary group is at most 25% of a shard.  It leaves the gather split off,
where the JAX package turns it on: with ThreadComm every shard shares one
stream and nothing can overlap (the split only doubles K1's launches), and
across cards it is not yet measured (ROADMAP A6(b)).
Neither form changes a bit of the result.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..model.core import (Model, _tp, _tp_back, make_subcycle_fn,
                          shard_model, uses_t_layout)
from ..ops.dss_face import build_face_tables
from .face_sharded import (ShardedFaceTables, band_roles,
                           build_sharded_face_tables)
from .halo import ShardedDssTables, ShardPlan, build_shard_plan

__all__ = ["ShardedRunner", "make_sharded_subcycle"]

# auto overlap on the face path: the duplicate boundary-group launch must
# stay small against the full stage (JAX sharded.py:107-118)
OVERLAP_MAX_BOUNDARY = 0.25


@dataclasses.dataclass
class ShardedRunner:
    """The sharded subcycle of a model over a communicator.

    States are lists with one tensor per shard this process hosts
    (comm.ranks), in the runner's io_layout: "t" [eloc, 16, q*k] or "std"
    [eloc, q, k, 4, 4], elements in the plan's order (plan.perm)."""
    model: Model
    comm: Any
    plan: ShardPlan
    io_layout: str
    overlap_face: bool
    inv_perm: np.ndarray
    steps: list               # per hosted shard: fn(state, nstep)

    def shard_qdp(self, Qdp) -> list:
        """Std-layout Qdp [E, q, k, 4, 4] in model order -> the hosted
        shards' states, in the io_layout."""
        m, eloc = self.model, self.plan.eloc
        x = Qdp.index_select(0, torch.as_tensor(self.plan.perm,
                                                device=Qdp.device))
        if self.io_layout == "t":
            x = _tp(x, x.shape[0], m.cfg.qsize * m.cfg.nlev)
        return [x[r * eloc:(r + 1) * eloc].contiguous()
                for r in self.comm.ranks]

    def step(self, states, nstep: int):
        """One subcycle on every hosted shard -> (states', ps_v per shard,
        nstep', min_dp); min_dp is the global minimum over all shards."""
        idx = {r: i for i, r in enumerate(self.comm.ranks)}

        def one(rank):
            i = idx[rank]
            return self.steps[i](states[i], nstep)
        out = self.comm.run(one)
        return ([o[0] for o in out], [o[1] for o in out], out[0][2],
                out[0][3])

    def to_model_order(self, x):
        """An element-indexed array in the plan's order [E, ...] -> model
        order (undoes plan.perm)."""
        return x.index_select(0, torch.as_tensor(self.inv_perm,
                                                 device=x.device))

    def state_to_qdp(self, full):
        """The shards' states joined in rank order (all E elements) ->
        std-layout Qdp [E, q, k, 4, 4] in model order."""
        cfg = self.model.cfg
        E = full.shape[0]
        if self.io_layout == "t":
            full = _tp_back(full, (E, cfg.qsize, cfg.nlev, 4, 4))
        return self.to_model_order(full.contiguous())

    def gather(self, states):
        """Std-layout Qdp in model order from every shard's state; needs
        every shard in this process (ThreadComm; DistComm:
        parallel/multihost.py gather_canonical)."""
        if len(states) != self.plan.nshards:
            raise ValueError(f"{len(states)} of {self.plan.nshards} shards "
                             "here: gather across processes with "
                             "multihost.gather_canonical")
        return self.state_to_qdp(torch.cat(states))


def make_sharded_subcycle(m: Model, comm, diagnostics: bool = False,
                          overlap=None) -> ShardedRunner:
    """The sharded subcycle of m over comm.size shards (see the module
    docstring).  overlap: None (auto), or force the face path's composition
    or the gather path's split on or off."""
    S = comm.size
    cfg = m.cfg
    use_face = cfg.dss_mode == "face"
    t_layout = uses_t_layout(cfg, diagnostics)
    io_layout = "t" if t_layout else "std"
    overlap_auto = overlap is None
    if overlap is None:
        overlap = t_layout and use_face
    plan = build_shard_plan(m.grid, S, overlap=bool(overlap and not use_face))
    overlap_face = bool(overlap and use_face)
    if overlap_face and overlap_auto:
        frac = plan.bmask.sum(axis=1).max() / plan.eloc
        overlap_face = bool(frac <= OVERLAP_MAX_BOUNDARY)
    inv_perm = np.empty_like(plan.perm)
    inv_perm[plan.perm] = np.arange(plan.perm.size)
    dev = m.device
    stack = roles = None
    if use_face:
        g = m.grid
        ftd = build_face_tables(g.part_idx, g.part_mask, cfg.ne)
        stack = build_sharded_face_tables(g, plan, ftd)
        roles = band_roles(plan, ftd, cfg.ne)

    def build(rank):
        eloc = plan.eloc
        elems = torch.as_tensor(plan.perm[rank * eloc:(rank + 1) * eloc],
                                device=dev)
        face = None
        if use_face:
            face = ShardedFaceTables.from_stack(
                stack, roles, rank, plan.nhalo, dev,
                met=m.met.index_select(0, elems), deriv=m.deriv)
        tables = ShardedDssTables.build(plan, rank, comm, dev, face=face,
                                        overlap_face=overlap_face)
        ms = shard_model(m, elems, tables)
        # the T pipeline's wind basis DSSes at build: a collective
        return make_subcycle_fn(ms, diagnostics=diagnostics,
                                io_layout=io_layout)

    return ShardedRunner(model=m, comm=comm, plan=plan, io_layout=io_layout,
                         overlap_face=overlap_face, inv_perm=inv_perm,
                         steps=comm.run(build))
