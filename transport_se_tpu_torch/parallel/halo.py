"""Multi-shard domain decomposition: the halo-exchange plan and the
sharded DSS tables.

Port of `transport_se_tpu/parallel/halo.py` (reference:
metagraph_mod.F90:228 `initMetaGraph`, schedule_mod.F90:36 `genEdgeSched`,
bndry_mod.F90:21 `bndry_exchangeV`).  The element axis is cut into
contiguous chunks of the canonical element order, one per shard; the
coupling between shards is a halo of whole elements: each shard receives,
once per exchange, the data of every remote element that shares at least
one GLL point with one of its local elements.

* `ShardPlan` / `build_shard_plan`: the plan, built once on the host in
  numpy, a copy of the JAX builder (tests/test_torch_band.py holds it
  field by field).  All traffic between a shard pair is one message per
  exchange, and the messages are scheduled in rounds (a greedy edge
  colouring of the traffic graph), each a partial permutation.
* `ShardedDssTables`: one shard's view, with the interface of
  `ops/dss.py DssTables` (`dss_sum`, `dss_sum_t`, `dss_scale_t`,
  `dss_scale_minmax_t`, `minmax_prep`, `neighbor_minmax`, `global_min`),
  so `model/core.py` runs unchanged against it, plus `dss_sum_t_split`
  for the gather path's boundary-first split.  Each halo round's
  payload is gathered with `index_select`; the communicator
  (`parallel/comm.py`) takes all rounds of an exchange at once, and what
  arrives is written into the receive slots with `index_copy_`.  Every
  halo slot has exactly one sender, so no slot is summed into: the JAX
  scatter-add of masked zeros would be atomics on a card, and the bits
  must not depend on their order.  The combine runs
  against tables whose partner order is that of the single-device tables,
  so results do not depend on the shard count.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..ops import band as bk
from ..ops import dss_face as fk


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Host-side description of the decomposition (numpy arrays).

    All `[S, ...]` arrays hold one row per shard.
    """
    nshards: int
    eloc: int                 # elements per shard
    nhalo: int                # max halo elements over shards (padded size)
    nrounds: int              # exchange rounds (max shard degree)
    maxsend: int              # max elements per message (padded)
    # exchange schedule
    send_peer: np.ndarray     # [S, R] int32 peer shard (or -1: idle round)
    send_elem: np.ndarray     # [S, R, C] int32 local element idx to send
    send_mask: np.ndarray     # [S, R, C] bool
    recv_slot: np.ndarray     # [S, R, C] int32 halo slot for received elems
    recv_mask: np.ndarray     # [S, R, C] bool
    perms: tuple              # tuple over rounds of ((src,dst), ...) pairs
    # local tables against the extended (local + halo) element array
    part_idx: np.ndarray      # [S, eloc*16, 3] int32 into (eloc+nhalo)*16
    part_mask: np.ndarray     # [S, eloc*16, 3] bool
    nbr: np.ndarray           # [S, eloc, 9] int32 into eloc+nhalo
    # boundary-first ordering (overlap mode; identity otherwise)
    perm: np.ndarray = None   # [E] int64: new global order -> original id
    nbound: int = 0           # static boundary-group size per shard
    # halo membership (global element ids per halo slot; face-DSS builder)
    halo_gid: np.ndarray = None   # [S, nhalo] int64 (-1 = unused slot)
    # boundary GROUP without reordering (face+overlap composition): local
    # indices of the elements any peer needs, and the send tables remapped
    # to positions within that group — the producer computes the group in
    # a small duplicate kernel and the halo permutes depend only on it
    bidx: np.ndarray = None       # [S, NB] int32 local indices (padded 0)
    bmask: np.ndarray = None      # [S, NB] bool
    send_elem_b: np.ndarray = None  # [S, R, C] int32 into the group


def build_shard_plan(grid, nshards: int, overlap: bool = False) -> ShardPlan:
    """overlap=True reorders each shard's local elements boundary-first
    (elements whose data any other shard needs), exposing a static split
    point `nbound`: the model can then compute the boundary elements,
    START the halo permutes, and compute the interior while the payload
    is in flight — the cuda_mod.F90:932-1009 comm/compute overlap, XLA
    style (the scheduler hoists the collective between the two kernel
    calls).  `perm` maps new global order -> original element ids."""
    E = grid.nelem
    if E % nshards != 0:
        raise ValueError(f"nelem {E} not divisible by {nshards} shards")
    eloc = E // nshards
    shard_of = np.arange(E) // eloc

    if overlap:
        sent: list[set] = [set() for _ in range(nshards)]
        for e in range(E):
            s = shard_of[e]
            for n in grid.nbr[e]:
                if shard_of[n] != s:
                    sent[s].add(e)
        perm = np.empty(E, dtype=np.int64)
        local_of = np.empty(E, dtype=np.int64)
        nbound = 0
        for s in range(nshards):
            base = s * eloc
            mine = list(range(base, base + eloc))
            b = sorted(e for e in mine if e in sent[s])
            i = sorted(e for e in mine if e not in sent[s])
            nbound = max(nbound, len(b))
            for pos, e in enumerate(b + i):
                perm[base + pos] = e
                local_of[e] = pos
    else:
        perm = np.arange(E, dtype=np.int64)
        local_of = np.arange(E) % eloc
        nbound = 0

    # halo sets per shard, ordered by global element id (determinism)
    halos = []
    for s in range(nshards):
        h = set()
        for e in range(s * eloc, (s + 1) * eloc):
            for n in grid.nbr[e]:
                if shard_of[n] != s:
                    h.add(int(n))
        halos.append(sorted(h))
    nhalo = max((len(h) for h in halos), default=0)
    nhalo = max(nhalo, 1)

    # halo position lookup: halo_pos[s][global_e] -> slot
    halo_pos = [dict((e, i) for i, e in enumerate(h)) for h in halos]

    # traffic: src shard -> dst shard carries elements sorted by global id
    traffic = {}
    for d in range(nshards):
        for e in halos[d]:
            traffic.setdefault((int(shard_of[e]), d), []).append(e)

    # greedy edge coloring into rounds: each round a partial permutation
    pairs = sorted(traffic.keys())
    rounds: list[list] = []
    for (s, d) in pairs:
        placed = False
        for r in rounds:
            if all(ss != s and dd != d for ss, dd in r):
                r.append((s, d))
                placed = True
                break
        if not placed:
            rounds.append([(s, d)])
    nrounds = len(rounds)   # 0 when there is no cross-shard traffic (S=1)
    maxsend = max((len(v) for v in traffic.values()), default=1)

    send_peer = np.full((nshards, nrounds), -1, np.int32)
    send_elem = np.zeros((nshards, nrounds, maxsend), np.int32)
    send_mask = np.zeros((nshards, nrounds, maxsend), bool)
    recv_slot = np.zeros((nshards, nrounds, maxsend), np.int32)
    recv_mask = np.zeros((nshards, nrounds, maxsend), bool)
    perms = []
    for r, pr in enumerate(rounds):
        perms.append(tuple(pr))
        for (s, d) in pr:
            elems = traffic[(s, d)]
            send_peer[s, r] = d
            for c, e in enumerate(elems):
                send_elem[s, r, c] = local_of[e]
                send_mask[s, r, c] = True
                recv_slot[d, r, c] = halo_pos[d][e]
                recv_mask[d, r, c] = True

    # extended tables: remap global partner/neighbor ids to local/halo ids
    def ext_id(s, e):
        if shard_of[e] == s:
            return local_of[e]
        return eloc + halo_pos[s][int(e)]

    part_idx = np.zeros((nshards, eloc * 16, 3), np.int32)
    part_mask = np.zeros((nshards, eloc * 16, 3), bool)
    nbr = np.zeros((nshards, eloc, 9), np.int32)
    for s in range(nshards):
        base = s * eloc
        for ge in range(base, base + eloc):
            el = int(local_of[ge])
            for k in range(9):
                nbr[s, el, k] = ext_id(s, int(grid.nbr[ge, k]))
            for slot in range(16):
                gf = ge * 16 + slot
                lf = el * 16 + slot
                for c in range(3):
                    if grid.part_mask[gf, c]:
                        pg = int(grid.part_idx[gf, c])
                        pe, ps_ = divmod(pg, 16)
                        part_idx[s, lf, c] = ext_id(s, pe) * 16 + ps_
                        part_mask[s, lf, c] = True
                    else:
                        part_idx[s, lf, c] = lf
    halo_gid = np.full((nshards, nhalo), -1, np.int64)
    for s in range(nshards):
        for i, e in enumerate(halos[s]):
            halo_gid[s, i] = e

    # boundary GROUP tables (face+overlap composition, raster order kept):
    # the union of each shard's send sets, as local indices, plus the send
    # tables remapped to group positions.  Built for every plan (cheap);
    # only the face+overlap pipeline consumes them.
    bsets = [sorted({int(send_elem[s, r, c])
                     for r in range(nrounds) for c in range(maxsend)
                     if send_mask[s, r, c]}) for s in range(nshards)]
    NB = max((len(b) for b in bsets), default=0)
    NB = max(NB, 1)
    bidx = np.zeros((nshards, NB), np.int32)
    bmask = np.zeros((nshards, NB), bool)
    send_elem_b = np.zeros_like(send_elem)
    for s in range(nshards):
        pos = {}
        for i, e in enumerate(bsets[s]):
            bidx[s, i] = e
            bmask[s, i] = True
            pos[e] = i
        for r in range(nrounds):
            for c in range(maxsend):
                if send_mask[s, r, c]:
                    send_elem_b[s, r, c] = pos[int(send_elem[s, r, c])]
    return ShardPlan(nshards=nshards, eloc=eloc, nhalo=nhalo,
                     nrounds=nrounds, maxsend=maxsend,
                     send_peer=send_peer, send_elem=send_elem,
                     send_mask=send_mask, recv_slot=recv_slot,
                     recv_mask=recv_mask, perms=tuple(perms),
                     part_idx=part_idx, part_mask=part_mask, nbr=nbr,
                     perm=perm, nbound=nbound, halo_gid=halo_gid,
                     bidx=bidx, bmask=bmask, send_elem_b=send_elem_b)

# ---------------------------------------------------------------------------
# one shard's tables on the device
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HaloRound:
    """One exchange round of one shard: send the local elements `send_idx`
    (or the boundary-group positions `send_idx_b`) to shard `dst`, receive
    from shard `src` into the halo slots `recv_slot` (-1: no peer)."""
    dst: int
    src: int
    send_idx: torch.Tensor            # [n_send] int64
    recv_slot: torch.Tensor           # [n_recv] int64
    send_idx_b: torch.Tensor          # [n_send] int64


def shard_rounds(plan: ShardPlan, s: int, device) -> tuple:
    """Shard s's HaloRounds, each table compacted to its valid entries."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)
    out = []
    for r, pairs in enumerate(plan.perms):
        src = [a for a, b in pairs if b == s]
        sm, rm = plan.send_mask[s, r], plan.recv_mask[s, r]
        out.append(HaloRound(
            dst=int(plan.send_peer[s, r]), src=src[0] if src else -1,
            send_idx=t(plan.send_elem[s, r][sm]),
            recv_slot=t(plan.recv_slot[s, r][rm]),
            send_idx_b=t(plan.send_elem_b[s, r][sm])))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardedDssTables:
    """Shard `rank`'s DSS tables: the interface of ops/dss.py DssTables.

    part_idx/part_mask [eloc*16, 3] (int64 flat slots into the extended
    array cat([local, halo]), bool) and nbr [eloc, 9] (int64 into the
    extended elements) are the single-device tables remapped; `face`
    (parallel/face_sharded.py ShardedFaceTables) routes every assembly
    through the banded face DSS K7 (ops/band.py) instead of the partner
    gathers.  bidx: the boundary group (the local elements some peer
    needs), whose duplicate the core computes as the halo payload when
    overlap_face is set.  nbound: the plan's boundary-first split point
    (0 unless the gather path's overlap order is on), at which the core
    splits each stage.  Every method takes `plain` (the kernels' plain
    versions, as DssTables)."""
    comm: Any
    rank: int
    eloc: int
    nhalo: int
    rounds: tuple
    part_idx: torch.Tensor
    part_mask: torch.Tensor
    nbr: torch.Tensor
    face: Any = None
    bidx: Optional[torch.Tensor] = None
    overlap_face: bool = False
    nbound: int = 0

    @staticmethod
    def build(plan: ShardPlan, rank: int, comm, device, face=None,
              overlap_face: bool = False) -> "ShardedDssTables":
        def t(a, dt):
            return torch.as_tensor(np.asarray(a, dt), device=device)
        bidx = t(plan.bidx[rank][plan.bmask[rank]], np.int64)
        return ShardedDssTables(
            comm=comm, rank=rank, eloc=plan.eloc, nhalo=plan.nhalo,
            rounds=shard_rounds(plan, rank, device),
            part_idx=t(plan.part_idx[rank], np.int64),
            part_mask=t(plan.part_mask[rank], np.bool_),
            nbr=t(plan.nbr[rank], np.int64), face=face, bidx=bidx,
            overlap_face=overlap_face, nbound=plan.nbound)

    # -- halo exchange of whole-element slabs ------------------------------
    def halo(self, x, xb=None):
        """The halo [nhalo, ...] of the local field x [eloc, ...]: the rows
        of the remote elements, slot by slot (unused slots stay zero).
        xb: the boundary group's duplicate [NB, ...], sent in place of x."""
        return self.halo_start(x, xb)()

    def halo_start(self, x, xb=None):
        """halo(x, xb), started: sends the payload and returns finish(),
        which gives the halo.  Only the sent rows are read, so in
        boundary-first order x may be the boundary group alone."""
        sends = [(rnd.dst, xb.index_select(0, rnd.send_idx_b)
                  if xb is not None else x.index_select(0, rnd.send_idx))
                 for rnd in self.rounds if rnd.dst >= 0]
        recv = [rnd for rnd in self.rounds if rnd.src >= 0]
        pending = self.comm.exchange_start(
            self.rank, sends, [(r.src, r.recv_slot.numel()) for r in recv],
            x)

        def finish():
            out = x.new_zeros((self.nhalo,) + tuple(x.shape[1:]))
            for rnd, g in zip(recv, pending()):
                out.index_copy_(0, rnd.recv_slot, g)
            return out
        return finish

    def halo_extend(self, x):
        """x [eloc, ...] -> cat([x, halo]) [eloc+nhalo, ...]."""
        return torch.cat([x, self.halo(x)])

    # -- the combines of ops/dss.py ----------------------------------------
    def dss_sum(self, x, plain=False):
        """DSS of a std-layout field x [eloc, B..., n, n] (through the
        T-layout assembly)."""
        E = x.shape[0]
        x_t = x.reshape(E, -1, 16).transpose(1, 2).contiguous()
        out = self.dss_sum_t(x_t, plain=plain)
        return out.transpose(1, 2).contiguous().reshape(x.shape)

    def dss_sum_t(self, x_t, xb=None, plain=False):
        """out[p] = x[p] + the coincident slots of x, local or remote."""
        halo = self.halo(x_t, xb)
        if self.face is not None:
            return _band(plain)(x_t, halo, self.face)
        return self._dss_from(x_t, halo)

    def dss_sum_t_split(self, xb, xi, pending):
        """dss_sum_t of cat([xb, xi]) on a shard in boundary-first order
        (JAX halo.py:333-339).  pending: halo_start(xb), the halo rounds of
        the boundary group xb [nbound, 16, B] alone, started before the
        interior xi was computed."""
        return self._dss_from(torch.cat([xb, xi]), pending())

    def _dss_from(self, x_t, halo):
        """The gather assembly of x_t [eloc, 16, B] with its halo."""
        E, nn, B = x_t.shape
        xe = torch.cat([x_t, halo]).reshape(-1, B)
        contrib = None
        for s in range(self.part_idx.shape[1]):
            c = torch.where(self.part_mask[:, s, None],
                            xe.index_select(0, self.part_idx[:, s]), 0.0)
            contrib = c if contrib is None else contrib + c
        return (xe[:E * nn] + contrib).reshape(x_t.shape)

    def dss_scale_t(self, x_t, rsp, avg=None, xb=None, plain=False):
        """rsp * DSS(x_t), rsp [eloc, 16]; avg: the fused qdp_time_avg
        (avg + 2*out)/3, times 1/3 on the face path as K4 and the JAX band
        path evaluate it."""
        if self.face is not None:
            out = _band(plain)(x_t, self.halo(x_t, xb), self.face, rsp=rsp)
            return out if avg is None else (avg + 2.0 * out) * (1.0 / 3.0)
        out = self.dss_sum_t(x_t, xb=xb) * rsp[:, :, None]
        return out if avg is None else (avg + 2.0 * out) / 3.0

    def dss_scale_minmax_t(self, x_t, rsp, dp, nq, avg=None, lap=False,
                           xb=None, plain=False):
        """rsp*DSS(x_t) (+ the time average) and the next stage's bound
        prep -> (out, qmin, qmax, lap).  On the face path without avg the
        epilogues run fused in K7 (lap: also the weak Laplacian of out/dp);
        with avg the bounds belong to the averaged field, so K5 follows
        (JAX halo.py:378-397).  The gather path returns lap None: its
        caller runs the weak-Laplacian kernel, as on one device."""
        if self.face is not None and avg is None:
            r = _band(plain)(x_t, self.halo(x_t, xb), self.face, rsp=rsp,
                             dp=dp, nq=nq, lap=lap)
            return r if lap else r + (None,)
        out = self.dss_scale_t(x_t, rsp, avg=avg, xb=xb, plain=plain)
        qmn, qmx = self.minmax_prep(out, dp, nq, plain=plain)
        return out, qmn, qmx, None

    def minmax_prep(self, x_t, dp, nq, plain=False):
        """Per-element min/max over points of x_t/dp: element-local, so the
        face path runs the single-device kernel K5 unchanged."""
        if self.face is not None:
            fn = fk.minmax_prep_plain if plain else fk.minmax_prep
            return fn(x_t, dp, nq)
        return fk._q_minmax(x_t, dp, nq)

    def neighbor_minmax(self, qmin, qmax, plain=False):
        """Min/max over each element and its (up to 8) neighbours, local or
        in the halo; qmin/qmax [eloc, ...] travel in one exchange."""
        q = self.halo_extend(torch.stack([qmin, qmax], dim=1))[self.nbr]
        return q[:, :, 0].amin(dim=1), q[:, :, 1].amax(dim=1)

    def global_min(self, x):
        return self.comm.min(self.rank, x)


def _band(plain):
    return bk.dss_band_plain if plain else bk.dss_band
