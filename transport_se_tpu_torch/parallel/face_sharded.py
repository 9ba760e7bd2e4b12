"""Sharded face-shift DSS: the banded assembly of one shard.

Port of `transport_se_tpu/parallel/face_sharded.py`.  Elements are cut
into contiguous chunks of the raster face order (index = face*ne^2 +
ey*ne + ex), so a chunk boundary may cut a row of elements.  Each shard
sees a row-aligned band of whole element rows around its chunk, one ghost
row above and below included: `head`/`tail` are small gathers from the
halo-extended array ext = cat([x, halo]) (the whole-element halo of
parallel/halo.py delivers every point-sharing remote element), and
`band_o` is the shard's row-alignment offset.  On the band the DSS is the
shifted-slice assembly of ops/dss_face.py: +-x partners are in-row shifts
with seam ghost columns, +-y partners row shifts masked at face
transitions with the y-seam ghost strips patched in, corner diagonals one
small gather.  Per slot the terms add in the order
((((x + t_px) + t_mx) + t_py) + t_my) + cor.

* `build_sharded_face_tables`: the [S, ...] numpy table stacks, a copy of
  the JAX builder (tests/test_torch_band.py holds them field by field);
* `band_roles`: per shard the [eloc, 16, 3] int32 table of the band kernel
  K7 (ops/band.py, csrc/band.cu): each slot's x partner, y partner and
  corner diagonal as flat slots of ext, -1 where absent, in the band's add
  order;
* `ShardedFaceTables`: one shard's tables on its device;
* `dss_sum_t_face_band`: the banded assembly in plain PyTorch, the raw sum
  of K7's plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.dss_face import partner_roles

__all__ = ["ShardedFaceTables", "band_roles", "build_sharded_face_tables",
           "dss_sum_t_face_band"]


def build_sharded_face_tables(grid, plan, ft) -> dict:
    """Build [S, ...] table stacks for the banded face DSS.

    grid: cubesphere Grid in raster order; plan: ShardPlan (identity perm);
    ft: the global face tables as numpy (ops/dss_face.py
    build_face_tables).  Returns a dict of the "f_"-prefixed [S, ...]
    numpy stacks and "_dims", the static dims.
    """
    ne = grid.ne
    E = grid.nelem
    S = plan.nshards
    eloc = plan.eloc
    if not np.array_equal(plan.perm, np.arange(E)):
        raise ValueError("face-sharded DSS requires identity element order "
                         "(no overlap reordering)")
    if eloc < 2 * ne:
        raise ValueError(f"face-sharded DSS needs >= 2 rows per shard "
                         f"(eloc {eloc} < 2*ne {2 * ne})")
    nrows_all = 6 * ne
    nr = (eloc + 4 * ne - 1) // ne

    g_px = np.asarray(ft["ghost_px"])        # [6, ne, 4] global flat slots
    g_mx = np.asarray(ft["ghost_mx"])
    g_py = np.asarray(ft["ghost_py"])
    g_my = np.asarray(ft["ghost_my"])
    g_diag = np.asarray(ft["diag_idx"])      # [E, 4]
    g_diag_mask = np.asarray(ft["diag_mask"])
    halo_gid = plan.halo_gid

    # patch slots: band face transitions + sphere edges
    P = 0
    per_shard = []
    for s in range(S):
        g0 = s * eloc
        a0 = g0 % ne
        o = (ne - a0) % ne
        bs = g0 - 2 * ne + o              # band global start (row-aligned)
        emap = {g0 + l: l for l in range(eloc)}
        for i, e in enumerate(halo_gid[s]):
            if e >= 0:
                emap[int(e)] = eloc + i

        def eidx(g):
            """global element -> (ext element id, valid)"""
            if 0 <= g < E and g in emap:
                return emap[g], True
            return 0, False

        def sidx(flat):
            """global flat slot -> (ext flat slot, valid)"""
            e, s16 = divmod(int(flat), 16)
            i, ok = eidx(e)
            return i * 16 + s16, ok

        head_idx = np.zeros(2 * ne, np.int32)
        head_mask = np.zeros(2 * ne, bool)
        for j in range(2 * ne):
            head_idx[j], head_mask[j] = eidx(g0 - 2 * ne + j)
        tail_idx = np.zeros(3 * ne, np.int32)
        tail_mask = np.zeros(3 * ne, bool)
        for j in range(3 * ne):
            tail_idx[j], tail_mask[j] = eidx(g0 + eloc + j)

        gpx_idx = np.zeros((nr, 4), np.int32)
        gpx_mask = np.zeros((nr, 4), bool)
        gmx_idx = np.zeros((nr, 4), np.int32)
        gmx_mask = np.zeros((nr, 4), bool)
        ysame_up = np.zeros(nr, bool)
        ysame_dn = np.zeros(nr, bool)
        pa = []                            # (pos, idx [ne,4], mask)
        pb = []
        row0 = bs // ne
        for r in range(nr):
            gr = row0 + r
            if not (0 <= gr < nrows_all):
                continue
            f, ey = divmod(gr, ne)
            for i in range(4):
                gpx_idx[r, i], gpx_mask[r, i] = sidx(g_px[f, ey, i])
                gmx_idx[r, i], gmx_mask[r, i] = sidx(g_mx[f, ey, i])
            ysame_up[r] = (gr + 1 < nrows_all) and ((gr + 1) // ne == f)
            ysame_dn[r] = (gr - 1 >= 0) and ((gr - 1) // ne == f)
            if ey == ne - 1:               # face-top row: +y seam strip
                idx = np.zeros((ne, 4), np.int32)
                msk = np.zeros((ne, 4), bool)
                for k in range(ne):
                    for i in range(4):
                        idx[k, i], msk[k, i] = sidx(g_py[f, k, i])
                pa.append((r, idx, msk))
            if ey == 0:                    # face-bottom row: -y seam strip
                idx = np.zeros((ne, 4), np.int32)
                msk = np.zeros((ne, 4), bool)
                for k in range(ne):
                    for i in range(4):
                        idx[k, i], msk[k, i] = sidx(g_my[f, k, i])
                pb.append((r, idx, msk))

        diag_idx = np.zeros((eloc, 4), np.int32)
        diag_mask = np.zeros((eloc, 4), bool)
        for l in range(eloc):
            for c in range(4):
                if g_diag_mask[g0 + l, c]:
                    diag_idx[l, c], diag_mask[l, c] = sidx(g_diag[g0 + l, c])

        # band-aligned static metric of the JAX Pallas band kernel's fused
        # scale/laplacian epilogues (same f64 sources the Model casts)
        band_rsp = np.zeros((nr, ne, 16))
        band_met = np.zeros((nr, ne, 5, 16))
        rsp16 = np.asarray(grid.rspheremp).reshape(E, 16)
        Dinv = np.asarray(grid.Dinv).reshape(E, 16, 2, 2)
        sp16 = np.asarray(grid.spheremp).reshape(E, 16)
        for r in range(nr):
            gr = row0 + r
            if not (0 <= gr < nrows_all):
                continue
            els = np.arange(gr * ne, gr * ne + ne)
            band_rsp[r] = rsp16[els]
            band_met[r, :, 0] = Dinv[els, :, 0, 0]
            band_met[r, :, 1] = Dinv[els, :, 0, 1]
            band_met[r, :, 2] = Dinv[els, :, 1, 0]
            band_met[r, :, 3] = Dinv[els, :, 1, 1]
            band_met[r, :, 4] = sp16[els]

        P = max(P, len(pa), len(pb))
        per_shard.append(dict(band_o=np.asarray([o], np.int32),
                              head_idx=head_idx, head_mask=head_mask,
                              tail_idx=tail_idx, tail_mask=tail_mask,
                              gpx_idx=gpx_idx, gpx_mask=gpx_mask,
                              gmx_idx=gmx_idx, gmx_mask=gmx_mask,
                              ysame_up=ysame_up, ysame_dn=ysame_dn,
                              pa=pa, pb=pb,
                              diag_idx=diag_idx, diag_mask=diag_mask,
                              band_rsp=band_rsp, band_met=band_met))

    P = max(P, 1)
    out = {}
    for k in ("band_o", "head_idx", "head_mask", "tail_idx", "tail_mask",
              "gpx_idx", "gpx_mask", "gmx_idx", "gmx_mask",
              "ysame_up", "ysame_dn", "diag_idx", "diag_mask",
              "band_rsp", "band_met"):
        out["f_" + k] = np.stack([d[k] for d in per_shard])
    for name, key in (("pa", "pa"), ("pb", "pb")):
        pos = np.zeros((S, P), np.int32)
        idx = np.zeros((S, P, ne, 4), np.int32)
        msk = np.zeros((S, P, ne, 4), bool)
        for s, d in enumerate(per_shard):
            for p, (r, pidx, pmsk) in enumerate(d[key]):
                pos[s, p] = r
                idx[s, p] = pidx
                msk[s, p] = pmsk
        out["f_" + name + "_pos"] = pos
        out["f_" + name + "_idx"] = idx
        out["f_" + name + "_mask"] = msk
    # uniform row-alignment offset (eloc % ne == 0, e.g. S=1 or the
    # NE120/S=8 production split): every shard's band offset is the same
    # static value (the JAX band kernel then slices statically)
    o_all = {int(d["band_o"][0]) for d in per_shard}
    out["_dims"] = dict(ne=ne, eloc=eloc, nr=nr, npatch=P,
                        band_o_static=(o_all.pop() if len(o_all) == 1
                                       else None))
    return out


def band_roles(plan, t: dict, ne: int) -> np.ndarray:
    """[S, eloc, 16, 3] int32: per shard and slot the x partner, the y
    partner and the corner diagonal as flat slots of the shard's ext =
    cat([local, halo]) elements, -1 where absent.  ops/dss_face.py
    partner_roles (x, diagonal, y, global slots) mapped through the
    shard's global -> ext element map."""
    glob = partner_roles(t, ne)[:, :, [0, 2, 1]]     # x, y, corner
    S, eloc = plan.nshards, plan.eloc
    out = np.full((S, eloc, 16, 3), -1, np.int32)
    for s in range(S):
        ext_of = np.full(glob.shape[0], -1, np.int64)
        ext_of[s * eloc:(s + 1) * eloc] = np.arange(eloc)
        hg = plan.halo_gid[s]
        ext_of[hg[hg >= 0]] = eloc + np.nonzero(hg >= 0)[0]
        g = glob[s * eloc:(s + 1) * eloc]
        e = np.where(g >= 0, ext_of[np.maximum(g, 0) // 16], 0)
        if ((g >= 0) & (e < 0)).any():
            raise ValueError(f"shard {s}: a partner lies outside its halo")
        out[s] = np.where(g >= 0, e * 16 + g % 16, -1)
    return out


@dataclasses.dataclass(frozen=True)
class ShardedFaceTables:
    """One shard's band tables on its device (index tables int64, masks
    bool, positions and offsets host ints).  role [eloc, 16, 3] int32 is
    K7's partner table (band_roles); met [eloc, 10, 16] (ops/euler.py
    metric_pack) and deriv [4, 4] feed its Laplacian epilogue."""
    ne: int
    eloc: int
    nhalo: int
    nr: int
    npatch: int
    band_o: int
    head_idx: torch.Tensor
    head_mask: torch.Tensor
    tail_idx: torch.Tensor
    tail_mask: torch.Tensor
    gpx_idx: torch.Tensor
    gpx_mask: torch.Tensor
    gmx_idx: torch.Tensor
    gmx_mask: torch.Tensor
    ysame_up: torch.Tensor
    ysame_dn: torch.Tensor
    pa_pos: tuple
    pa_idx: torch.Tensor
    pa_mask: torch.Tensor
    pb_pos: tuple
    pb_idx: torch.Tensor
    pb_mask: torch.Tensor
    diag_idx: torch.Tensor
    diag_mask: torch.Tensor
    role: torch.Tensor
    met: Optional[torch.Tensor] = None
    deriv: Optional[torch.Tensor] = None

    @staticmethod
    def from_stack(stack: dict, roles: np.ndarray, s: int, nhalo: int,
                   device, met=None, deriv=None) -> "ShardedFaceTables":
        """Shard s's tables from build_sharded_face_tables' stacks (with
        "_dims") and band_roles' [S, ...] table; met/deriv the shard's
        metric pack and the derivative matrix, or None (no Laplacian)."""
        dims = stack["_dims"]

        def dev(k):
            a = np.asarray(stack["f_" + k][s])
            return torch.as_tensor(a.astype(np.int64) if a.dtype != bool
                                   else a, device=device)
        return ShardedFaceTables(
            ne=dims["ne"], eloc=dims["eloc"], nhalo=nhalo, nr=dims["nr"],
            npatch=dims["npatch"], band_o=int(stack["f_band_o"][s][0]),
            **{k: dev(k) for k in ("head_idx", "head_mask", "tail_idx",
                                   "tail_mask", "gpx_idx", "gpx_mask",
                                   "gmx_idx", "gmx_mask", "ysame_up",
                                   "ysame_dn", "pa_idx", "pa_mask",
                                   "pb_idx", "pb_mask", "diag_idx",
                                   "diag_mask")},
            pa_pos=tuple(int(p) for p in stack["f_pa_pos"][s]),
            pb_pos=tuple(int(p) for p in stack["f_pb_pos"][s]),
            role=torch.as_tensor(np.ascontiguousarray(roles[s]),
                                 device=device),
            met=met, deriv=deriv)


def dss_sum_t_face_band(x, ext, t: ShardedFaceTables):
    """Banded face-shift DSS for one shard.

    x: [eloc, 16, B] local T-layout field; ext: [eloc+nhalo, 16, B] =
    cat([x, halo]).  Returns the assembled [eloc, 16, B], per slot
    ((((x + t_px) + t_mx) + t_py) + t_my) + cor, bitwise the JAX
    dss_sum_t_face_band."""
    ne, nr, eloc = t.ne, t.nr, t.eloc
    B = x.shape[-1]
    extf = ext.reshape(-1, B)

    def gather(src, idx, mask):
        """rows idx of src, zero where mask is false"""
        v = src.index_select(0, idx.reshape(-1)).reshape(
            tuple(idx.shape) + tuple(src.shape[1:]))
        m = mask.reshape(tuple(mask.shape) + (1,) * (src.dim() - 1))
        return torch.where(m, v, 0.0)

    head = gather(ext, t.head_idx, t.head_mask)
    tail = gather(ext, t.tail_idx, t.tail_mask)
    bandfull = torch.cat([head, x, tail])                # [eloc+5ne, 16, B]
    o = t.band_o
    band = bandfull[o:o + nr * ne]
    b4 = band.reshape(nr, ne, 16, B)
    bv = band.reshape(nr, ne, 4, 4, B)

    # +-x edge partners (in-row shifts; seam ghost columns)
    gpx = gather(extf, t.gpx_idx, t.gpx_mask)             # [nr, 4, B]
    gmx = gather(extf, t.gmx_idx, t.gmx_mask)
    S_px = torch.cat([b4[:, 1:, 0:4], gpx[:, None]], dim=1)
    S_mx = torch.cat([gmx[:, None], b4[:, :-1, 12:16]], dim=1)
    z12 = x.new_zeros((nr, ne, 12, B))
    t_px = torch.cat([z12, S_px], dim=2)
    t_mx = torch.cat([S_mx, z12], dim=2)

    # +-y sources: the neighbour row's j=0 / j=3 points, masked at face
    # transitions, with the y-seam strips added at those rows
    zrow = x.new_zeros((1, ne, 4, B))
    up = torch.cat([bv[1:, :, :, 0], zrow])
    dn = torch.cat([zrow, bv[:-1, :, :, 3]])
    up = torch.where(t.ysame_up[:, None, None, None], up, 0.0)
    dn = torch.where(t.ysame_dn[:, None, None, None], dn, 0.0)

    def patch(rows, pos, idx, mask):
        rows = rows.clone()
        for p in range(t.npatch):
            strip = gather(extf, idx[p], mask[p])          # [ne, 4, B]
            rows[pos[p]] = rows[pos[p]] + strip
        return rows

    up = patch(up, t.pa_pos, t.pa_idx, t.pa_mask)
    dn = patch(dn, t.pb_pos, t.pb_idx, t.pb_mask)

    z3 = x.new_zeros((nr, ne, 4, 3, B))
    t_py = torch.cat([z3, up[..., None, :]], dim=3).reshape(nr, ne, 16, B)
    t_my = torch.cat([dn[..., None, :], z3], dim=3).reshape(nr, ne, 16, B)

    out = b4 + t_px + t_mx + t_py + t_my
    pos0 = 2 * ne - o
    loc = out.reshape(nr * ne, 16, B)[pos0:pos0 + eloc]

    # corner diagonals (slots 0, 3, 12, 15)
    dv = gather(extf, t.diag_idx, t.diag_mask).reshape(eloc, 2, 2, B)
    zc = x.new_zeros((eloc, 2, 2, B))
    rows = torch.cat([dv[:, :, 0:1], zc, dv[:, :, 1:2]], dim=2)
    zi = x.new_zeros((eloc, 1, 4, B))
    cor = torch.cat([rows[:, 0:1], zi, zi, rows[:, 1:2]], dim=1) \
        .reshape(eloc, 16, B)
    return loc + cor
