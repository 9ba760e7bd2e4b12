"""Face-shift DSS tables and the face trio of kernels: K4 face DSS with
epilogues, K5 limiter-bound prep, K6 neighbor min/max.

Port of `transport_se_tpu/ops/dss_face.py` (`build_face_tables`,
`neighbor_minmax_face`) and of the kernels of
`transport_se_tpu/ops/pallas_dss.py` (`dss_face_pallas`,
`minmax_prep_pallas`, `neighbor_minmax_pallas`); reference edge_mod.F90:366
`edgeVpack`, :648 `edgeVunpack`, viscosity_mod.F90:748 `neighbor_minmax`,
prim_advection_mod.F90:645 `qdp_time_avg`.

Elements are in raster face order (index = face*ne^2 + ey*ne + ex), point
slot = i*4 + j with i along ex and j along ey.  `build_face_tables` derives
the seam ghost strips, corner diagonals and seam neighbor elements of the
JAX module from the grid's partner tables, in numpy; `FaceTables` carries
them as int64 tensors with the two tables the kernels read:

* `part` [E, 16, 3]: per slot its x-edge partner, corner diagonal and
  y-edge partner (flat slots into [E*16]; -1 where absent), the operands of
  the Pallas kernel's shifted slices and ghost strips in role order;
* `nbr` [E, 9]: each element, its 4 edge and 4 diagonal neighbors, self at
  the missing diagonal of a cube vertex (the Pallas kernel's +-inf pad).

The CUDA kernels are `csrc/dss.cu`.  Their plain PyTorch versions below
compute the same functions in the same operation order; the plain neighbor
min/max is the shifted-copy form of `neighbor_minmax_face`, so the tests
exercise the seam tables through it.  A CPU tensor runs the plain version,
a CUDA tensor launches the kernel, anything else raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import _build
from ..counters import bump
from .euler import (_DTYPES, N2, _check, _device_kind, _lap_wk, _met_rows,
                    _stream)

# the JAX FaceTables' fields, in its order
FACE_FIELDS = ("ghost_px", "ghost_mx", "ghost_py", "ghost_my", "diag_idx",
               "diag_mask", "src_px", "src_mx", "src_py", "src_my")
CORNER_SLOTS = (0, 3, 12, 15)
# slots on the i = 0 and i = 3 planes: the ones with an x-edge partner
_X_PLANE = np.array([p // 4 in (0, 3) for p in range(N2)])


# ---------------------------------------------------------------------------
# host-side tables (numpy)
# ---------------------------------------------------------------------------

def _elem(ne, f, ey, ex):
    return f * ne * ne + ey * ne + ex


def _partners(part_idx, part_mask, fs):
    """All flat partner slots of flat point slot fs."""
    return [int(part_idx[fs, c]) for c in range(part_idx.shape[1])
            if part_mask[fs, c]]


def _is_raster(part_idx, part_mask, ne):
    """Whether the in-face edge partners are those of raster order: the
    middle point of an element's +x edge (slot 13) is shared with element
    e+1 only, that of its +y edge (slot 7) with element e+ne only."""
    for e in range(6 * ne * ne):
        ey, ex = e % (ne * ne) // ne, e % ne
        if ex < ne - 1 and [p // 16 for p in _partners(
                part_idx, part_mask, e * 16 + 13)] != [e + 1]:
            return False
        if ey < ne - 1 and [p // 16 for p in _partners(
                part_idx, part_mask, e * 16 + 7)] != [e + ne]:
            return False
    return True


def build_face_tables(part_idx, part_mask, ne: int) -> dict:
    """The JAX `build_face_tables` (dss_face.py:69-156) from the grid's
    partner tables part_idx/part_mask [E*16, 3]: a dict of FACE_FIELDS as
    numpy (int64 slots and elements, bool diag_mask).

    Raises ValueError unless the elements are in raster face order."""
    part_idx = np.asarray(part_idx)
    part_mask = np.asarray(part_mask, dtype=bool)
    if ne < 2:
        raise ValueError("face DSS needs ne >= 2")
    E = 6 * ne * ne
    if part_idx.shape != (E * N2, 3) or part_mask.shape != part_idx.shape:
        raise ValueError(f"partner tables {part_idx.shape} do not fit "
                         f"ne={ne}")
    if not _is_raster(part_idx, part_mask, ne):
        raise ValueError("face DSS requires raster element order "
                         "(build_grid order='raster')")

    def side_table(f, side):
        gh = np.zeros((ne, 4), np.int64)
        src = np.zeros(ne, np.int64)
        for k in range(ne):
            if side == "px":
                e, myslots = _elem(ne, f, k, ne - 1), [12 + j
                                                       for j in range(4)]
            elif side == "mx":
                e, myslots = _elem(ne, f, k, 0), list(range(4))
            elif side == "py":
                e, myslots = _elem(ne, f, ne - 1, k), [i * 4 + 3
                                                       for i in range(4)]
            else:
                e, myslots = _elem(ne, f, 0, k), [i * 4 for i in range(4)]
            # a non-corner edge point has exactly one partner
            ps = _partners(part_idx, part_mask, e * 16 + myslots[1])
            if len(ps) != 1:
                raise ValueError(f"edge point of element {e} has partners "
                                 f"{ps}")
            s = ps[0] // 16
            src[k] = s
            for r, ms in enumerate(myslots):
                cands = [p for p in _partners(part_idx, part_mask,
                                              e * 16 + ms) if p // 16 == s]
                if len(cands) != 1:
                    raise ValueError(f"seam slot {e}:{ms} has partners "
                                     f"{cands} in element {s}")
                gh[k, r] = cands[0]
        return gh, src

    g, s = {}, {}
    for f in range(6):
        for side in ("px", "mx", "py", "my"):
            gh, sr = side_table(f, side)
            g.setdefault(side, []).append(gh)
            s.setdefault(side, []).append(sr)
    g = {k: np.stack(v) for k, v in g.items()}
    s = {k: np.stack(v) for k, v in s.items()}

    # per-element edge-sharing neighbors (in-face or seam src)
    edge_nbr = np.zeros((E, 4), np.int64)
    for e in range(E):
        f, ey, ex = e // (ne * ne), e % (ne * ne) // ne, e % ne
        edge_nbr[e, 0] = _elem(ne, f, ey, ex + 1) if ex < ne - 1 \
            else s["px"][f, ey]
        edge_nbr[e, 1] = _elem(ne, f, ey, ex - 1) if ex > 0 \
            else s["mx"][f, ey]
        edge_nbr[e, 2] = _elem(ne, f, ey + 1, ex) if ey < ne - 1 \
            else s["py"][f, ex]
        edge_nbr[e, 3] = _elem(ne, f, ey - 1, ex) if ey > 0 \
            else s["my"][f, ex]

    # corner diagonal partners: the partner not in an edge-sharing element
    diag_idx = np.zeros((E, 4), np.int64)
    diag_mask = np.zeros((E, 4), bool)
    for e in range(E):
        en = set(int(v) for v in edge_nbr[e])
        for c, slot in enumerate(CORNER_SLOTS):
            others = [p for p in _partners(part_idx, part_mask, e * 16 + slot)
                      if p // 16 not in en]
            if len(others) > 1:
                raise ValueError(f"corner {e}:{slot} has diagonals {others}")
            if others:
                diag_idx[e, c] = others[0]
                diag_mask[e, c] = True

    return dict(ghost_px=g["px"], ghost_mx=g["mx"], ghost_py=g["py"],
                ghost_my=g["my"], diag_idx=diag_idx, diag_mask=diag_mask,
                src_px=s["px"], src_mx=s["mx"], src_py=s["py"],
                src_my=s["my"])


def partner_roles(t: dict, ne: int) -> np.ndarray:
    """[E, 16, 3] int64: per slot its x-edge partner, corner diagonal and
    y-edge partner as flat slots, -1 where absent.  The x partner of the
    i=3 plane is slot (0, j) of the element at ex+1 or the +x ghost strip
    (and mirrored for i=0); likewise along y; the diagonal is diag_idx."""
    E = 6 * ne * ne
    part = np.full((E, N2, 3), -1, np.int64)
    for e in range(E):
        f, ey, ex = e // (ne * ne), e % (ne * ne) // ne, e % ne
        for j in range(4):
            part[e, 12 + j, 0] = (_elem(ne, f, ey, ex + 1) * 16 + j
                                  if ex < ne - 1 else t["ghost_px"][f, ey, j])
            part[e, j, 0] = (_elem(ne, f, ey, ex - 1) * 16 + 12 + j
                             if ex > 0 else t["ghost_mx"][f, ey, j])
        for i in range(4):
            part[e, i * 4 + 3, 2] = (_elem(ne, f, ey + 1, ex) * 16 + i * 4
                                     if ey < ne - 1
                                     else t["ghost_py"][f, ex, i])
            part[e, i * 4, 2] = (_elem(ne, f, ey - 1, ex) * 16 + i * 4 + 3
                                 if ey > 0 else t["ghost_my"][f, ex, i])
        for c, slot in enumerate(CORNER_SLOTS):
            if t["diag_mask"][e, c]:
                part[e, slot, 1] = t["diag_idx"][e, c]
    return part


def neighbor_elements(t: dict, ne: int) -> np.ndarray:
    """[E, 9] int64: self, the +x, -x, +y, -y edge neighbors and the
    (+x,+y), (+x,-y), (-x,+y), (-x,-y) diagonals, as neighbor_minmax_face
    shifts them; self where a cube vertex has no diagonal."""
    E = 6 * ne * ne
    nbr = np.zeros((E, 9), np.int64)
    for e in range(E):
        f, ey, ex = e // (ne * ne), e % (ne * ne) // ne, e % ne

        def xn(y, d):
            """The x-shifted field's element at row y: ex+d or the seam."""
            x = ex + d
            if 0 <= x < ne:
                return _elem(ne, f, y, x)
            return (t["src_px"] if d > 0 else t["src_mx"])[f, y]

        def yn(d):
            y = ey + d
            if 0 <= y < ne:
                return _elem(ne, f, y, ex)
            return (t["src_py"] if d > 0 else t["src_my"])[f, ex]

        def diag(dx, dy):
            y = ey + dy
            if 0 <= y < ne:
                return xn(y, dx)
            # the open row: the y strip shifted by dx, pad past its end
            x = ex + dx
            if 0 <= x < ne:
                return (t["src_py"] if dy > 0 else t["src_my"])[f, x]
            return e
        nbr[e] = (e, xn(ey, 1), xn(ey, -1), yn(1), yn(-1), diag(1, 1),
                  diag(1, -1), diag(-1, 1), diag(-1, -1))
    return nbr


@dataclasses.dataclass(frozen=True)
class FaceTables:
    """The face-DSS tables on the model's device (int64, diag_mask bool):
    the JAX FaceTables' fields plus the kernels' `part` and `nbr`."""
    ne: int
    ghost_px: torch.Tensor   # [6, ne, 4] flat slots
    ghost_mx: torch.Tensor
    ghost_py: torch.Tensor
    ghost_my: torch.Tensor
    diag_idx: torch.Tensor   # [E, 4]
    diag_mask: torch.Tensor  # [E, 4] bool
    src_px: torch.Tensor     # [6, ne] seam neighbor elements
    src_mx: torch.Tensor
    src_py: torch.Tensor
    src_my: torch.Tensor
    part: torch.Tensor       # [E, 16, 3] x partner, diagonal, y partner
    nbr: torch.Tensor        # [E, 9] neighbor elements, self-padded

    @staticmethod
    def from_grid(part_idx, part_mask, ne: int, device) -> "FaceTables":
        t = build_face_tables(part_idx, part_mask, ne)

        def dev(a):
            return torch.as_tensor(np.array(a), device=device)
        return FaceTables(ne=ne, **{k: dev(t[k]) for k in FACE_FIELDS},
                          part=dev(partner_roles(t, ne)),
                          nbr=dev(neighbor_elements(t, ne)))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _q_minmax(x, dp, nq):
    """Min/max over the 16 points of x/dp -> ([E, L], [E, L]); dp
    [E,16,nk] repeats over the nq tracers of the lanes."""
    E, nn, L = x.shape
    q = x.reshape(E, nn, nq, dp.shape[-1]) / dp[:, :, None, :]
    return q.amin(dim=1).reshape(E, L), q.amax(dim=1).reshape(E, L)


def dss_face_plain(x, ft: FaceTables, rsp=None, avg=None, dp=None,
                   met=None, deriv=None):
    """Plain PyTorch version of the face DSS; see dss_face."""
    bump("dss_face_plain")
    E, nn, L = x.shape
    xf = x.reshape(E * nn, L)

    def role(r):
        idx = ft.part[:, :, r].reshape(-1)
        v = xf.index_select(0, idx.clamp(min=0))
        return torch.where((idx >= 0)[:, None], v, 0.0).reshape(x.shape)

    sx, d, sy = role(0), role(1), role(2)
    xplane = torch.as_tensor(_X_PLANE, device=x.device)[None, :, None]
    res = torch.where(xplane, (x + (sx + d)) + sy, x + sy)
    del sx, d, sy
    if rsp is not None:
        res = res * rsp[:, :, None]
    if avg is not None:
        # times 1/3, as dss_face_pallas evaluates its "/ 3": XLA folds the
        # division by a constant into a product with its reciprocal
        res = (avg + 2.0 * res) * (1.0 / 3.0)
    if dp is None:
        return res
    nq = L // dp.shape[-1]
    q = (res.reshape(E, nn, nq, -1) / dp[:, :, None, :]).reshape(x.shape)
    ret = (res, q.amin(dim=1), q.amax(dim=1))
    if met is not None:
        s00, s01, s11 = _met_rows(met, "s00", "s01", "s11")
        ret += (_lap_wk(q, s00, s01, s11, deriv),)
    return ret


def minmax_prep_plain(x, dp, nq):
    """Plain PyTorch version of the bound prep; see minmax_prep."""
    bump("minmax_prep_plain")
    return _q_minmax(x, dp, nq)


def _ordered(q):
    """q's bits as integers ordered as the values, -0 below +0 (IEEE
    754-2019 minimum and maximum, as the JAX package's jnp.minimum and
    jnp.maximum order them; NaN is not in the domain).  The map is its own
    inverse: _ordered(_ordered(q)) gives q's bits back."""
    i = q.view(torch.int32 if q.element_size() == 4 else torch.int64)
    return torch.where(i < 0, i ^ torch.iinfo(i.dtype).max, i)


def _nbr_reduce(k, ft: FaceTables, op, pad):
    """neighbor_minmax_face's shifted-copy reduce with op of the keys k
    [E, L] (_ordered), with the key pad at the cube vertices."""
    ne = ft.ne
    E, L = k.shape
    q6 = k.reshape(6, ne, ne, L)             # [f, ey, ex, L]
    spx, smx, spy, smy = (k.index_select(0, s.reshape(-1)).reshape(6, ne, L)
                          for s in (ft.src_px, ft.src_mx, ft.src_py,
                                    ft.src_my))

    def shx(a, d, ghost):
        """shift along ex, filling the open column from the ghost."""
        g = ghost[:, :, None]
        return (torch.cat([a[:, :, 1:], g], dim=2) if d == 1
                else torch.cat([g, a[:, :, :-1]], dim=2))

    def shy(a, d, ghost):
        g = ghost[:, None]
        return (torch.cat([a[:, 1:], g], dim=1) if d == 1
                else torch.cat([g, a[:, :-1]], dim=1))

    def sh_strip(st, d):
        pp = torch.full_like(st[:, :1], pad)
        return (torch.cat([st[:, 1:], pp], dim=1) if d == 1
                else torch.cat([pp, st[:, :-1]], dim=1))

    xp = shx(q6, 1, spx)
    xm = shx(q6, -1, smx)
    r = op(op(q6, xp), xm)
    r = op(r, shy(q6, 1, spy))
    r = op(r, shy(q6, -1, smy))
    # diagonals: y-shift the x-shifted fields; the open row is the shifted
    # y strip, whose open corner (a cube vertex) is the pad
    r = op(r, shy(xp, 1, sh_strip(spy, 1)))
    r = op(r, shy(xp, -1, sh_strip(smy, 1)))
    r = op(r, shy(xm, 1, sh_strip(spy, -1)))
    r = op(r, shy(xm, -1, sh_strip(smy, -1)))
    return r.reshape(E, L)


def neighbor_minmax_plain(qmin, qmax, ft: FaceTables):
    """Plain PyTorch version of the neighbor min/max; see
    neighbor_minmax.  It reduces integer keys of the values (_ordered):
    exact, -0 below +0, so the result does not depend on the order of the
    reduction (torch.minimum's choice between tied zeros does)."""
    bump("neighbor_minmax_plain")
    out = []
    for q, op, pad in ((qmin, torch.minimum, float("inf")),
                       (qmax, torch.maximum, float("-inf"))):
        pk = _ordered(torch.full((1,), pad, dtype=q.dtype)).item()
        out.append(_ordered(_nbr_reduce(_ordered(q), ft, op, pk))
                   .view(q.dtype))
    return tuple(out)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _ptr(t):
    return None if t is None else t.data_ptr()


def dss_face(x, ft: FaceTables, rsp=None, avg=None, dp=None, met=None,
             deriv=None):
    """Face-shift DSS of x [E, 16, L] (raster face order) with the fused
    epilogues of the Pallas kernel, in this order:

    rsp [E, 16]: scale by rspheremp (make_C0);
    avg [E, 16, L]: out = (avg + 2*out)/3, the qdp_time_avg (needs rsp);
    dp [E, 16, nk]: also qmin/qmax [E, L], the min/max over the 16 points
        of q = out/dp, dp repeated over the L/nk tracers (needs rsp);
    met [E, 10, 16] (metric_pack) and deriv [4, 4]: also lap = the weak
        Laplacian of q (needs dp).

    Returns out, or (out, qmin, qmax), or (out, qmin, qmax, lap)."""
    kind = _device_kind(x)
    E, _, L = x.shape
    dev, f = x.device, x.dtype
    if met is not None and dp is None:
        raise ValueError("lap fusion requires dp")
    if avg is not None and rsp is None:
        raise ValueError("avg fusion requires rsp")
    if dp is not None and rsp is None:
        raise ValueError("minmax fusion requires rsp")
    _check("x", x, (E, N2, L), f, dev)
    _check("part", ft.part, (E, N2, 3), torch.int64, dev)
    nk = 1
    if rsp is not None:
        _check("rsp", rsp, (E, N2), f, dev)
    if avg is not None:
        _check("avg", avg, (E, N2, L), f, dev)
    if dp is not None:
        nk = dp.shape[-1]
        if L % nk:
            raise ValueError(f"lanes {L} are not a multiple of nk={nk}")
        _check("dp", dp, (E, N2, nk), f, dev)
    if met is not None:
        _check("met", met, (E, 10, N2), f, dev)
        _check("deriv", deriv, (4, 4), f, dev)
    if kind == "cpu":
        return dss_face_plain(x, ft, rsp=rsp, avg=avg, dp=dp, met=met,
                              deriv=deriv)
    out = torch.empty_like(x)
    qmin = qmax = lap = None
    if dp is not None:
        qmin = x.new_empty((E, L))
        qmax = x.new_empty((E, L))
    if met is not None:
        lap = torch.empty_like(x)
    # bit 0 avg, bit 1 min/max, bit 2 Laplacian (csrc/dss.cu)
    flags = (int(avg is not None) | int(dp is not None) << 1
             | int(met is not None) << 2)
    fn = _build.entry("tse_dss_face", _DTYPES[f])
    code = fn(x.data_ptr(), ft.part.data_ptr(), _ptr(rsp), _ptr(avg),
              _ptr(dp), _ptr(met), _ptr(deriv), out.data_ptr(), _ptr(qmin),
              _ptr(qmax), _ptr(lap), E, L, nk, flags, _stream(dev))
    _build.check(code, "dss_face")
    bump("dss_face")
    if dp is None:
        return out
    return (out, qmin, qmax) + ((lap,) if met is not None else ())


def minmax_prep(x, dp, nq):
    """Per-element limiter-bound prep: min/max over the 16 points of
    q = x/dp -> (qmin, qmax) [E, L]; x [E, 16, L] with L = nq*nk, dp
    [E, 16, nk] repeated over the nq tracers."""
    kind = _device_kind(x)
    E, _, L = x.shape
    nk = dp.shape[-1]
    dev, f = x.device, x.dtype
    if L != nq * nk:
        raise ValueError(f"lanes {L} != nq*nk = {nq}*{nk}")
    _check("x", x, (E, N2, L), f, dev)
    _check("dp", dp, (E, N2, nk), f, dev)
    if kind == "cpu":
        return minmax_prep_plain(x, dp, nq)
    qmin = x.new_empty((E, L))
    qmax = x.new_empty((E, L))
    fn = _build.entry("tse_minmax_prep", _DTYPES[f])
    code = fn(x.data_ptr(), dp.data_ptr(), qmin.data_ptr(), qmax.data_ptr(),
              E, L, nk, _stream(dev))
    _build.check(code, "minmax_prep")
    bump("minmax_prep")
    return qmin, qmax


def kernel_config(L, nk, dtype):
    """K5's launch shape on L lanes of nk levels for 16-byte-aligned
    fields, on the current card: lanes per thread, threads per block, lane
    groups per element, dynamic shared-memory bytes per block and resident
    blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Needs
    a CUDA device."""
    buf = (ctypes.c_int * 5)()
    fn = _build.entry("tse_minmax_config", _DTYPES[dtype])
    _build.check(fn(int(L), int(nk), buf), "minmax_config")
    return dict(zip(("vec", "threads", "groups", "smem_bytes",
                     "blocks_per_sm"), buf))


def nbr_kernel_config(E, L, dtype):
    """K6's launch shape on E = 6 ne^2 elements of L lanes for 16-byte-
    aligned bounds, on the current card: lanes per thread, threads per
    block, blocks, dynamic shared-memory bytes per block and resident
    blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Needs
    a CUDA device."""
    buf = (ctypes.c_int * 5)()
    fn = _build.entry("tse_nbr_minmax_config", _DTYPES[dtype])
    _build.check(fn(int(E), int(L), buf), "nbr_minmax_config")
    return dict(zip(("vec", "threads", "blocks", "smem_bytes",
                     "blocks_per_sm"), buf))


def neighbor_minmax(qmin, qmax, ft: FaceTables):
    """Min of qmin and max of qmax [E, L] over each element and its (up to
    8) point-sharing neighbors (viscosity_mod.F90:748-816), -0 below +0."""
    kind = _device_kind(qmin)
    E, L = qmin.shape
    dev, f = qmin.device, qmin.dtype
    _check("qmin", qmin, (E, L), f, dev)
    _check("qmax", qmax, (E, L), f, dev)
    _check("nbr", ft.nbr, (E, 9), torch.int64, dev)
    if kind == "cpu":
        return neighbor_minmax_plain(qmin, qmax, ft)
    gmin = torch.empty_like(qmin)
    gmax = torch.empty_like(qmax)
    fn = _build.entry("tse_neighbor_minmax", _DTYPES[f])
    code = fn(qmin.data_ptr(), qmax.data_ptr(), ft.nbr.data_ptr(),
              gmin.data_ptr(), gmax.data_ptr(), E, L, _stream(dev))
    _build.check(code, "neighbor_minmax")
    bump("neighbor_minmax")
    return gmin, gmax
