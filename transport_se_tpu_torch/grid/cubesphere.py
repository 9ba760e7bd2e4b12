"""Equiangular cubed-sphere grid, SE metric terms, and DSS assembly tables.

The port's own copy of `transport_se_tpu/grid/cubesphere.py` (numpy only), kept
bit-identical to it (tests/test_torch_host.py).

TPU-native re-design of the reference grid stack (reference:
src/share/cube_mod.F90 `CubeTopology`/`cube_init_atomic`/`metric_atomic`,
src/share/mass_matrix_mod.F90 `mass_matrix`, src/share/dof_mod.F90
`global_dof`/`CreateUniqueIndex`).  Everything is host-side numpy, batched
over elements as flat arrays [E, np, np, ...] — no element objects.

Design differences from the reference (intentional, TPU-first):

* Inter-element connectivity is NOT described by edge pack/unpack buffers and
  communication schedules.  Instead we build, once, a *partner table*: for
  every (element, GLL point) slot, the (up to 3) other slots that hold the
  same physical grid point.  Direct stiffness summation (DSS) then becomes
  three masked gathers + adds, which XLA vectorizes over (level, tracer)
  batch dimensions (cf. reference edge_mod.F90:366 `edgeVpack`,
  :648 `edgeVunpack`, bndry_mod.F90:21 `bndry_exchangeV`).
* Point identity is established geometrically (union-find over quantized
  unit-sphere coordinates with dual-offset quantization, provably robust for
  tolerance << grid spacing) instead of replicating the cube edge-orientation
  bookkeeping (cube_mod.F90:2346 `CubeSetupEdgeIndex`, edge reversal flags),
  which the survey flags as the classic failure mode.

Face conventions match the reference (coordinate_systems_mod.F90:404-498):
faces 1-4 around the equator starting at lon=0 (face 1 at +X), face 5 south
(-Z), face 6 north (+Z); each face carries equiangular coordinates
(x1, x2) in [-pi/4, pi/4].
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import DD_PI
from .quadrature import gll_points_weights, gll_derivative_matrix
from .sfc import gilbert_curve

NP = 4  # GLL points per element edge (reference is compiled with NP=4)

__all__ = ["Grid", "build_grid", "NP"]


# --------------------------------------------------------------------------
# face geometry
# --------------------------------------------------------------------------

def face_to_xyz(face: np.ndarray, a: np.ndarray, b: np.ndarray):
    """Unit-sphere 3D coordinates from equiangular face coords (a, b).

    Directions per face (derived from coordinate_systems_mod.F90:616-647
    `cart2cubedsphere`):
      f1: ( 1,  ta,  tb)   f2: (-ta,  1,  tb)   f3: (-1, -ta,  tb)
      f4: ( ta, -1,  tb)   f5: ( tb,  ta, -1)   f6: (-tb,  ta,  1)

    Assembled with per-face masked writes (faces are contiguous blocks of
    the element axis, but any layout works); trig in float64 — coincidence
    matching needs agreement far below the 1e-7 grouping quantum and f64
    trig is consistent to ~1e-15 across faces.
    """
    face, a, b = np.broadcast_arrays(face, a, b)
    ta = np.tan(np.asarray(a, dtype=np.float64))
    tb = np.tan(np.asarray(b, dtype=np.float64))
    X = np.empty(face.shape, dtype=np.float64)
    Y = np.empty_like(X)
    Z = np.empty_like(X)
    for f in range(1, 7):
        mask = face == f
        if not mask.any():
            continue
        t1, t2 = ta[mask], tb[mask]
        one = np.ones_like(t1)
        fx, fy, fz = {
            1: (one, t1, t2), 2: (-t1, one, t2), 3: (-one, -t1, t2),
            4: (t1, -one, t2), 5: (t2, t1, -one), 6: (-t2, t1, one),
        }[f]
        X[mask], Y[mask], Z[mask] = fx, fy, fz
    r = np.sqrt(X * X + Y * Y + Z * Z)
    return X / r, Y / r, Z / r


def face_to_lonlat(face, a, b):
    """lon in [0, 2pi), lat — matches cart2spherical conventions."""
    X, Y, Z = face_to_xyz(face, a, b)
    lon = np.arctan2(Y, X)
    lon = np.where(lon < 0, lon + 2 * DD_PI, lon)
    lat = np.arcsin(np.clip(Z, -1.0, 1.0))
    return np.asarray(lon, dtype=np.float64), np.asarray(lat, dtype=np.float64)


def _vmap_D(face, x1, x2):
    """Gnomonic map Jacobian: sphere components of the contravariant basis.

    Re-derivation of the equiangular gnomonic projection Jacobian
    (cf. cube_mod.F90:658 `vmap`).  Rows: (zonal, meridional); columns:
    (d/dx1, d/dx2).  Arrays broadcast; x1, x2 in face-local [-pi/4, pi/4].
    """
    face, x1, x2 = np.broadcast_arrays(face, x1, x2)
    D = np.zeros(face.shape + (2, 2), dtype=np.float64)

    eq = face <= 4
    if eq.any():
        a1, a2 = x1[eq], x2[eq]
        t1, t2 = np.tan(a1), np.tan(a2)
        r2 = 1.0 + t1 * t1 + t2 * t2
        r = np.sqrt(r2)
        c1, c2 = np.cos(a1), np.cos(a2)
        D[eq, 0, 0] = 1.0 / (r * c1)
        D[eq, 1, 0] = -t1 * t2 / (c1 * r2)
        D[eq, 1, 1] = 1.0 / (r2 * c1 * c2 * c2)

    for f, sign in ((6, 1.0), (5, -1.0)):
        m = face == f
        if not m.any():
            continue
        a1, a2 = x1[m], x2[m]
        t1, t2 = np.tan(a1), np.tan(a2)
        r2 = 1.0 + t1 * t1 + t2 * t2
        r = np.sqrt(r2)
        c1, c2 = np.cos(a1), np.cos(a2)
        pol = np.sqrt(t1 * t1 + t2 * t2)
        at_pole = pol == 0
        ps = np.where(at_pole, 1.0, pol)
        D[m, 0, 0] = np.where(at_pole, 1.0, sign * -t2 / (ps * c1 * c1 * r))
        D[m, 0, 1] = np.where(at_pole, 0.0, sign * t1 / (ps * c2 * c2 * r))
        D[m, 1, 0] = np.where(at_pole, 0.0, sign * -t1 / (ps * c1 * c1 * r2))
        D[m, 1, 1] = np.where(at_pole, 1.0, sign * -t2 / (ps * c2 * c2 * r2))
    return D


# --------------------------------------------------------------------------
# grid container
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Grid:
    """All static per-element data, flat over elements in SFC order."""
    ne: int
    nelem: int                 # E = 6 * ne^2
    face: np.ndarray           # [E] int, 1..6
    ex: np.ndarray             # [E] element x-index within face
    ey: np.ndarray             # [E]
    lon: np.ndarray            # [E, NP, NP]
    lat: np.ndarray            # [E, NP, NP]
    D: np.ndarray              # [E, NP, NP, 2, 2]  contra->sphere
    Dinv: np.ndarray           # [E, NP, NP, 2, 2]  sphere->contra
    metdet: np.ndarray         # [E, NP, NP]
    rmetdet: np.ndarray        # [E, NP, NP]
    mp: np.ndarray             # [E, NP, NP]   GLL weights outer product
    spheremp: np.ndarray       # [E, NP, NP]   mp * metdet
    rspheremp: np.ndarray      # [E, NP, NP]   1 / DSS(spheremp)
    gll_w: np.ndarray          # [NP]
    gll_x: np.ndarray          # [NP]
    deriv: np.ndarray          # [NP, NP]  deriv[l,i] = ell_i'(x_l)
    gid: np.ndarray            # [E, NP, NP] int32 global point id
    ngid: int                  # number of unique points (= ncol)
    part_idx: np.ndarray       # [E*16, 3] int32 flat partner slots
    part_mask: np.ndarray      # [E*16, 3] bool
    nbr: np.ndarray            # [E, 9] int32 neighbor elements (self first,
                               #        padded with self)
    uniq_src: np.ndarray       # [ncol] int64 flat (e*16+slot) owner per gid
    col_of_gid: np.ndarray     # [ngid] int64 history column index per gid
    alpha: float               # area renormalization factor

    @property
    def np(self):
        return NP


# --------------------------------------------------------------------------
# point identification (union-find over quantized coordinates)
# --------------------------------------------------------------------------

def _union_find_gids(xyz: np.ndarray, quantum: float) -> np.ndarray:
    """Group rows of xyz [N,3] that coincide within << quantum.

    Two quantization passes (offset by 0 and quantum/2) guarantee that any
    two points closer than ~quantum/4 share a key in at least one pass, while
    points farther than 2*quantum never do.
    """
    n = xyz.shape[0]
    parent = np.arange(n, dtype=np.int64)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    def union_groups(keys):
        order = np.lexsort(keys.T)
        k = keys[order]
        same = np.all(k[1:] == k[:-1], axis=1)
        for a, b in zip(order[:-1][same], order[1:][same]):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra

    q = quantum
    for offset in (0.0, 0.5 * q):
        keys = np.floor((xyz + offset) / q).astype(np.int64)
        union_groups(keys)

    roots = np.array([find(i) for i in range(n)], dtype=np.int64)
    # canonical numbering: groups ordered by first occurrence, so that
    # gid[uniq_src[g]] == g and the result matches the native builder
    _, first_idx, gid = np.unique(roots, return_index=True,
                                  return_inverse=True)
    rank = np.empty(first_idx.size, dtype=np.int64)
    rank[np.argsort(first_idx)] = np.arange(first_idx.size)
    return rank[gid].astype(np.int32)


def _dss_sum_np(x: np.ndarray, gid_flat: np.ndarray, ngid: int) -> np.ndarray:
    """Host-side DSS: scatter-add by gid, gather back (numpy, any [N] x)."""
    acc = np.zeros(ngid, dtype=x.dtype)
    np.add.at(acc, gid_flat, x)
    return acc[gid_flat]


def _tables_from_gids(gid_flat: np.ndarray, ngid: int, E: int):
    """Vectorized construction of (part_idx, part_mask, nbr, uniq_src) from
    canonical gids — the numpy fallback for native/gridtables.cpp."""
    n = gid_flat.size
    order = np.argsort(gid_flat, kind="stable")
    sorted_gid = gid_flat[order]
    starts = np.searchsorted(sorted_gid, np.arange(ngid))
    ends = np.searchsorted(sorted_gid, np.arange(ngid), side="right")
    mult = ends - starts
    if int(mult.max()) > 4:
        raise RuntimeError(f"point multiplicity {int(mult.max())} > 4")
    uniq_src = order[starts]  # stable sort => min slot per gid; increasing

    part_idx = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, 3))
    part_mask = np.zeros((n, 3), dtype=bool)
    elem_of_slot = (np.arange(n) // (n // E)).astype(np.int32)
    pair_list = []
    for m in range(2, 5):
        gs = np.nonzero(mult == m)[0]
        if gs.size == 0:
            continue
        # members[k, j] = j-th slot of the k-th multiplicity-m group,
        # in increasing slot order
        members = order[starts[gs][:, None] + np.arange(m)[None, :]]
        for j in range(m):
            others = members[:, [o for o in range(m) if o != j]]
            part_idx[members[:, j], :m - 1] = others
            part_mask[members[:, j], :m - 1] = True
            es = elem_of_slot[members[:, j]]
            eo = elem_of_slot[others]
            sel = eo != es[:, None]
            pair_list.append(np.stack(
                [np.repeat(es, m - 1)[sel.reshape(-1)],
                 eo[sel]], axis=1))

    nbr = np.tile(np.arange(E, dtype=np.int32)[:, None], (1, 9))
    if pair_list:
        pairs = np.unique(np.concatenate(pair_list), axis=0)  # sorted (e, o)
        e_vals, e_starts = np.unique(pairs[:, 0], return_index=True)
        e_ends = np.append(e_starts[1:], pairs.shape[0])
        counts = e_ends - e_starts
        if int(counts.max()) > 8:
            raise RuntimeError(f"element has {int(counts.max())} neighbors > 8")
        for k in range(1, 9):
            sel = counts >= k
            nbr[e_vals[sel], k] = pairs[e_starts[sel] + k - 1, 1]
    return part_idx, part_mask, nbr, uniq_src


# --------------------------------------------------------------------------
# grid construction
# --------------------------------------------------------------------------

def build_grid(ne: int, order: str = "gilbert") -> Grid:
    """Build the full grid for 6*ne^2 elements (cf. prim_init1 call stack).

    order selects the element storage order (both are face-major):
      "gilbert": generalized-Hilbert SFC within each face (the reference's
        genspacepart discipline, spacecurve_mod.F90:1218) — compact shard
        chunks for the halo-exchange path.
      "raster": ey-major raster within each face — required by the
        face-shift DSS (ops/dss_face.py), where within-face assembly
        becomes static shifted slices.
    """
    E = 6 * ne * ne
    gx, gw = gll_points_weights(NP)
    deriv = gll_derivative_matrix(NP)

    # --- element ordering: face-major, per-face order by `order`
    if order == "gilbert":
        curve = gilbert_curve(ne, ne)                   # [ne*ne, 2]
    elif order == "raster":
        p = np.arange(ne * ne)
        curve = np.stack([p % ne, p // ne], axis=1)     # ex fast, ey slow
    else:
        raise ValueError(f"unknown element order {order!r}")
    face = np.repeat(np.arange(1, 7), ne * ne)
    ex = np.tile(curve[:, 0], 6)
    ey = np.tile(curve[:, 1], 6)

    # --- GLL point face coordinates, in longdouble for cross-face matching
    delta = np.longdouble(DD_PI) / (2 * ne)             # element angular size
    half = np.longdouble(DD_PI) / 4
    gx_ld = np.asarray(gx, dtype=np.longdouble)
    # a[e, i] = -pi/4 + delta*(ex + (x_i+1)/2)
    a = (-half + delta * (ex[:, None] + (gx_ld[None, :] + 1) / 2))
    b = (-half + delta * (ey[:, None] + (gx_ld[None, :] + 1) / 2))
    A = np.broadcast_to(a[:, :, None], (E, NP, NP))     # x1 varies with i
    B = np.broadcast_to(b[:, None, :], (E, NP, NP))     # x2 varies with j
    F = face[:, None, None]

    Xl, Yl, Zl = face_to_xyz(F, A, B)
    xyz = np.stack([np.asarray(Xl, dtype=np.float64),
                    np.asarray(Yl, dtype=np.float64),
                    np.asarray(Zl, dtype=np.float64)], axis=-1)

    lon, lat = face_to_lonlat(F, np.asarray(A, np.float64),
                              np.asarray(B, np.float64))

    # --- global point ids + assembly tables.  Min distinct-point chord
    # distance is ~0.276*delta; use quantum far below that and far above the
    # longdouble trig noise (~1e-18).  Native C++ builder when available
    # (native/gridtables.cpp), vectorized numpy otherwise —
    # identical output by construction (tested in tests/test_grid.py).
    quantum = min(1e-7, float(delta) * 1e-4)
    from .. import native as _native
    built = _native.build_point_tables(xyz.reshape(-1, 3), NP * NP, quantum)
    if built is not None:
        gid_flat, part_idx, part_mask, nbr, uniq_src = built
        gid = gid_flat.reshape(E, NP, NP)
        ngid = uniq_src.size
    else:
        gid = _union_find_gids(xyz.reshape(-1, 3), quantum).reshape(E, NP, NP)
        ngid = int(gid.max()) + 1
        gid_flat = gid.reshape(-1)
        part_idx, part_mask, nbr, uniq_src = _tables_from_gids(
            gid_flat, ngid, E)
    expected = 6 * (ne * (NP - 1)) ** 2 + 2
    if ngid != expected:
        raise RuntimeError(
            f"grid point identification failed: {ngid} unique points, "
            f"expected {expected}")
    # canonical numbering invariant: owner slots are in gid order
    col_of_gid = np.arange(ngid, dtype=np.int64)

    # --- metric, two passes with area renormalization
    # (cf. metric_atomic cube_mod.F90:241 and prim_init1 area correction
    #  prim_driver_mod.F90:265-283)
    Af = np.asarray(A, dtype=np.float64)
    Bf = np.asarray(B, dtype=np.float64)
    Jhalf = float(delta) / 2.0          # bilinear ref->face Jacobian (square)
    Dv = _vmap_D(F, Af, Bf)             # [E,NP,NP,2,2]
    D = Dv * Jhalf
    detD = D[..., 0, 0] * D[..., 1, 1] - D[..., 0, 1] * D[..., 1, 0]
    metdet = np.abs(detD)

    mp = np.asarray(gw)[:, None] * np.asarray(gw)[None, :]
    mp = np.broadcast_to(mp, (E, NP, NP)).copy()

    # area correction: deterministic, math.fsum over all element integrals
    import math
    area = math.fsum((mp * metdet).reshape(-1).tolist())
    alpha = 4 * DD_PI / area

    D = D * np.sqrt(alpha)
    detD = detD * alpha
    metdet = metdet * alpha
    rmetdet = 1.0 / metdet
    Dinv = np.empty_like(D)
    Dinv[..., 0, 0] = D[..., 1, 1] / detD
    Dinv[..., 0, 1] = -D[..., 0, 1] / detD
    Dinv[..., 1, 0] = -D[..., 1, 0] / detD
    Dinv[..., 1, 1] = D[..., 0, 0] / detD

    spheremp = mp * metdet
    dss_sp = _dss_sum_np(spheremp.reshape(-1), gid_flat, ngid)
    rspheremp = (1.0 / dss_sp).reshape(E, NP, NP)

    return Grid(
        ne=ne, nelem=E, face=face, ex=ex, ey=ey, lon=lon, lat=lat,
        D=D, Dinv=Dinv, metdet=metdet, rmetdet=rmetdet, mp=mp,
        spheremp=spheremp, rspheremp=rspheremp,
        gll_w=np.asarray(gw), gll_x=np.asarray(gx), deriv=deriv,
        gid=gid, ngid=ngid, part_idx=part_idx, part_mask=part_mask,
        nbr=nbr, uniq_src=uniq_src, col_of_gid=col_of_gid,
        alpha=float(alpha),
    )
