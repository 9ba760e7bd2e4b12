"""Space-filling-curve ordering of elements for compact domain decomposition.

The port's own copy of `transport_se_tpu/grid/sfc.py` (numpy only), kept
bit-identical to it (tests/test_torch_host.py).

Plays the role of the reference's per-face Hilbert-type curve used for
partitioning (reference: src/share/spacecurve_mod.F90:1011 `GenSpaceCurve`,
:1218 `genspacepart`).  We use a generalized Hilbert curve that works for any
rectangle size (the reference is restricted to grid sizes factorable into
2,3,5); spatial locality is what matters — shards get contiguous chunks of the
curve, so shard boundaries have small perimeter and the halo payload is
minimal.
"""

from __future__ import annotations

import numpy as np


def _sgn(v: int) -> int:
    return (v > 0) - (v < 0)


def _gilbert(x, y, ax, ay, bx, by, out):
    """Generalized Hilbert curve over a w x h rectangle; appends (x, y)."""
    w = abs(ax + ay)
    h = abs(bx + by)
    dax, day = _sgn(ax), _sgn(ay)   # unit major direction
    dbx, dby = _sgn(bx), _sgn(by)   # unit orthogonal direction

    if h == 1:
        for _ in range(w):
            out.append((x, y))
            x += dax
            y += day
        return
    if w == 1:
        for _ in range(h):
            out.append((x, y))
            x += dbx
            y += dby
        return

    ax2, ay2 = ax // 2, ay // 2
    bx2, by2 = bx // 2, by // 2
    w2 = abs(ax2 + ay2)
    h2 = abs(bx2 + by2)

    if 2 * w > 3 * h:
        if (w2 % 2) and (w > 2):
            ax2 += dax
            ay2 += day
        _gilbert(x, y, ax2, ay2, bx, by, out)
        _gilbert(x + ax2, y + ay2, ax - ax2, ay - ay2, bx, by, out)
    else:
        if (h2 % 2) and (h > 2):
            bx2 += dbx
            by2 += dby
        _gilbert(x, y, bx2, by2, ax2, ay2, out)
        _gilbert(x + bx2, y + by2, ax, ay, bx - bx2, by - by2, out)
        _gilbert(x + (ax - dax) + (bx2 - dbx),
                 y + (ay - day) + (by2 - dby),
                 -bx2, -by2, -(ax - ax2), -(ay - ay2), out)


def gilbert_curve(w: int, h: int) -> np.ndarray:
    """Return array [w*h, 2] of (x, y) visiting order of a w x h grid."""
    out: list[tuple[int, int]] = []
    if w >= h:
        _gilbert(0, 0, w, 0, 0, h, out)
    else:
        _gilbert(0, 0, 0, h, w, 0, out)
    return np.asarray(out, dtype=np.int64)


def face_sfc_index(ne: int) -> np.ndarray:
    """idx[ex, ey] = position of element (ex, ey) along the face curve."""
    curve = gilbert_curve(ne, ne)
    idx = np.empty((ne, ne), dtype=np.int64)
    idx[curve[:, 0], curve[:, 1]] = np.arange(ne * ne)
    return idx
