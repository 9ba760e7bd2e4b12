"""Native (C++) grid-table builder, loaded via ctypes.

The port's own copy of `transport_se_tpu/native` (the same
`gridtables.cpp`): point-coincidence grouping + DSS partner tables +
element neighbor lists + unique-point owners, O(N) with hashing; the numpy
fallback in `grid/cubesphere.py` gives identical tables.

The shared library is compiled on first use with g++ into the package's
`_build/` directory (never beside the source), named by a hash of the
source and the flags.  g++ writes to a name of its own process and the
result is moved into place with `os.replace`, so processes that build at
the same time (pytest workers) never load a half-written library.  If no
compiler is available the callers fall back to the numpy implementation, so
the native path is an accelerator, never a requirement.  Set
TRANSPORT_SE_NO_NATIVE=1 to force the fallback (the tests compare both).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "gridtables.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return BUILD_DIR / f"_gridtables_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    cmd = ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (subprocess.SubprocessError, OSError):
        tmp.unlink(missing_ok=True)
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if os.environ.get("TRANSPORT_SE_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.build_point_tables.restype = ctypes.c_int64
        lib.build_point_tables.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return _lib


def build_point_tables(xyz: np.ndarray, np2: int, quantum: float):
    """Run the native table builder.

    Returns (gid[N] int32, part_idx[N,3] int32, part_mask[N,3] bool,
    nbr[E,9] int32, uniq_src[ngid] int64) or None if unavailable.
    Raises RuntimeError on grouping failure (same conditions as the
    numpy path's multiplicity/neighbor checks).
    """
    lib = get_lib()
    if lib is None:
        return None
    xyz = np.ascontiguousarray(xyz, dtype=np.float64)
    n = xyz.shape[0]
    E = n // np2
    gid = np.empty(n, dtype=np.int32)
    part_idx = np.empty((n, 3), dtype=np.int32)
    part_mask = np.empty((n, 3), dtype=np.uint8)
    nbr = np.empty((E, 9), dtype=np.int32)
    uniq_src = np.empty(n, dtype=np.int64)
    ngid = np.zeros(1, dtype=np.int64)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    rc = lib.build_point_tables(
        p(xyz, ctypes.c_double), n, np2, quantum,
        p(gid, ctypes.c_int32), p(part_idx, ctypes.c_int32),
        p(part_mask, ctypes.c_uint8), p(nbr, ctypes.c_int32),
        p(uniq_src, ctypes.c_int64), p(ngid, ctypes.c_int64))
    if rc == -1:
        raise RuntimeError("grid point multiplicity > 4 (native)")
    if rc == -2:
        raise RuntimeError("element has > 8 neighbors (native)")
    if rc != 0:
        raise RuntimeError(f"native table builder failed rc={rc}")
    k = int(ngid[0])
    return gid, part_idx, part_mask.astype(bool), nbr, uniq_src[:k].copy()
