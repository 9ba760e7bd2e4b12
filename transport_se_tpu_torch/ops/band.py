"""The banded face DSS of one shard with its fused epilogues (K7).

Port of `transport_se_tpu/ops/pallas_band.py` `dss_band_pallas` (the
kernel `_band_kernel`; reference edge_mod.F90:366/648, prim_advection_mod
.F90:929-960 make_C0 scale, euler_step :750-778 bound prep,
viscosity_mod.F90:289-351 Laplacian).  The sharded face path
(parallel/halo.py ShardedDssTables) runs every DSS of a shard through it,
in place of the single-device face DSS K4.

`dss_band` launches the CUDA kernel of `csrc/band.cu` on a CUDA tensor
and runs `dss_band_plain` on a CPU tensor; anything else raises.  The
plain version is the banded shifted-slice assembly of
parallel/face_sharded.py (`dss_sum_t_face_band`) followed by the
epilogues in K4's plain operation order; the kernel reads each partner
through the shard's role table instead, and adds in the band's order, so
the two agree to the last bit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..counters import bump
from ..parallel.face_sharded import ShardedFaceTables, dss_sum_t_face_band
from .euler import _DTYPES, N2, _check, _device_kind, _lap_wk, _met_rows, \
    _stream

__all__ = ["dss_band", "dss_band_plain", "kernel_config"]


def _halo_of(x, ext, t: ShardedFaceTables):
    """The halo rows of ext: ext is cat([x, halo]) [eloc+nhalo, 16, L] or
    the halo [nhalo, 16, L] alone (the sharded tables pass it so, which
    saves assembling ext)."""
    n = ext.shape[0]
    if n == t.eloc + t.nhalo:
        return ext[t.eloc:]
    if n == t.nhalo:
        return ext
    raise ValueError(f"ext has {n} elements: expected eloc+nhalo = "
                     f"{t.eloc + t.nhalo} or nhalo = {t.nhalo}")


def _nq(L, dp, nq):
    nk = dp.shape[-1]
    if L % nk or (nq is not None and nq * nk != L):
        raise ValueError(f"lanes {L} are not nq*nk = {nq}*{nk}")
    return L // nk


def dss_band_plain(x, ext, t: ShardedFaceTables, rsp=None, dp=None,
                   nq=None, lap=False):
    """Plain PyTorch version of K7; see dss_band."""
    bump("dss_band_plain")
    halo = _halo_of(x, ext, t)
    E, nn, L = x.shape
    res = dss_sum_t_face_band(x, torch.cat([x, halo]), t)
    if rsp is not None:
        res = res * rsp[:, :, None]
    if dp is None:
        return res
    nq = _nq(L, dp, nq)
    q = (res.reshape(E, nn, nq, -1) / dp[:, :, None, :]).reshape(x.shape)
    ret = (res, q.amin(dim=1), q.amax(dim=1))
    if lap:
        s00, s01, s11 = _met_rows(t.met, "s00", "s01", "s11")
        ret += (_lap_wk(q, s00, s01, s11, t.deriv),)
    return ret


def dss_band(x, ext, t: ShardedFaceTables, rsp=None, dp=None, nq=None,
             lap=False):
    """Banded face-shift DSS of one shard's local field x [eloc, 16, L]
    (raster face order) with the fused epilogues of the Pallas band
    kernel, in this order:

    ext: cat([x, halo]) [eloc+nhalo, 16, L], or the halo alone;
    rsp [eloc, 16]: scale by rspheremp (make_C0);
    dp [eloc, 16, nk]: also qmin/qmax [eloc, L], the min/max over the 16
        points of q = out/dp, dp repeated over the nq = L/nk tracers
        (needs rsp);
    lap: also the weak Laplacian of q with t.met and t.deriv (needs dp).

    Returns out, or (out, qmin, qmax), or (out, qmin, qmax, lap), each
    over the eloc local elements."""
    kind = _device_kind(x)
    E, _, L = x.shape
    dev, f = x.device, x.dtype
    if lap and dp is None:
        raise ValueError("lap fusion requires dp")
    if dp is not None and rsp is None:
        raise ValueError("minmax fusion requires rsp")
    if E != t.eloc:
        raise ValueError(f"x has {E} elements, the tables {t.eloc}")
    _check("x", x, (E, N2, L), f, dev)
    halo = _halo_of(x, ext, t)
    _check("halo", halo, (t.nhalo, N2, L), f, dev)
    _check("role", t.role, (E, N2, 3), torch.int32, dev)
    nk = 1
    if rsp is not None:
        _check("rsp", rsp, (E, N2), f, dev)
    if dp is not None:
        nk = dp.shape[-1]
        nq = _nq(L, dp, nq)
        _check("dp", dp, (E, N2, nk), f, dev)
    if lap:
        if t.met is None or t.deriv is None:
            raise ValueError("lap fusion requires the tables' met and deriv")
        _check("met", t.met, (E, 10, N2), f, dev)
        _check("deriv", t.deriv, (4, 4), f, dev)
    if kind == "cpu":
        return dss_band_plain(x, ext, t, rsp=rsp, dp=dp, nq=nq, lap=lap)
    out = torch.empty_like(x)
    qmin = qmax = lapo = None
    if dp is not None:
        qmin = x.new_empty((E, L))
        qmax = x.new_empty((E, L))
    if lap:
        lapo = torch.empty_like(x)
    # bit 0 scale, bit 1 min/max, bit 2 Laplacian (csrc/band.cu)
    flags = (int(rsp is not None) | int(dp is not None) << 1
             | int(lap) << 2)

    def ptr(a):
        return None if a is None else a.data_ptr()
    fn = _build.entry("tse_dss_band", _DTYPES[f])
    code = fn(x.data_ptr(), halo.data_ptr(), t.role.data_ptr(), ptr(rsp),
              ptr(dp), ptr(t.met if lap else None),
              ptr(t.deriv if lap else None), out.data_ptr(), ptr(qmin),
              ptr(qmax), ptr(lapo), E, L, nk, flags, _stream(dev))
    _build.check(code, "dss_band")
    bump("dss_band")
    if dp is None:
        return out
    return (out, qmin, qmax) + ((lapo,) if lap else ())


def kernel_config(L, nk, dtype, rsp=True, dp=True, lap=False):
    """The kernel's launch shape for one variant (scale by rsp, min/max
    with dp, Laplacian) on L lanes of nk levels, for 16-byte-aligned
    fields, on the current card: lanes per thread, threads per block, lane
    groups per element, dynamic shared-memory bytes per block and resident
    blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Needs
    a CUDA device."""
    buf = (ctypes.c_int * 5)()
    fn = _build.entry("tse_band_config", _DTYPES[dtype])
    flags = int(rsp) | int(dp) << 1 | int(lap) << 2
    _build.check(fn(int(L), int(nk), flags, buf), "band_config")
    return dict(zip(("vec", "threads", "groups", "smem_bytes",
                     "blocks_per_sm"), buf))
