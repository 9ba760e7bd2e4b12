"""Limiter 8 on rows of 16 GLL points (K10), and the 2D limiters.

Port of `transport_se_tpu/ops/limiter.py` (reference:
prim_advection_mod.F90:976 `limiter_optim_iter_full`, :1100
`limiter2d_minmax`, :1188 `limiter2d_zero`) and of its Pallas kernel
`transport_se_tpu/ops/pallas_limiter.py` (`_limiter_kernel`, which that
module calls a drop-in replacement for `limiter_optim_iter_full`).

`limiter_optim_iter_full` limits Q = ptens/dpmass with the weights
c = sphweights*dpmass, per row of 16 points:

* the bounds are first relaxed so that the row's mass fits between them,
  and the relaxed bounds are returned (later RK stages see them);
* each iteration clips x to [minp, maxp] and leaves the row at that clip
  once the clipped mass |addmass| <= 5e-14*|mass|; otherwise it spreads
  addmass over the points that can take it, weighted by c;
* at most 15 iterations (np*np - 1), the last without a trailing clip;
* a row whose weights sum to <= 0 returns ptens unchanged.

The kernel is `csrc/limiter.cu`; it runs the clip-and-redistribute body of
`csrc/common.cuh` that K1 runs too.  The plain version below runs that
body's plain version, `ops.euler.limiter_iterate_plain`, which K1's plain
version runs as well: every 16-point sum is the `_sum16` pairwise tree, so
kernel and plain version agree to the last bit.  Inside
`counters.counting()` the wrapper launches K10's counting form, which adds
the limiter's passes, rows and capped rows over the valid rows into
`counters.work_buffer` (the `limiter` group, which K1 adds to on the T
path; a subcycle runs one of the two), and the plain version adds the same
numbers; outside it K10 runs its form without counting.

`limiter_optim_stage` is the std-layout euler stage's call: its weights
spheremp [E, 16] and thickness dp_star [E, k, 16] are shared by the rows of
every tracer (and, for spheremp, every level), and the kernel reads them in
place instead of from [E, q, k, 16] copies.

The 2D limiters are plain PyTorch only: the JAX package keeps them as
tested operations that no stage calls (limiter options 0 and 4 apply no
limiter in the reference's euler_step).

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel, anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, counters
from ..counters import bump
from .euler import (MAX_ITER, TOL_LIMITER, _DTYPES, _check, _device_kind,
                    _stream, limiter_counts, limiter_iterate_plain)

N2 = 16


def limiter_optim_iter_full_plain(ptens, sphweights, minp, maxp, dpmass):
    """Plain PyTorch version of limiter 8; see limiter_optim_iter_full.
    sphweights and dpmass may be any shapes that broadcast to ptens'."""
    bump("limiter_optim_plain")
    count = counters.counting_on()
    x, minp, maxp, valid, *conv = limiter_iterate_plain(
        ptens / dpmass, sphweights * dpmass, minp, maxp, count=count)
    if count:
        # valid has the weights' shape, which may broadcast over rows
        counters.work_add(x.device, limiter_counts(
            conv[0], valid.expand(conv[0].shape), MAX_ITER))
    out = torch.where(valid[..., None], x * dpmass, ptens)
    return out, minp, maxp


def _launch(ptens, sphweights, dpmass, minp, maxp, sph_rep, sph_inner,
            dp_rep, dp_inner):
    """K10 on the rows of ptens; the weight/thickness row of ptens row r is
    (r // (rep*inner))*inner + r % inner (csrc/limiter.cu bcast_row).
    Inside counters.counting() it launches the counting form."""
    n = ptens.numel() // N2
    if n == 0:
        raise ValueError("limiter_optim: no rows")
    for name, t in (("ptens", ptens), ("sphweights", sphweights),
                    ("dpmass", dpmass)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned (the kernel "
                             "reads rows with 16-byte vector loads)")
    out = torch.empty_like(ptens)
    minp_o = torch.empty_like(minp)
    maxp_o = torch.empty_like(maxp)
    count = ()
    name = "tse_limiter_optim"
    if counters.counting_on():
        count = (counters.work_buffer(ptens.device).data_ptr(),
                 counters.WORK_SLOTS)
        name = "tse_limiter_optim_count"
    fn = _build.entry(name, _DTYPES[ptens.dtype])
    code = fn(ptens.data_ptr(), sphweights.data_ptr(), dpmass.data_ptr(),
              minp.data_ptr(), maxp.data_ptr(), out.data_ptr(),
              minp_o.data_ptr(), maxp_o.data_ptr(), n, sph_rep, sph_inner,
              dp_rep, dp_inner, TOL_LIMITER, _stream(ptens.device), *count)
    _build.check(code, "limiter_optim")
    bump("limiter_optim")
    return out, minp_o, maxp_o


def limiter_optim_iter_full(ptens, sphweights, minp, maxp, dpmass,
                            chunks: int = 0):
    """Limiter 8 on Q = ptens/dpmass with the weights sphweights*dpmass.

    ptens, sphweights, dpmass: [..., 16] contiguous, one dtype and device;
    minp, maxp: [...] the bounds.  Returns (ptens', minp', maxp'): the
    limited tracer mass and the relaxed bounds.

    chunks is the JAX signature's convergence grouping; every row's result
    is independent of the others, so it changes nothing here and is
    accepted only to keep the signature.  The iteration always runs to
    convergence or 15 iterations (cfg.limiter_iter_cap does not apply, as
    on the JAX package's std-layout path).
    """
    del chunks
    kind = _device_kind(ptens)
    shape = tuple(ptens.shape)
    if not shape or shape[-1] != N2:
        raise ValueError(f"ptens: shape {shape}, expected [..., {N2}]")
    dev, f = ptens.device, ptens.dtype
    for name, t, s in (("ptens", ptens, shape),
                       ("sphweights", sphweights, shape),
                       ("dpmass", dpmass, shape),
                       ("minp", minp, shape[:-1]),
                       ("maxp", maxp, shape[:-1])):
        _check(name, t, s, f, dev)
    if kind == "cpu":
        return limiter_optim_iter_full_plain(ptens, sphweights, minp, maxp,
                                             dpmass)
    return _launch(ptens, sphweights, dpmass, minp, maxp, 1, 1, 1, 1)


def limiter_optim_stage(ptens, spheremp, dp_star, minp, maxp, plain=False):
    """Limiter 8 of a std-layout euler stage: limiter_optim_iter_full with
    sphweights = spheremp and dpmass = dp_star broadcast over the tracers.

    ptens [E, q, k, 16]; spheremp [E, 16]; dp_star [E, k, 16]; minp, maxp
    [E, q, k]; all contiguous.  plain runs the plain version on any device.
    """
    kind = _device_kind(ptens)
    E, q, k, n2 = ptens.shape
    if n2 != N2:
        raise ValueError(f"ptens: shape {tuple(ptens.shape)}, expected "
                         f"[E, q, k, {N2}]")
    dev, f = ptens.device, ptens.dtype
    for name, t, s in (("ptens", ptens, (E, q, k, N2)),
                       ("spheremp", spheremp, (E, N2)),
                       ("dp_star", dp_star, (E, k, N2)),
                       ("minp", minp, (E, q, k)),
                       ("maxp", maxp, (E, q, k))):
        _check(name, t, s, f, dev)
    if plain or kind == "cpu":
        return limiter_optim_iter_full_plain(
            ptens, spheremp[:, None, None], minp, maxp, dp_star[:, None])
    return _launch(ptens, spheremp, dp_star, minp, maxp, q * k, 1, q, k)


def kernel_config(dtype):
    """The kernel's launch shape on the current card: lanes per row,
    threads per block and resident blocks per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Needs a CUDA
    device."""
    buf = (ctypes.c_int * 3)()
    fn = _build.entry("tse_limiter_config", _DTYPES[dtype])
    _build.check(fn(buf), "limiter_config")
    return dict(zip(("row_lanes", "threads", "blocks_per_sm"), buf))


def limiter2d_minmax(qdp, dp, spheremp, qmin, qmax):
    """Mass-conserving min/max limiter over each element level
    (limiter_option 4's routine; no stage calls it).

    qdp/dp/spheremp [..., 16]; qmin/qmax [...].  Returns the limited qdp
    (same mass sum(qdp*spheremp) per level)."""
    c = dp * spheremp
    q = qdp / dp
    mass = (qdp * spheremp).sum(-1)
    area = c.sum(-1)
    one = qdp.new_full((), 1.0)

    def one_pass(q, bound, excess_mass, toward_bound):
        """Clip-and-rescale: toward_bound=+1 is the max pass on
        (bound - q), -1 the min pass on (q - bound)."""
        work = toward_bound * (bound[..., None] - q)
        s = torch.where(excess_mass < 0, -one, one)
        w = work * s[..., None]
        wpos = torch.clamp(w, min=0.0)
        mass_new = (wpos * c).sum(-1)
        scale = torch.where(mass_new > 0, torch.abs(excess_mass)
                            / torch.where(mass_new > 0, mass_new, one), one)
        w = wpos * scale[..., None] * s[..., None]
        return bound[..., None] - toward_bound * w

    # max pass (original mass; the pass itself conserves it)
    over = q.amax(-1) > qmax
    q = torch.where(over[..., None],
                    one_pass(q, qmax, area * qmax - mass, 1.0), q)
    # the min pass reads the updated q but the top-of-routine mass
    under = q.amin(-1) < qmin
    q = torch.where(under[..., None],
                    one_pass(q, qmin, mass - area * qmin, -1.0), q)
    return q * dp


def limiter2d_zero(qdp_weighted):
    """Mass-conserving zero limiter over each element level; the input is
    spheremp*Qdp flattened over the element, [..., 16]."""
    q = qdp_weighted
    one = q.new_full((), 1.0)
    mass = q.sum(-1, keepdim=True)
    sgn = torch.where(mass < 0, -one, one)
    q = q * sgn
    qpos = torch.clamp(q, min=0.0)
    mass_new = qpos.sum(-1, keepdim=True)
    scale = torch.where(mass_new > 0, torch.abs(mass)
                        / torch.where(mass_new > 0, mass_new, one), 0.0)
    return qpos * scale * sgn
