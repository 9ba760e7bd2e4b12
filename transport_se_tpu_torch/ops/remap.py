"""The T-layout PPM remap kernel (K3), the remap's health kernel, and their
plain PyTorch versions.

Port of `transport_se_tpu/ops/pallas_ppm.py` (`_kernel` via
`remap_q_ppm_pallas_t`): the monotone PPM remap of every (element, point,
tracer) column of Qt [E, 16, q*k] (level minor) from the Lagrangian widths
dp_star [E, 16, k] to the reference widths dp_ref [E, 16, k].

Same math as `ops/ppm.remap_q_ppm`, in the JAX kernel's formulation:
level-only quantities (interface sums, the PPM width coefficients, the cell
search over shifts -2..+3, z2) are computed once per (element, point) at
level width; the tracer part then runs per lane.  Mirrored ghosts reduce
to clamped one-level shifts with the mirror identities of the JAX kernel
(pallas_ppm.py:177-189); alg 2 makes the two cells at each column end
piecewise constant.  Prefix sums run sequentially from the bottom, in both
the kernel (`csrc/ppm.cu`) and the plain version below, so the two agree
to the last bit on the card.

`remap_health_t` is the check that guards K3's cell search, once a
subcycle: the least layer width and the fast search's window margin
(`ops/ppm.ppm_fast_margin`), in one pass over dp_star and dp_ref
(`csrc/health.cu`).  Its plain version sums the interfaces sequentially, as
the kernel does, so the two agree to the last bit on the card.

Inside `counters.counting()` the remap counts its columns and those that
K3 walks again with IEEE divisions (an operand of its inline divisions out
of their range, `csrc/common.cuh` Bits): the kernel in its counting form,
the plain version by the same rule (`rewalked`).

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel, anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build, counters
from ..counters import bump
from .euler import _DTYPES, _check, _device_kind, _stream
from .ppm import _shift_left_clamp as _shl
from .ppm import _shift_right_clamp as _shr

N2 = 16
# the health kernel's blocks per SM are at most the card's resident-block
# limit (32 on sm_90): its block-minimum buffer holds that many per SM
HEALTH_PARTS_PER_SM = 32


# The inline divisions' operand ranges (csrc/common.cuh Bits) as bounds on
# the bits of the values, read as the signed integers of their width: a
# negative value's bits are negative, so they lie outside too.
_BITS = {
    torch.float32: dict(view=torch.int32, mag=0x7fffffff,
                        q=(0x0d800000, 0x71800000),   # 2^-100, 2^100
                        d=(0x35800000, 0x49800000),   # 2^-20, 2^20
                        x=(0x03800000, 0x7b800000)),  # 2^-+120
    torch.float64: dict(view=torch.int64, mag=0x7fffffffffffffff,
                        q=(0x26f0000000000000, 0x58f0000000000000),  # 2^-+400
                        d=(0x26f0000000000000, 0x58f0000000000000),
                        x=(0x0df0000000000000, 0x71f0000000000000)),  # 2^-+800
}


def _outside(x, which):
    """x outside the range `which` of _BITS (tse::outside)."""
    b = _BITS[x.dtype]
    v = x.view(b["view"])
    lo, hi = b[which]
    return (v < lo) | (v > hi)


def _outside_abs(x, which):
    """tse::outside_abs: outside, except +0 and the negative of a value
    inside."""
    b = _BITS[x.dtype]
    v = x.view(b["view"])
    m = v & b["mag"]
    lo, hi = b[which]
    return (v != 0) & ((m < lo) | (m > hi))


def rewalked(q, dp_star, dd):
    """The columns K3 walks again with IEEE divisions, bool [..., nq]: a
    width of the row outside the divisions' range, or at some level a mass
    q, or a dd*dd of the limiter, outside its range.  q and dd [..., nq,
    nk], dp_star [..., nk]."""
    row = _outside(dp_star, "d").any(-1)[..., None]
    return (row | _outside_abs(q, "q").any(-1)
            | _outside_abs(dd * dd, "x").any(-1))


def _cumsum_seq(x):
    """Inclusive prefix over the last axis, summed bottom-up in order."""
    out = torch.empty_like(x)
    acc = x[..., 0]
    out[..., 0] = acc
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
        out[..., k] = acc
    return out


def _level_terms(d, dp2):
    """Per-level quantities of one remap, all [..., nk]:
    (K12, K13, K4, K59, K510, Y0, Y1, Y2, shift)."""
    nk = d.shape[-1]
    kidx = torch.arange(nk, device=d.device)
    top = kidx == nk - 1
    pio_r = _cumsum_seq(d)
    pio_l = pio_r - d
    tgt = torch.where(top, pio_r, _cumsum_seq(dp2))

    dm1, dp1 = _shr(d), _shl(d)
    c1 = d / (dm1 + d + dp1)
    c2 = (2.0 * dm1 + d) / (dp1 + d)
    c3 = (d + 2.0 * dp1) / (dm1 + d)
    djp1 = dp1
    # second mirror width at the top: dpo(nlev+2) = dpo(nlev-1)
    djp2 = torch.where(top, dm1, _shl(dp1))
    one = d.new_full((), 1.0)
    c4 = d / (d + djp1)
    c5 = one / (dm1 + d + djp1 + djp2)
    c6 = (2.0 * djp1 * d) / (d + djp1)
    c7 = (dm1 + d) / (2.0 * d + djp1)
    c8 = (djp2 + djp1) / (2.0 * djp1 + d)
    c9 = d * (dm1 + d) / (2.0 * d + djp1)
    c10 = djp1 * (djp1 + djp2) / (d + 2.0 * djp1)
    c678 = c5 * c6 * (c7 - c8)

    # cell search: the new interface k+1 lies in source cell k+shift
    up1 = (pio_r <= tgt) & (kidx < nk - 1)
    up2 = (_shl(pio_r) <= tgt) & up1 & (kidx < nk - 2)
    up3 = (_shl(pio_r, 2) <= tgt) & up2 & (kidx < nk - 3)
    dn1 = pio_l > tgt
    dn2 = (_shr(pio_l) > tgt) & dn1 & (kidx >= 2)
    shift = torch.where(
        dn2, -2, torch.where(dn1, -1, torch.where(
            up3, 3, torch.where(up2, 2, torch.where(up1, 1, 0)))))
    # inside the column for any non-negative widths; the clamp keeps a
    # corrupt input (which remap_health_t reports) from reading outside
    shift = torch.clamp(kidx + shift, 0, nk - 1) - kidx
    src = kidx + shift
    dpo_kk = torch.gather(d, -1, src)
    pio_kk = torch.gather(pio_l, -1, src)
    z2 = (tgt - (pio_kk + 0.5 * dpo_kk)) / dpo_kk
    x1 = -0.5
    Y0 = (z2 - x1) * dpo_kk
    Y1 = (z2 * z2 - x1 * x1) * (0.5 * dpo_kk)
    Y2 = (z2 * z2 * z2 - x1 * x1 * x1) * (dpo_kk / d.new_full((), 3.0))
    return (c1 * c2, c1 * c3, c4 + c678, c5 * c9, c5 * c10, Y0, Y1, Y2,
            shift)


def remap_q_ppm_t_plain(Qt, dp_star, dp_ref, alg=0):
    """Plain PyTorch version of the T-layout remap; see remap_q_ppm_t."""
    bump("remap_q_ppm_t_plain")
    E, _, qk = Qt.shape
    nk = dp_star.shape[-1]
    nq = qk // nk
    K12, K13, K4, K59, K510, Y0, Y1, Y2, shift = (
        t[:, :, None, :] for t in _level_terms(dp_star, dp_ref))
    d = dp_star[:, :, None, :]
    q = Qt.reshape(E, N2, nq, nk)
    kidx = torch.arange(nk, device=Qt.device)
    top, bot = kidx == nk - 1, kidx == 0

    a = q / d
    am1, ap1 = _shr(a), _shl(a)
    da = K12 * (ap1 - a) + K13 * (a - am1)
    dma = torch.minimum(torch.minimum(torch.abs(da),
                                      2.0 * torch.abs(a - am1)),
                        2.0 * torch.abs(ap1 - a)) * torch.sign(da)
    dma = torch.where((ap1 - a) * (a - am1) <= 0.0, 0.0, dma)
    # ghost dma above the top is 0
    dma_jp1 = torch.where(top, 0.0, _shl(dma))
    ai_r = a + K4 * (ap1 - a) - K59 * dma_jp1 + K510 * dma
    sixth = 1.0 / 6.0
    ai_l = torch.where(bot, a - sixth * dma, _shr(ai_r))

    al, ar = ai_l, ai_r
    extremum = (ar - a) * (a - al) <= 0.0
    al = torch.where(extremum, a, al)
    ar = torch.where(extremum, a, ar)
    dd = ar - al
    if counters.counting_on():
        again = rewalked(q, dp_star, dd)
        counters.work_add(Qt.device, torch.stack(
            [torch.tensor(again.numel(), device=Qt.device),
             again.sum()]).to(torch.int64), "remap")
    t = dd * (a - 0.5 * (al + ar))
    curv = dd * dd / a.new_full((), 6.0)
    al = torch.where(t > curv, 3.0 * a - 2.0 * ar, al)
    ar = torch.where(t < -curv, 3.0 * a - 2.0 * al, ar)
    coef0 = 1.5 * a - 0.25 * (al + ar)
    coef1 = ar - al
    coef2 = -6.0 * a + 3.0 * (al + ar)
    if alg == 2:
        edge = (kidx < 2) | (kidx >= nk - 2)
        coef0 = torch.where(edge, a, coef0)
        coef1 = torch.where(edge, 0.0, coef1)
        coef2 = torch.where(edge, 0.0, coef2)

    # exclusive prefix: the mass below each cell
    masso = torch.cat([torch.zeros_like(q[..., :1]),
                       _cumsum_seq(q)[..., :-1]], dim=-1)
    src = (kidx + shift).expand(E, N2, nq, nk)
    pick = lambda x: torch.gather(x, -1, src)  # noqa: E731
    massn = ((pick(masso) + pick(coef0) * Y0) + pick(coef1) * Y1) \
        + pick(coef2) * Y2
    out = massn - torch.where(bot, 0.0, _shr(massn))
    return out.reshape(E, N2, qk)


def remap_q_ppm_t(Qt, dp_star, dp_ref, alg=0):
    """Monotone PPM remap of T-layout tracer mass.

    Qt [E,16,q*k] (level minor), dp_star/dp_ref [E,16,k] source and target
    widths with equal column totals.  The cell search covers interface
    displacements of -2..+2 cells; `remap_health_t` is the guard that the
    run stays inside it.  alg 0/1: mirrored ghosts; 2:
    piecewise-constant end cells.  Returns the remapped Qt, conserving each
    column's mass.  Inside counters.counting() it launches K3's counting
    form, which adds the columns and the columns walked again into
    counters.work_buffer(device, "remap") (the plain version adds the same
    numbers)."""
    kind = _device_kind(Qt)
    E, _, qk = Qt.shape
    nk = dp_star.shape[-1]
    dev, f = Qt.device, Qt.dtype
    if nk < 4 or qk % nk:
        raise ValueError(f"lanes {qk} are not a multiple of nlev {nk} >= 4")
    if alg not in (0, 1, 2):
        raise ValueError(f"vert_remap_q_alg {alg} is not 0, 1 or 2")
    _check("Qt", Qt, (E, N2, qk), f, dev)
    _check("dp_star", dp_star, (E, N2, nk), f, dev)
    _check("dp_ref", dp_ref, (E, N2, nk), f, dev)
    if kind == "cpu":
        return remap_q_ppm_t_plain(Qt, dp_star, dp_ref, alg=alg)
    out = torch.empty_like(Qt)
    fn = _build.entry("tse_remap_q_ppm_t", _DTYPES[f])
    work = counters.work_buffer(dev, "remap") if counters.counting_on() \
        else None
    code = fn(Qt.data_ptr(), dp_star.data_ptr(), dp_ref.data_ptr(),
              out.data_ptr(), E, qk // nk, nk, int(alg), _stream(dev),
              None if work is None else work.data_ptr(), counters.WORK_SLOTS)
    _build.check(code, "remap_q_ppm_t")
    bump("remap_q_ppm_t")
    return out


def kernel_config(nq, nk, dtype):
    """The kernel's launch shape for nq tracers of nk levels on the current
    card: its form ("whole": whole-column tiles, "streamed": columns
    streamed through shared memory in chunks), rows a tile, threads and
    shared-memory bytes per block, resident blocks per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), levels a chunk (nk for
    whole columns), walking threads per block, and walking threads per SM.
    Needs a CUDA device."""
    buf = (ctypes.c_int * 6)()
    fn = _build.entry("tse_ppm_config", _DTYPES[dtype])
    _build.check(fn(int(nq), int(nk), buf), "ppm_config")
    out = dict(zip(("rows", "threads", "smem_bytes", "blocks_per_sm",
                    "chunk", "walkers"), buf))
    out["form"] = "streamed" if out["chunk"] else "whole"
    out["chunk"] = out["chunk"] or int(nk)
    out["walkers_per_sm"] = out["blocks_per_sm"] * min(
        out["walkers"], out["rows"] * int(nq))
    return out


def remap_health_t_plain(dp_star, dp_ref):
    """Plain PyTorch version of remap_health_t."""
    bump("remap_health_t_plain")
    nk = dp_star.shape[-1]
    pio = torch.cat([torch.zeros_like(dp_star[..., :1]),
                     _cumsum_seq(dp_star)], dim=-1)
    tgt = _cumsum_seq(dp_ref)[..., :-1]              # pin[1..nk-1]
    j = torch.arange(nk - 1, device=dp_star.device)
    lo = pio[..., torch.clamp(j - 2, min=0)]
    hi = pio[..., torch.clamp(j + 4, max=nk)]
    return torch.minimum(dp_star.min(),
                         torch.minimum(tgt - lo, hi - tgt).min())


def remap_health_t(dp_star, dp_ref):
    """The remap's health value, 0-dim: the least width of dp_star and
    the fast cell search's margin (`ops/ppm.ppm_fast_margin`), the least
    over the interior interfaces j of min(tgt - pio[max(j-2, 0)],
    pio[min(j+4, k)] - tgt), tgt = pin[j+1], with pio and pin the
    interface sums of dp_star and dp_ref from the bottom.  Below 0: a
    negative width, or an interface displaced out of K3's -2..+2 cell
    window.  A NaN width gives NaN.

    dp_star, dp_ref [E,16,k] (k >= 4), contiguous, of one dtype on one
    device."""
    if not isinstance(dp_star, torch.Tensor) or dp_star.dim() != 3:
        raise ValueError(f"dp_star: expected [E, {N2}, k], got "
                         f"{tuple(getattr(dp_star, 'shape', ()))}")
    kind = _device_kind(dp_star)
    E, _, nk = dp_star.shape
    dev, f = dp_star.device, dp_star.dtype
    if E < 1 or nk < 4:
        raise ValueError(f"dp_star: {E} elements of {nk} levels, need at "
                         "least 1 of 4")
    _check("dp_star", dp_star, (E, N2, nk), f, dev)
    _check("dp_ref", dp_ref, (E, N2, nk), f, dev)
    if kind == "cpu":
        return remap_health_t_plain(dp_star, dp_ref)
    nparts = HEALTH_PARTS_PER_SM * torch.cuda.get_device_properties(
        dev).multi_processor_count
    part = torch.empty(nparts, dtype=f, device=dev)
    out = torch.empty((), dtype=f, device=dev)
    fn = _build.entry("tse_remap_health_t", _DTYPES[f])
    code = fn(dp_star.data_ptr(), dp_ref.data_ptr(), part.data_ptr(),
              out.data_ptr(), E * N2, nk, nparts, _stream(dev))
    _build.check(code, "remap_health_t")
    bump("remap_health_t")
    return out


def health_kernel_config(nk, dtype):
    """The health kernel's launch shape for nk levels on the current card:
    threads (columns) and shared-memory bytes per block, resident blocks
    per SM and the blocks of a launch over a large field.  Needs a CUDA
    device."""
    buf = (ctypes.c_int * 4)()
    fn = _build.entry("tse_remap_health_config", _DTYPES[dtype])
    _build.check(fn(int(nk), buf), "remap_health_config")
    return dict(zip(("threads", "smem_bytes", "blocks_per_sm", "blocks"),
                    buf))
