"""The T subcycle's winds from their factored basis (the wind kernel).

Replaces no TPU kernel: the JAX package's `WindBasis.eval`
(`transport_se_tpu/model/wind_basis.py`) contracts the basis with four
`jnp.einsum` calls that XLA compiles.  Here the basis of
`model.wind_basis.WindBasis` — the [T, E, 16] horizontal fields u2d, v2d,
their divergence g2d and its DSS projection gp2d, the [T, K] profiles fk
and prof = fk * dp0, and the time functions' values s [T] — becomes the
four [E, 16, K] fields the T path reads:

    un0        = (sum_i u2d[i] * fk[i] s[i]) * dp0
    vn0        = (sum_i v2d[i] * fk[i] s[i]) * dp0
    divdp      =  sum_i g2d[i] * prof[i] s[i]
    divdp_proj =  sum_i gp2d[i] * prof[i] s[i]

each sum taken left to right over the terms from the first product.  The
CUDA kernel is `csrc/wind.cu`; the plain PyTorch version below is the same
chain of broadcast products and sums, so on the card the two agree to the
last bit.

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel, anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..counters import bump
from .euler import N2, _DTYPES, _check, _device_kind, _stream


def wind_eval_t_plain(u2d, v2d, g2d, gp2d, s, fk, prof, dp0):
    """Plain PyTorch version of the wind evaluation; see wind_eval_t."""
    bump("wind_eval_t_plain")
    fks = fk * s[:, None]
    prs = prof * s[:, None]

    def contract(a2d, x):
        acc = None
        for i in range(a2d.shape[0]):
            term = a2d[i][:, :, None] * x[i][None, None, :]
            acc = term if acc is None else acc + term
        return acc

    w = dp0[None, None, :]
    return (contract(u2d, fks) * w, contract(v2d, fks) * w,
            contract(g2d, prs), contract(gp2d, prs))


def wind_eval_t(u2d, v2d, g2d, gp2d, s, fk, prof, dp0):
    """The winds of one tracer step from the basis: u2d, v2d, g2d, gp2d
    [T, E, 16], s [T] the time functions' values, fk and prof [T, K], dp0
    [K], all of one dtype on one device and contiguous.

    Returns (un0, vn0, divdp, divdp_proj), each [E, 16, K]: the mean-flux
    velocities (the dp0 weight included), the divergence of (un0, vn0) and
    its DSS projection.
    """
    kind = _device_kind(u2d)
    if u2d.dim() != 3 or u2d.shape[-1] != N2:
        raise ValueError(f"u2d: shape {tuple(u2d.shape)}, expected "
                         f"(T, E, {N2})")
    nt, E, _ = u2d.shape
    K = dp0.shape[-1]
    dev, f = u2d.device, u2d.dtype
    for name, t, shape in (("u2d", u2d, (nt, E, N2)),
                           ("v2d", v2d, (nt, E, N2)),
                           ("g2d", g2d, (nt, E, N2)),
                           ("gp2d", gp2d, (nt, E, N2)), ("s", s, (nt,)),
                           ("fk", fk, (nt, K)), ("prof", prof, (nt, K)),
                           ("dp0", dp0, (K,))):
        _check(name, t, shape, f, dev)
    if kind == "cpu":
        return wind_eval_t_plain(u2d, v2d, g2d, gp2d, s, fk, prof, dp0)
    outs = [torch.empty((E, N2, K), dtype=f, device=dev) for _ in range(4)]
    fn = _build.entry("tse_wind_eval_t", _DTYPES[f])
    code = fn(*(t.data_ptr() for t in (u2d, v2d, g2d, gp2d, s, fk, prof,
                                       dp0, *outs)),
              nt, E, K, _stream(dev))
    _build.check(code, "wind_eval_t")
    bump("wind_eval_t")
    return tuple(outs)


def kernel_config(nt, nk, dtype):
    """The wind kernel's launch shape for T = nt terms and nk levels:
    {vec: values a thread stores a field, threads, smem_bytes,
    blocks_per_sm}."""
    out = (ctypes.c_int * 4)()
    fn = _build.entry("tse_wind_config", _DTYPES[dtype])
    _build.check(fn(nt, nk, out), "wind_config")
    return dict(zip(("vec", "threads", "smem_bytes", "blocks_per_sm"), out))
