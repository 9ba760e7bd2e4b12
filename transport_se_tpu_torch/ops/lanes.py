"""The lane-group copies of the T subcycle's tracer-group plan (the lane
kernels) and their plain PyTorch versions.

Replaces no TPU kernel (the JAX package has no group plan).  A T-layout
state [E, 16, L] keeps lane = tracer*nlev + level, so a group of
consecutive tracers is one contiguous range of lanes [lo, lo + width) in
each of its E*16 rows.  `lane_gather` copies that range into a contiguous
group buffer [E, 16, width]; `lane_scatter` writes a group buffer back
into the range, in place.  The CUDA kernels are `csrc/lanes.cu`
(`lane_gather_kernel`, `lane_scatter_kernel`); the plain versions are a
slice's copy, and a copy moves the bits as they are, so the two agree to
the last bit.

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel, anything else raises.
"""

from __future__ import annotations

import torch

from .. import _build
from ..counters import bump
from .euler import N2, _DTYPES, _device_kind, _stream


def lane_gather_plain(x, lo, width):
    """Plain PyTorch version of lane_gather."""
    bump("lane_gather_t_plain")
    return x[:, :, lo:lo + width].clone(memory_format=torch.contiguous_format)


def lane_scatter_plain(g, x, lo):
    """Plain PyTorch version of lane_scatter."""
    bump("lane_scatter_t_plain")
    x[:, :, lo:lo + g.shape[2]].copy_(g)
    return x


def _check_state(name, x):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.dim() != 3 or x.shape[1] != N2:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"(E, {N2}, L)")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_range(L, lo, width):
    if not (0 <= lo and 1 <= width and lo + width <= L):
        raise ValueError(f"lanes [{lo}, {lo + width}) outside [0, {L})")


def lane_gather(x, lo: int, width: int):
    """The lanes [lo, lo + width) of the state x [E, 16, L] (contiguous) as
    a new contiguous group buffer [E, 16, width]."""
    kind = _device_kind(x)
    _check_state("x", x)
    E, _, L = x.shape
    _check_range(L, lo, width)
    if kind == "cpu":
        return lane_gather_plain(x, lo, width)
    out = torch.empty((E, N2, width), dtype=x.dtype, device=x.device)
    fn = _build.entry("tse_lane_gather", _DTYPES[x.dtype])
    code = fn(x.data_ptr(), out.data_ptr(), E * N2, L, lo, width,
              _stream(x.device))
    _build.check(code, "lane_gather")
    bump("lane_gather_t")
    return out


def lane_scatter(g, x, lo: int):
    """Write the group buffer g [E, 16, width] into the lanes [lo, lo +
    width) of the state x [E, 16, L], in place; returns x.  Both
    contiguous, of one dtype on one device."""
    kind = _device_kind(x)
    _check_state("g", g)
    _check_state("x", x)
    E, _, L = x.shape
    width = g.shape[2]
    if g.shape[0] != E or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g: {tuple(g.shape)} {g.dtype} on {g.device}, "
                         f"expected ({E}, {N2}, width) {x.dtype} on "
                         f"{x.device}")
    _check_range(L, lo, width)
    if kind == "cpu":
        return lane_scatter_plain(g, x, lo)
    fn = _build.entry("tse_lane_scatter", _DTYPES[x.dtype])
    code = fn(g.data_ptr(), x.data_ptr(), E * N2, L, lo, width,
              _stream(x.device))
    _build.check(code, "lane_scatter")
    bump("lane_scatter_t")
    return x
