"""The remap's health check (`ops/remap.py remap_health_t`) on the CPU: its
plain version against the chain it replaces on the T path, the least width
beside `ops/ppm.ppm_fast_margin`, and the values that must stop a run (a
displacement out of the cell window, a negative width, a NaN).  The kernel
(`csrc/health.cu`) is held bit for bit to the plain version on the card
(tests/test_torch_gpu.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from transport_se_tpu_torch import counters
from transport_se_tpu_torch.config import Config
from transport_se_tpu_torch.model import core
from transport_se_tpu_torch.ops import ppm, remap

torch.set_num_threads(1)

E = 3
DTYPES = {"f32": torch.float32, "f64": torch.float64}
NLEVS = [4, 64, 72]


def widths(dtype, nk, seed=0):
    """dp_star, dp_ref [E,16,nk]: random widths, and target widths whose
    interface j sits at source-cell coordinate j + amp*sin(pi*j/nk),
    |amp| < 1.9 (equal column totals, inside the -2..+2 cell window)."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(50.0, 150.0, (E, 16, nk))
    pio = np.concatenate([np.zeros((E, 16, 1)), np.cumsum(d, -1)], -1)
    j = np.arange(nk + 1)
    amax = min(1.9, 0.95 * nk / np.pi)
    coord = j + rng.uniform(-amax, amax, (E, 16, 1)) * np.sin(np.pi * j / nk)
    pin = np.empty_like(pio)
    for idx in np.ndindex(E, 16):
        pin[idx] = np.interp(coord[idx], j, pio[idx])
    return tuple(torch.from_numpy(a).to(DTYPES[dtype]).contiguous()
                 for a in (d, np.diff(pin, axis=-1)))


def chain(dp_star, dp_ref):
    """The T path's check before the health kernel."""
    return torch.minimum(dp_star.min(), ppm.ppm_fast_margin(dp_star, dp_ref))


def roundoff(dp_star):
    """Rounding of two interface sums of a column: a few units of the last
    place of the column total per level."""
    eps = torch.finfo(dp_star.dtype).eps
    return 4 * dp_star.shape[-1] * eps * float(dp_star.sum(-1).max())


@pytest.mark.parametrize("nk", NLEVS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_the_chain(dtype, nk):
    dps, dpr = widths(dtype, nk)
    counters.reset()
    got = remap.remap_health_t(dps, dpr)
    assert counters.snapshot()["remap_health_t_plain"] == 1
    assert got.dim() == 0 and got.dtype == dps.dtype
    want = chain(dps, dpr)
    assert abs(float(got) - float(want)) <= roundoff(dps)
    assert float(got) > 0


def _displaced(dtype, nk, cells):
    """Uniform widths 100; the target interface j+1 of column (1, 5)
    moved `cells` cells up (j = nk // 2), the widths above it thinned to
    keep the total."""
    dps = torch.full((E, 16, nk), 100.0, dtype=DTYPES[dtype])
    dpr = dps.clone()
    if nk >= 8:
        j = nk // 2 - 4
        dpr[1, 5, j] += 100.0 * cells
        dpr[1, 5, j + 1:j + 8] -= 100.0 * cells / 7
    else:
        # four levels: the window spans the column, so move the first
        # interface as far as the column allows
        dpr[1, 5] = torch.tensor([397.0, 1.0, 1.0, 1.0], dtype=dps.dtype)
    return dps, dpr


@pytest.mark.parametrize("nk", NLEVS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_three_cells_displaced_is_negative(dtype, nk):
    """3.5 cells out of the -2..+2 window: negative (2 cells stay inside).
    At four levels the window pio[j-2]..pio[j+4] holds the whole column,
    so no displacement leaves it."""
    for cells, sign in ((3.5, -1), (2.0, 1)):
        dps, dpr = _displaced(dtype, nk, cells)
        got = float(remap.remap_health_t(dps, dpr))
        assert abs(got - float(chain(dps, dpr))) <= roundoff(dps)
        if nk == 4:
            assert got > 0
        else:
            assert np.sign(got) == sign, (cells, got)


@pytest.mark.parametrize("nk", NLEVS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_negative_width_is_negative(dtype, nk):
    dps, dpr = widths(dtype, nk)
    dps[2, 7, nk - 2] = -0.5
    got = float(remap.remap_health_t(dps, dpr))
    assert got <= -0.5
    assert abs(got - float(chain(dps, dpr))) <= roundoff(dps)


@pytest.mark.parametrize("nk", NLEVS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_nan_width_is_nan(dtype, nk):
    dps, dpr = widths(dtype, nk)
    dps[0, 15, nk - 1] = float("nan")
    got = remap.remap_health_t(dps, dpr)
    assert torch.isnan(got) and torch.isnan(chain(dps, dpr))
    # a NaN target width reaches the margin too
    dps, dpr = widths(dtype, nk)
    dpr[1, 0, 0] = float("nan")
    assert torch.isnan(remap.remap_health_t(dps, dpr))


def test_wrapper_rejects_bad_inputs():
    dps, dpr = widths("f64", 8)
    with pytest.raises(ValueError, match="levels"):
        remap.remap_health_t(dps[..., :3].contiguous(),
                             dpr[..., :3].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        remap.remap_health_t(dps, dpr.transpose(0, 1).contiguous()
                             .transpose(0, 1))
    with pytest.raises(TypeError, match="dtype"):
        remap.remap_health_t(dps, dpr.float())
    with pytest.raises(ValueError, match="expected"):
        remap.remap_health_t(dps.reshape(E * 16, 8), dpr)


CFG = Config(ne=2, nlev=16, qsize=3, tstep=1200.0, vcoord="dcmip16",
             test_case="dcmip1-1", nu_q=6e16, dtype="f64",
             disable_diagnostics=True, dss_mode="face", elem_order="raster",
             use_pallas=True)


@pytest.mark.parametrize("groups", [None, [2, 1]])
def test_once_a_subcycle_and_as_the_chain(groups, monkeypatch):
    """The T subcycle runs the check once, the group plan too (not once a
    group); its state and ps_v are the chain's bit for bit, min_dp the
    chain's within roundoff."""
    m = core.build_model(CFG, "cpu")
    Qt = core._tp(core.initial_qdp(m), m.lon.shape[0], CFG.qsize * CFG.nlev)
    step = core.make_subcycle_fn(m, io_layout="t", groups=groups)
    counters.reset()
    out, ps, nstep, md = step(Qt, 0)
    out, ps, nstep, md = step(out, nstep)
    c = counters.snapshot()
    assert c["remap_health_t_plain"] == 2 and c["remap_health_t"] == 0
    monkeypatch.setattr(core, "remap_health_t", chain)
    ref = step(Qt, 0)
    ref = step(ref[0], ref[2])
    assert torch.equal(out, ref[0]) and torch.equal(ps, ref[1])
    assert nstep == ref[2] == 2 * CFG.rsplit
    assert 0 < float(md)
    assert abs(float(md) - float(ref[3])) <= 2 * roundoff(
        m.dp0col[None, None, :])


def test_plain_switch_reaches_the_plain_version(monkeypatch):
    """remap_levels_t(plain=True) takes the plain version on any device."""
    m = core.build_model(dataclasses.replace(CFG, dtype="f32"), "cpu")
    E = m.lon.shape[0]
    div = torch.zeros(E, 16, CFG.nlev, dtype=m.dtype)
    monkeypatch.setattr(core, "remap_health_t", None)
    counters.reset()
    *_, md = core.remap_levels_t(m, div, CFG.dt_remap, plain=True)
    assert counters.snapshot()["remap_health_t_plain"] == 1
    assert 0 < float(md) <= float(m.dp0col.min())
