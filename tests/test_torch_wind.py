"""The port's wind evaluation (`ops/wind.py`, `model/wind_basis.py`) on the
CPU: the plain version against the JAX package's `WindBasis.eval`, and the
wrapper's dispatch, counts and refusals.  The kernel itself is held to the
plain version bit for bit on the card (`tests/test_torch_gpu.py`)."""

import numpy as np
import pytest
import torch

from transport_se_tpu.config import Config as JConfig
from transport_se_tpu.model.core import build_model as jbuild_model
from transport_se_tpu.model.wind_basis import build_wind_basis as jbuild_wb
from transport_se_tpu_torch import counters
from transport_se_tpu_torch.model import core as tcore
from transport_se_tpu_torch.model.wind_basis import build_wind_basis
from transport_se_tpu_torch.ops import wind

from test_torch_host import port_config

torch.set_num_threads(1)

# tests/test_wind_basis.py's times: the start, one hour, a day and a half,
# the end of DCMIP 1-1's 6-day period
TIMES = [0.0, 3600.0, 123456.0, 518400.0]
# port against JAX, relative to the largest value of the pair of fields
# (un0 and vn0, divdp and divdp_proj).  The JAX package contracts the
# terms with einsum, the port sums them in a chain, and the two packages
# compute each term's divergence and its DSS with their own roundoff
# (measured up to 8.9e-15 at ne = 4): f64 roundoff of a 6-term sum
# (6 * 2.2e-16) and of the divergence, with room.
TOL = 1e-13


def _models(test_case):
    jcfg = JConfig(ne=4, qsize=4, test_case=test_case, nmax=3, nu_q=6e16,
                   dss_mode="face", elem_order="raster")
    return jbuild_model(jcfg), tcore.build_model(port_config(jcfg), "cpu")


def _basis_fields(wb):
    return (wb.u2d, wb.v2d, wb.g2d, wb.gp2d)


@pytest.mark.parametrize("test_case", ["dcmip1-1", "dcmip1-2"])
def test_plain_eval_matches_jax(test_case):
    jm, tm = _models(test_case)
    jwb, twb = jbuild_wb(jm), build_wind_basis(tm)
    assert twb.u2d.shape[0] == (6 if test_case == "dcmip1-1" else 2)
    for t in TIMES:
        want = [np.asarray(a) for a in jwb.eval(t)[2:]]
        counters.reset()
        got = [a.numpy() for a in twb.eval(torch.tensor(t,
                                                        dtype=torch.float64))]
        assert counters.snapshot()["wind_eval_t_plain"] == 1
        assert all(g.dtype == np.float64 for g in got)
        for pair in ((0, 1), (2, 3)):
            scale = max(np.abs(want[i]).max() for i in pair)
            assert scale > 0
            for i in pair:
                assert got[i].shape == want[i].shape
                err = np.abs(got[i] - want[i]).max()
                assert err <= TOL * scale, (t, i, err / scale)


def _inputs(T=6, E=5, K=7, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, dtype=dtype)  # noqa: E731
    return [r(T, E, 16), r(T, E, 16), r(T, E, 16), r(T, E, 16), r(T),
            r(T, K), r(T, K), r(K)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_tensors_run_the_plain_version(dtype):
    args = _inputs(dtype=dtype)
    counters.reset()
    got = wind.wind_eval_t(*args)
    counts = counters.snapshot()
    assert counts["wind_eval_t_plain"] == 1 and counts["wind_eval_t"] == 0
    want = wind.wind_eval_t_plain(*args)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.shape == (5, 16, 7) and g.dtype == dtype
        assert torch.equal(g, w)


def test_plain_version_is_the_term_chain():
    """Each field is the chain over the terms, from the first product, in
    the order of the terms; un0 and vn0 carry dp0."""
    u2d, v2d, g2d, gp2d, s, fk, prof, dp0 = _inputs(T=3)
    un0, vn0, d, p = wind.wind_eval_t_plain(u2d, v2d, g2d, gp2d, s, fk,
                                            prof, dp0)
    fks, prs = fk * s[:, None], prof * s[:, None]
    for got, a, x, w in ((un0, u2d, fks, dp0), (vn0, v2d, fks, dp0),
                         (d, g2d, prs, None), (p, gp2d, prs, None)):
        want = ((a[0][:, :, None] * x[0]) + (a[1][:, :, None] * x[1])) \
            + (a[2][:, :, None] * x[2])
        if w is not None:
            want = want * w
        assert torch.equal(got, want)


def test_basis_keeps_its_plain_flag():
    """build_wind_basis(plain=True) evaluates through the plain version
    on any device; both evaluate to the same bits on the CPU."""
    _, tm = _models("dcmip1-2")
    kern, plain = build_wind_basis(tm), build_wind_basis(tm, plain=True)
    assert plain.plain and not kern.plain
    t = torch.tensor(3600.0, dtype=torch.float64)
    counters.reset()
    a = plain.eval(t)
    b = kern.eval(t)
    assert counters.snapshot()["wind_eval_t_plain"] == 2
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", ["dtype", "contiguous", "T", "K", "device",
                                  "rows"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    args = _inputs()
    err = ValueError
    if case == "dtype":
        args[5] = args[5].float()
        err = TypeError
    elif case == "contiguous":
        args[1] = args[1].transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "T":
        args[4] = args[4][:5]
    elif case == "K":
        args[6] = args[6][:, :6]
    elif case == "device":
        args[3] = args[3].to("meta")
    else:
        args[0] = args[0].reshape(6, 10, 8)
    counters.reset()
    with pytest.raises(err):
        wind.wind_eval_t(*args)
    assert counters.snapshot()["wind_eval_t_plain"] == 0
