"""The port's limiter 8 (K10's plain version) and 2D limiters == the JAX
package's, in f64 on the CPU.

Tolerances: every 16-point sum of the port is the `_sum16` pairwise tree
(the association of K1 and K10 on the card), while the JAX limiters sum
with XLA's reduction order.  The row mass therefore differs by an ulp or
two, so a relaxed bound (mass/sum of weights) agrees to a few ulp and the
limited output to the JAX package's own limiter parity bound, atol 1e-13
(tests/test_pallas_limiter.py); the JAX package's two limiters differ from
each other by as much.  Bounds that are not relaxed pass through and are
bitwise equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pallas_limiter import _random_problem
from transport_se_tpu.ops import limiter as jlim
from transport_se_tpu.ops.pallas_limiter import \
    limiter_optim_iter_full_pallas
from transport_se_tpu_torch import _build, counters
from transport_se_tpu_torch.ops import limiter as tlim

torch.set_num_threads(1)

CSRC = _build.CSRC
# a relaxed bound is mass/sumc: a few ulp apart when mass is
RELAXED_RTOL = 8 * np.finfo(np.float64).eps


def _t(a):
    return torch.tensor(np.asarray(a))


def _check_bounds(got, want, given, rtol=RELAXED_RTOL):
    """Unrelaxed bounds bitwise, relaxed ones to a few ulp."""
    kept = want == np.asarray(given)
    np.testing.assert_array_equal(got[kept], want[kept])
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


@pytest.mark.parametrize("n", [64, 2048, 3000])
@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_plain_matches_jax_limiters(n, ref):
    rng = np.random.default_rng(0)
    ptens, sph, qmin, qmax, dp = _random_problem(rng, n)
    if ref == "xla":
        want = jlim.limiter_optim_iter_full(ptens, sph, qmin, qmax, dp)
    else:
        want = limiter_optim_iter_full_pallas(ptens, sph, qmin, qmax, dp,
                                              interpret=True)
    want = [np.asarray(a) for a in want]
    counters.reset()
    got = [a.numpy() for a in tlim.limiter_optim_iter_full(
        *(_t(a) for a in (ptens, sph, qmin, qmax, dp)))]
    assert counters.COUNTS["limiter_optim_plain"] == 1
    assert counters.COUNTS["limiter_optim"] == 0
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-13)
    _check_bounds(got[1], want[1], qmin)
    _check_bounds(got[2], want[2], qmax)
    # the hard rows really relax
    assert (got[1] != np.asarray(qmin)).any()
    assert (got[2] != np.asarray(qmax)).any()


def test_mass_preserved_and_bounds():
    rng = np.random.default_rng(1)
    ptens, sph, qmin, qmax, dp = (_t(a) for a in _random_problem(rng, 4096))
    got, gmin, gmax = tlim.limiter_optim_iter_full(ptens, sph, qmin, qmax,
                                                   dp)
    np.testing.assert_allclose((sph * got).sum(-1).numpy(),
                               (sph * ptens).sum(-1).numpy(), rtol=1e-12)
    q = got / dp
    assert bool((q <= gmax[:, None] + 1e-11).all())
    assert bool((q >= gmin[:, None] - 1e-11).all())


def test_batched_shapes_and_chunks():
    """[..., 16] batches and the JAX signature's chunks give the flat
    result, bitwise."""
    rng = np.random.default_rng(2)
    args = [_t(a) for a in _random_problem(rng, 6 * 5 * 4)]
    flat = tlim.limiter_optim_iter_full(*args)
    shp = (6, 5, 4, 16)
    for chunks in (0, 8):
        got = tlim.limiter_optim_iter_full(
            *(a.reshape(shp) if a.dim() == 2 else a.reshape(shp[:-1])
              for a in args), chunks=chunks)
        for g, f in zip(got, flat):
            assert torch.equal(g.reshape(f.shape), f)


def test_stage_operands_match_full_rows():
    """limiter_optim_stage (spheremp [E,16] and dp_star [E,k,16] shared by
    the rows) == limiter_optim_iter_full on the broadcast [N,16] copies,
    bitwise, with plain=True and on the CPU alike."""
    rng = np.random.default_rng(7)
    E, q, k = 3, 2, 5
    ptens, _, qmin, qmax, _ = (_t(a) for a in _random_problem(rng, E * q * k))
    sp = _t(rng.uniform(0.5, 1.5, (E, 16)))
    dps = _t(rng.uniform(0.5, 1.5, (E, k, 16)))
    shp = (E, q, k, 16)
    ptens, qmin, qmax = (ptens.reshape(shp), qmin.reshape(shp[:-1]),
                         qmax.reshape(shp[:-1]))
    want = tlim.limiter_optim_iter_full(
        ptens, sp[:, None, None].expand(shp).contiguous(), qmin, qmax,
        dps[:, None].expand(shp).contiguous())
    assert (want[0] != ptens).any()
    for plain in (False, True):
        got = tlim.limiter_optim_stage(ptens, sp, dps, qmin, qmax,
                                       plain=plain)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    with pytest.raises(ValueError, match="dp_star"):
        tlim.limiter_optim_stage(ptens, sp, dps[:, :2].contiguous(), qmin,
                                 qmax)


def test_degenerate_rows_return_ptens():
    """A row whose weights sum to <= 0 is not limited (:1020)."""
    rng = np.random.default_rng(3)
    ptens, sph, qmin, qmax, dp = (_t(a) for a in _random_problem(rng, 8))
    sph[3] = -sph[3]
    sph[5] = 0.0
    got, _, _ = tlim.limiter_optim_iter_full(ptens, sph, qmin, qmax, dp)
    assert torch.equal(got[3], ptens[3]) and torch.equal(got[5], ptens[5])
    assert not torch.equal(got, ptens)


def test_wrapper_rejects_bad_inputs():
    rng = np.random.default_rng(4)
    ptens, sph, qmin, qmax, dp = (_t(a) for a in _random_problem(rng, 16))
    with pytest.raises(ValueError, match="contiguous"):
        tlim.limiter_optim_iter_full(ptens.t().contiguous().t(), sph, qmin,
                                     qmax, dp)
    with pytest.raises(ValueError, match="shape"):
        tlim.limiter_optim_iter_full(ptens, sph, qmin[:8], qmax, dp)
    with pytest.raises(TypeError, match="dtype"):
        tlim.limiter_optim_iter_full(ptens, sph.float(), qmin, qmax, dp)
    with pytest.raises(ValueError, match=r"\[\.\.\., 16\]"):
        tlim.limiter_optim_iter_full(ptens[:, :8].contiguous(), sph, qmin,
                                     qmax, dp)


def test_limiter2d_minmax_matches_jax():
    rng = np.random.default_rng(5)
    n = 96
    qdp = rng.uniform(-0.5, 2.5, (n, 16))
    dp = rng.uniform(0.5, 1.5, (n, 16))
    sp = rng.uniform(0.1, 1.0, (n, 16))
    qmin = rng.uniform(0.0, 0.4, n)
    qmax = rng.uniform(1.0, 1.6, n)
    want = np.asarray(jlim.limiter2d_minmax(*(jnp.asarray(a) for a in
                                              (qdp, dp, sp, qmin, qmax))))
    got = tlim.limiter2d_minmax(*(_t(a) for a in (qdp, dp, sp, qmin,
                                                  qmax))).numpy()
    # 16-term sums in another order: roundoff of O(1) values
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    np.testing.assert_allclose((got * sp).sum(-1), (qdp * sp).sum(-1),
                               rtol=1e-12)


def test_limiter2d_zero_matches_jax():
    rng = np.random.default_rng(6)
    q = rng.uniform(-1.0, 2.0, (64, 16))
    q[5] = -np.abs(q[5])                       # a negative-mass row
    want = np.asarray(jlim.limiter2d_zero(jnp.asarray(q)))
    got = tlim.limiter2d_zero(_t(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    assert (got[np.arange(64) != 5] >= 0).all()
    np.testing.assert_allclose(got.sum(-1), q.sum(-1), rtol=1e-12)


def test_k10_builds_with_the_library_and_shares_k1_limiter_body():
    """K10 is one source of the one nvcc call, with its entry point and
    counter; K1 and K10 run the limiter iteration of common.cuh."""
    assert "limiter.cu" in _build.SOURCES
    assert len(_build.ENTRIES["tse_limiter_optim"]) == 15
    assert "limiter_optim" in counters.KERNELS
    assert "limiter_optim_plain" in counters.COUNTS
    common = (CSRC / "common.cuh").read_text()
    # it returns the pass at which a column converged (K1's counting form
    # adds them up)
    assert "int limiter_iterate(" in common
    # K1 passes a column's 16 points, K10 a quad lane's 4, whose sums
    # row_sum16 completes over the quad: one body, in common.cuh alone
    assert "int limiter_iterate(T (&x)[P]" in common
    assert "row_sum16(r)" in common and "__shfl_xor_sync" in common
    for src in ("euler.cu", "limiter.cu"):
        text = (CSRC / src).read_text()
        assert "limiter_iterate(x, c, mn, mx," in text, src
        assert "addmass =" not in text and "wsum" not in text, src
    assert "T x0[P], x[P], c[P]" in (CSRC / "limiter.cu").read_text()


def _long_row():
    """(x, c) of a row whose clip-and-redistribute needs all 15 passes
    within the bounds [0, 1] (dpmass 1): the weights fall by r from point
    to point, and each pass's overshoot, carried by the point it
    saturates, is spread over the free points' weights and saturates the
    next one.  At r = 0.45 each overshoot lies 18% below the add that
    saturates the next point, so limiters that sum in other orders take
    the same path (where that margin is a few ulp, one ulp decides which
    point saturates and the unconverged results part)."""
    a, r = 3e-2, 0.45
    k = np.arange(1, 16)
    c = np.concatenate([[1.0], r ** k])
    x = np.concatenate([[1.0 + a * c[1:].sum()], 1.0 - (k * a - a * r /
                                                        (1 - r))])
    return x, c


def _division_edges(dtype, seed):
    """(ptens, sph, qmin, qmax, dp) [n, 16] rows with the inline division's
    edge operands (csrc/common.cuh Bits): tracer mass +0, -0, below and at
    the range's lower end (2^-100 f32, 2^-400 f64) and at its upper end;
    in f32 layer widths at and just beyond 2^-20 and 2^20; and a row that
    converges at once, one that needs all 15 passes and one whose weights
    sum to <= 0."""
    f = np.dtype(dtype)
    rng = np.random.default_rng(seed)
    ptens, sph, qmin, qmax, dp = (np.array(a, dtype=f) for a in
                                  _random_problem(rng, 48))
    lo = 2.0 ** (-100 if f == np.float32 else -400)
    hi = 2.0 ** (100 if f == np.float32 else 400)
    ptens[0] = 0.0
    ptens[1, 2:9] = 0.0
    ptens[2] = -0.0
    ptens[3, ::3] = -0.0
    ptens[4] = lo * rng.uniform(0.25, 0.99, 16)       # below the range
    ptens[5, :8] = -lo * rng.uniform(0.25, 0.99, 8)
    ptens[6, ::2] = lo                                # at its ends
    ptens[7, 1::2] = hi * rng.uniform(0.5, 1.0, 8)
    qmin[6:8], qmax[6:8] = 0.0, hi
    if f == np.float32:
        a, b = np.float32(2.0 ** -20), np.float32(2.0 ** 20)
        for i, w in enumerate((a, b, np.nextafter(a, np.float32(0)),
                               np.nextafter(b, np.float32(np.inf)))):
            q = ptens[8 + i] / dp[8 + i]
            dp[8 + i, :: 1 + i % 2] = w
            ptens[8 + i] = (q * dp[8 + i]).astype(f)
    x = rng.uniform(0.4, 0.6, 16)                     # converges at once
    ptens[12], sph[12], dp[12] = x, 0.5, 1.0
    qmin[12], qmax[12] = 0.3, 0.7
    x, c = _long_row()
    ptens[13], sph[13], dp[13], qmin[13], qmax[13] = x, c, 1.0, 0.0, 1.0
    sph[14] = -sph[14]                                # sum of weights < 0
    return ptens, sph, qmin, qmax, dp


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_matches_jax_at_the_inline_division_edges(dtype):
    """K10's plain version == the JAX Pallas limiter on the operands where
    the kernel's inline division leaves its fast path, and on rows of 1
    and 15 passes and of weights summing to <= 0.  f64: the limited
    output to atol 1e-13 of the row's scale and the bounds split of
    _check_bounds, as above; f32: the same split at f32's unit roundoff
    (the rows' mass sums differ by a few ulp, and each of up to 15 passes
    spreads a clip residual of that size)."""
    f = np.dtype(dtype)
    ptens, sph, qmin, qmax, dp = _division_edges(dtype, 31)
    from transport_se_tpu_torch.k10_variants import passes
    n = passes(tuple(_t(a) for a in (ptens[:, None, None], sph,
                                     dp[:, None], qmin[:, None, None],
                                     qmax[:, None, None])))
    assert n[12].item() == 1 and n[13].item() == 15 and n[14].item() == 0
    want = [np.asarray(a) for a in limiter_optim_iter_full_pallas(
        *(jnp.asarray(a) for a in (ptens, sph, qmin, qmax, dp)),
        interpret=True)]
    got = [a.numpy() for a in tlim.limiter_optim_iter_full(
        *(_t(a) for a in (ptens, sph, qmin, qmax, dp)))]
    assert all(g.dtype == f for g in got)
    eps = np.finfo(f).eps
    scale = np.abs(want[0]).max(axis=1, keepdims=True)
    atol = 1e-13 if f == np.float64 else 256 * eps
    err = np.abs(got[0] - want[0])
    assert (err <= atol * scale).all(), (err / scale).max(axis=1)
    rtol = RELAXED_RTOL if f == np.float64 else 8 * eps
    _check_bounds(got[1], want[1], qmin, rtol)
    _check_bounds(got[2], want[2], qmax, rtol)
    # the row of weights summing to <= 0 passes ptens through, bitwise
    assert got[0][14].tobytes() == ptens[14].tobytes()
    # a row of -0 tracer mass relaxes its lower bound to -0 and stays -0
    # (the JAX kernel's 0/1 blends, conv*xcl + (1 - conv)*xred, give +0
    # there: equal as numbers, which the tolerance above holds)
    assert np.signbit(got[0][2]).all() and np.signbit(got[1][2])
