"""The port's face DSS tables and the plain versions of its face kernels
(K4 face DSS with epilogues, K5 bound prep, K6 neighbor min/max) == the
JAX package's `build_face_tables` and Pallas face kernels (interpret mode on
CPU), at ne = 2 and 4 in f64.

The sums, min/max and epilogues are bitwise equal: the port adds each
slot's partner terms in the Pallas kernel's order.  The Laplacian epilogue
agrees to 1e-13 of its max, the bound of the weak-Laplacian kernel
(test_torch_euler.py).  The JAX kernels pad lanes to 128 and return the
first nq*nk; the port does not pad.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transport_se_tpu.grid.cubesphere import build_grid
from transport_se_tpu.ops import dss_face as jdf
from transport_se_tpu.ops import pallas_dss
from transport_se_tpu.ops.dss import DssTables as JaxTables
from transport_se_tpu_torch.k4_variants import TIED_ZEROS
from transport_se_tpu_torch.ops import dss_face as tdf
from transport_se_tpu_torch.ops.dss import DssTables
from transport_se_tpu_torch.ops.euler import metric_pack

torch.set_num_threads(1)

NQ, NK = 3, 8
L = NQ * NK


@functools.cache
def _tables(ne):
    """(grid, JAX gather/face tables, port gather/face tables, JAX
    lap_arrays) of one ne."""
    g = build_grid(ne, order="raster")
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    met = metric_pack(t(g.Dinv), t(g.metdet), t(g.rmetdet), t(g.spheremp))
    tg = DssTables.from_numpy(g.part_idx, g.part_mask, g.nbr, "cpu")
    tf = DssTables.from_numpy(g.part_idx, g.part_mask, g.nbr, "cpu",
                              mode="face", ne=ne, met=met, deriv=t(g.deriv))
    lap_arrays = dict(Dinv=jnp.asarray(g.Dinv),
                      spheremp=jnp.asarray(g.spheremp), deriv=g.deriv)
    return (g, JaxTables.from_grid(g, mode="gather"),
            JaxTables.from_grid(g, mode="face"), tg, tf, lap_arrays)


@pytest.fixture(scope="module", params=[2, 4])
def grids(request):
    return _tables(request.param)


def _inputs(E, seed):
    """x, avg [E,16,L]; rsp [E,16]; dp [E,16,NK], from one seed."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((E, 16, L)),
            rng.standard_normal((E, 16, L)),
            rng.uniform(0.5, 2.0, (E, 16)),
            rng.uniform(0.5, 2.0, (E, 16, NK)))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_build_face_tables_matches_jax(grids):
    g = grids[0]
    want = jdf.build_face_tables(g)
    got = tdf.build_face_tables(g.part_idx, g.part_mask, g.ne)
    assert set(got) == set(tdf.FACE_FIELDS)
    for k in tdf.FACE_FIELDS:
        w = np.asarray(getattr(want, k))
        assert got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    ft = grids[4].face
    for k in tdf.FACE_FIELDS:
        assert ft.ne == g.ne
        assert getattr(ft, k).dtype == (torch.bool if k == "diag_mask"
                                        else torch.int64), k
        np.testing.assert_array_equal(getattr(ft, k).numpy(), got[k])


def test_kernel_tables_cover_partners(grids):
    """The role table holds exactly each slot's coincident slots; the
    neighbor table exactly the grid's point-sharing neighbor elements."""
    g, ft = grids[0], grids[4].face
    E = g.nelem
    part = ft.part.numpy().reshape(E * 16, 3)
    for fs in range(E * 16):
        want = sorted(int(p) for p, m in zip(g.part_idx[fs],
                                             g.part_mask[fs]) if m)
        assert sorted(int(p) for p in part[fs] if p >= 0) == want, fs
    nbr = ft.nbr.numpy()
    assert (nbr[:, 0] == np.arange(E)).all()
    for e in range(E):
        assert set(nbr[e]) == set(g.nbr[e]), e


@pytest.mark.parametrize("with_avg", [False, True])
def test_dss_scale_t_bitwise(grids, with_avg):
    g, _, jf, _, tf, _ = grids
    x, avg, rsp, _ = _inputs(g.nelem, 0)
    avg = avg if with_avg else None
    want = jf.dss_scale_t(jnp.asarray(x), jnp.asarray(rsp),
                          avg=None if avg is None else jnp.asarray(avg))
    got = tf.dss_scale_t(torch.from_numpy(x), torch.from_numpy(rsp),
                         avg=None if avg is None else torch.from_numpy(avg))
    _eq(got, want)


@pytest.mark.parametrize("with_avg", [False, True])
def test_dss_scale_minmax_t_bitwise(grids, with_avg):
    g, _, jf, _, tf, _ = grids
    x, avg, rsp, dp = _inputs(g.nelem, 1)
    avg = avg if with_avg else None
    want = jf.dss_scale_minmax_t(
        jnp.asarray(x), jnp.asarray(rsp), jnp.asarray(dp), NQ,
        avg=None if avg is None else jnp.asarray(avg))
    got = tf.dss_scale_minmax_t(
        torch.from_numpy(x), torch.from_numpy(rsp), torch.from_numpy(dp), NQ,
        avg=None if avg is None else torch.from_numpy(avg))
    assert want[3] is None and got[3] is None
    for a, b in zip(got[:3], want[:3]):
        _eq(a, b)


def test_lap_epilogue_matches_jax(grids):
    g, _, jf, _, tf, lap_arrays = grids
    x, _, rsp, dp = _inputs(g.nelem, 2)
    want = jf.dss_scale_minmax_t(jnp.asarray(x), jnp.asarray(rsp),
                                 jnp.asarray(dp), NQ, lap_arrays=lap_arrays)
    got = tf.dss_scale_minmax_t(torch.from_numpy(x), torch.from_numpy(rsp),
                                torch.from_numpy(dp), NQ, lap=True)
    for a, b in zip(got[:3], want[:3]):
        _eq(a, b)
    w = np.asarray(want[3])
    np.testing.assert_allclose(got[3].numpy(), w, rtol=0,
                               atol=1e-13 * np.abs(w).max())


def test_minmax_prep_and_neighbor_minmax_bitwise(grids):
    g, _, jf, _, tf, _ = grids
    x, _, _, dp = _inputs(g.nelem, 3)
    jmn, jmx = jf.minmax_prep(jnp.asarray(x), jnp.asarray(dp), NQ)
    tmn, tmx = tf.minmax_prep(torch.from_numpy(x), torch.from_numpy(dp), NQ)
    _eq(tmn, jmn)
    _eq(tmx, jmx)
    jgn, jgx = jf.neighbor_minmax(jmn, jmx)
    tgn, tgx = tf.neighbor_minmax(tmn, tmx)
    _eq(tgn, jgn)
    _eq(tgx, jgx)
    # and the XLA shifted-copy form the plain version ports
    xgn, xgx = jdf.neighbor_minmax_face(jmn, jmx, jf.face)
    _eq(tgn, xgn)
    _eq(tgx, xgx)


def test_jax_row_blocks_bitwise(monkeypatch):
    """Several Pallas row blocks per face (by < ne) on the JAX side."""
    g, _, jf, _, tf, _ = _tables(4)
    monkeypatch.setattr(pallas_dss, "DSS_BLOCK_CAP", 100000)
    assert pallas_dss._pick_by(g.ne, 128) < g.ne
    x, avg, rsp, dp = _inputs(g.nelem, 4)
    J = jnp.asarray
    T = torch.from_numpy
    want = jf.dss_scale_minmax_t(J(x), J(rsp), J(dp), NQ, avg=J(avg))
    got = tf.dss_scale_minmax_t(T(x), T(rsp), T(dp), NQ, avg=T(avg))
    for a, b in zip(got[:3], want[:3]):
        _eq(a, b)
    _eq(tf.dss_scale_t(T(x), T(rsp)), jf.dss_scale_t(J(x), J(rsp)))
    jgn, jgx = pallas_dss.neighbor_minmax_pallas(want[1], want[2], jf.face)
    tgn, tgx = tf.neighbor_minmax(got[1], got[2])
    _eq(tgn, jgn)
    _eq(tgx, jgx)


def test_face_matches_gather(grids):
    """Face and gather DSS sum the same terms in other orders (the JAX
    test's bound, test_dss_face.py); min/max are exact."""
    g, _, _, tg, tf, _ = grids
    x, _, _, dp = _inputs(g.nelem, 5)
    x = torch.from_numpy(x)
    np.testing.assert_allclose(tf.dss_sum_t(x).numpy(),
                               tg.dss_sum_t(x).numpy(), rtol=0, atol=1e-13)
    mn, mx = tg.minmax_prep(x, torch.from_numpy(dp), NQ)
    for a, b in zip(tf.neighbor_minmax(mn, mx), tg.neighbor_minmax(mn, mx)):
        assert torch.equal(a, b)


def test_dss_multiplicity(grids):
    """DSS of a constant-1 field counts coincident slots: 2 on edges,
    4 at regular corners, 3 at the 8 cube vertices, 1 inside."""
    g, _, jf, tg, tf, _ = grids
    ones = torch.ones((g.nelem, 16, 1), dtype=torch.float64)
    m = tf.dss_sum_t(ones)[..., 0].numpy()
    np.testing.assert_array_equal(m, tg.dss_sum_t(ones)[..., 0].numpy())
    np.testing.assert_array_equal(
        m, np.asarray(jf.dss_sum_t(jnp.asarray(ones.numpy())))[..., 0])
    vals, counts = np.unique(m.reshape(-1), return_counts=True)
    assert set(vals.astype(int)) == {1, 2, 3, 4}
    assert counts[list(vals).index(3.0)] == 24


def test_wrappers_check_their_inputs(grids):
    g, tf = grids[0], grids[4]
    x, avg, rsp, dp = (torch.from_numpy(a) for a in _inputs(g.nelem, 6))
    ft = tf.face
    with pytest.raises(ValueError, match="lap fusion requires dp"):
        tdf.dss_face(x, ft, rsp=rsp, met=tf.met, deriv=tf.deriv)
    with pytest.raises(ValueError, match="avg fusion requires rsp"):
        tdf.dss_face(x, ft, avg=avg)
    with pytest.raises(ValueError, match="minmax fusion requires rsp"):
        tdf.dss_face(x, ft, dp=dp)
    with pytest.raises(ValueError, match="not contiguous"):
        tdf.dss_face(x.transpose(0, 1).contiguous().transpose(0, 1), ft)
    with pytest.raises(ValueError, match="multiple of nk"):
        tdf.dss_face(x[..., :-1].contiguous(), ft, rsp=rsp, dp=dp)
    with pytest.raises(TypeError, match="dtype"):
        tdf.minmax_prep(x, dp.float(), NQ)
    with pytest.raises(ValueError, match="lanes"):
        tdf.minmax_prep(x, dp, NQ + 1)
    with pytest.raises(ValueError, match="shape"):
        tdf.neighbor_minmax(x[:, 0].contiguous(),
                             x[:, 1, :-1].contiguous(), ft)


def _same_bits(got, want):
    """Bitwise, -0 and +0 apart."""
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    u = np.uint32 if got.dtype == np.float32 else np.uint64
    np.testing.assert_array_equal(got.view(u), want.view(u))


def _division_edges(dtype, seed):
    """x [E,16,L], dp [E,16,nk] of the bound prep with the inline
    division's edge operands (common.cuh Bits): columns of +0, of -0
    beside positive values, of tracer mass below and at the range's lower
    end (2^-100 f32, 2^-400 f64) and at its upper end; in f32 layer widths
    at and just beyond 2^-20 and 2^20."""
    f = np.dtype(dtype)
    rng = np.random.default_rng(seed)
    E, nq, nk = 5, 3, 4
    x = rng.uniform(-0.5, 2.0, (E, 16, nq * nk)).astype(f)
    dp = rng.uniform(0.5, 2.0, (E, 16, nk)).astype(f)
    lo = 2.0 ** (-100 if f == np.float32 else -400)
    hi = 2.0 ** (100 if f == np.float32 else 400)
    x[0, :, 0] = 0.0
    x[0, :, 1] = rng.uniform(0.1, 1.0, 16)
    x[0, 3:9, 1] = -0.0
    x[1, :, 2] = lo * rng.uniform(0.25, 0.99, 16)     # below the range
    x[1, :, 3] = -lo * rng.uniform(0.25, 0.99, 16)
    x[1, ::2, 4] = lo                                 # at its ends
    x[1, 1::2, 4] = hi
    x[2, 5, 5] = -0.0
    if f == np.float32:
        a, b = np.float32(2.0 ** -20), np.float32(2.0 ** 20)
        dp[3, :4, 0] = a                              # at the ends
        dp[3, 4:8, 0] = b
        dp[3, 8:12, 0] = np.nextafter(a, np.float32(0))   # just beyond
        dp[3, 12:, 0] = np.nextafter(b, np.float32(np.inf))
        dp[4, :, 1] = np.nextafter(a, np.float32(0))
    return x, dp, nq


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_minmax_prep_bitwise_at_the_inline_division_edges(dtype):
    """K5's plain version == the JAX Pallas bound prep bit for bit on the
    operands where the kernel's inline division leaves its fast path."""
    x, dp, nq = _division_edges(dtype, 21)
    jmn, jmx = pallas_dss.minmax_prep_pallas(jnp.asarray(x), jnp.asarray(dp),
                                             nq, interpret=True)
    tmn, tmx = tdf.minmax_prep(torch.from_numpy(x), torch.from_numpy(dp), nq)
    _same_bits(tmn, jmn)
    _same_bits(tmx, jmx)
    assert np.signbit(tmn.numpy()[0, 1]) and tmn.numpy()[0, 1] == 0


@pytest.mark.parametrize("case", ["minmax", "minmax+lap", "avg+minmax"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dss_face_plain_bitwise_at_the_inline_division_edges(dtype, case):
    """dss_face_plain, the version K4 is held to bit for bit on the card,
    == the JAX Pallas face kernel (interpret mode) on the ne = 2 sphere
    whose first five elements carry _division_edges' operands (its tracer
    mass below the range scaled by 2^-8), where K4's inline division
    leaves its fast path: the sums, the time average and
    the bounds bit for bit; the Laplacian to the weak-Laplacian kernel's
    bound (1e-13 of its max in f64, 1e-5 in f32: the JAX epilogue folds
    its metric from Dinv and spheremp in the working type,
    test_torch_euler.py)."""
    g, _, jf, _, tf, _ = _tables(2)
    f = np.dtype(dtype)
    E = g.nelem
    xe, dpe, nq = _division_edges(dtype, 31)
    rng = np.random.default_rng(32)
    x = rng.uniform(-0.5, 2.0, (E, 16, xe.shape[-1])).astype(f)
    dp = rng.uniform(0.5, 2.0, (E, 16, dpe.shape[-1])).astype(f)
    x[:len(xe)], dp[:len(dpe)] = xe, dpe
    # the tracer mass below the range stays below it after rspheremp
    # (at most 101 at ne = 2)
    x[1, :, 2:4] *= f.type(2.0 ** -8)
    # the time average's input: the field itself, so its edge operands
    # reach the averaged output
    avg = x.copy() if "avg" in case else None
    rsp = np.asarray(g.rspheremp).reshape(E, 16).astype(f)
    lap = case.endswith("lap")
    la = None if not lap else dict(
        Dinv=jnp.asarray(np.asarray(g.Dinv, f)),
        spheremp=jnp.asarray(np.asarray(g.spheremp, f)),
        deriv=np.asarray(g.deriv, f))
    want = pallas_dss.dss_face_pallas(
        jnp.asarray(x), jf.face, rsp=jnp.asarray(rsp), dp=jnp.asarray(dp),
        interpret=True, lap_arrays=la,
        avg=None if avg is None else jnp.asarray(avg))
    tt = torch.float32 if f == np.float32 else torch.float64
    got = tdf.dss_face_plain(
        torch.from_numpy(x), tf.face, rsp=torch.from_numpy(rsp),
        avg=None if avg is None else torch.from_numpy(avg),
        dp=torch.from_numpy(dp), met=tf.met.to(tt) if lap else None,
        deriv=tf.deriv.to(tt) if lap else None)
    assert len(got) == len(want) == (4 if lap else 3)
    for a, b in zip(got[:3], want[:3]):
        _same_bits(a, b)
    # assembled values below the division's range, which K4 divides with
    # IEEE divisions
    lo = 2.0 ** (-100 if f == np.float32 else -400)
    a = np.abs(got[0].numpy())
    assert ((a > 0) & (a < lo)).any()
    if lap:
        w = np.asarray(want[3])
        tol = 1e-13 if f == np.float64 else 1e-5
        np.testing.assert_allclose(got[3].numpy(), w, rtol=0,
                                   atol=tol * np.abs(w).max())


def test_minmax_prep_keeps_the_first_of_tied_zeros():
    """Where +0 and -0 tie for a column's min or max, the plain version
    keeps the first point's zero, as the kernel's strict comparisons in
    point order do (csrc/dss.cu minmax_kernel).  The JAX kernel orders -0
    below +0 instead: its min is -0 and its max +0 on such ties (sign of a
    zero bound only)."""
    x = np.ones((1, 16, 4))
    x[0, :, 0] = 0.0
    x[0, 5, 0] = -0.0            # +0 first
    x[0, :, 1] = -0.0
    x[0, 7, 1] = 0.0             # -0 first
    x[0, :, 2] = 1.0
    x[0, 3, 2], x[0, 9, 2] = 0.0, -0.0     # the min ties, +0 first
    x[0, :, 3] = -1.0
    x[0, 3, 3], x[0, 9, 3] = -0.0, 0.0     # the max ties, -0 first
    dp = np.ones((1, 16, 4))
    tmn, tmx = (a.numpy()[0] for a in tdf.minmax_prep(
        torch.from_numpy(x), torch.from_numpy(dp), 1))
    np.testing.assert_array_equal(np.signbit(tmn), [False, True, False,
                                                    True])
    np.testing.assert_array_equal(np.signbit(tmx), [False, True, False,
                                                    True])
    jmn, jmx = (np.asarray(a)[0] for a in pallas_dss.minmax_prep_pallas(
        jnp.asarray(x), jnp.asarray(dp), 1, interpret=True))
    np.testing.assert_array_equal(np.signbit(jmn), [True, True, True, True])
    np.testing.assert_array_equal(np.signbit(jmx), [False, False, False,
                                                    False])


@pytest.mark.parametrize("tie", TIED_ZEROS,
                         ids=[str(sorted(t)) for t in TIED_ZEROS])
def test_plain_minmax_keeps_the_first_of_tied_zeros(tie):
    """The plain versions of K4 and K5 take the min and the max over the
    points in point order with strict comparisons, so the first point's
    zero wins a tie, as in the kernels, on any device (torch.amin and
    torch.amax keep the zero their reduction order meets: on the card not
    always the first point's, k4_variants tie_order)."""
    first = np.signbit(tie[min(tie)])
    for dtype in (np.float32, np.float64):
        x = np.empty((2, 16, 2), dtype)
        x[:, :, 0], x[:, :, 1] = 1.0, -1.0     # a min tie, a max tie
        for p, v in tie.items():
            x[:, p, :] = v
        dp = np.ones((2, 16, 1), dtype)
        mn, mx = tdf.minmax_prep(torch.from_numpy(x), torch.from_numpy(dp), 2)
        assert np.signbit(mn.numpy()[:, 0]).tolist() == [first] * 2
        assert np.signbit(mx.numpy()[:, 1]).tolist() == [first] * 2
        # and the same function in dss_face_plain (x/dp with dp = 1)
        for a, b in zip(tdf._point_minmax(torch.from_numpy(x)), (mn, mx)):
            _same_bits(a, b.numpy())


def _k6_bounds(E, L, dtype, seed):
    """qmin, qmax [E, L] of dtype: lanes of values >= 0 and of values <= 0
    (so that +0 and -0 tie for many minima and maxima), +0 and -0 and
    +-inf scattered over the rest, and the extremes of the last lane at
    the cube-vertex elements of face 0."""
    rng = np.random.default_rng(seed)
    ne = int(round((E / 6) ** 0.5))
    out = []
    for sign in (1.0, -1.0):
        a = rng.standard_normal((E, L))
        a[:, 0::3] = sign * np.abs(a[:, 0::3])
        a[:, 1::3] = -sign * np.abs(a[:, 1::3])
        u = rng.random((E, L))
        a[u < 0.3] = 0.0
        a[(u >= 0.3) & (u < 0.6)] = -0.0
        a[(u >= 0.6) & (u < 0.62)] = np.inf
        a[(u >= 0.62) & (u < 0.64)] = -np.inf
        for e in (0, ne - 1, ne * ne - ne, ne * ne - 1):
            a[e, -1] = -sign * 1e30
        out.append(a.astype(dtype))
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("L", [5, 130])
def test_neighbor_minmax_bitwise_with_signed_zeros(grids, dtype, L):
    """K6's plain version == the JAX Pallas kernel and the JAX shifted-copy
    form bit for bit, -0 and +0 apart: all three order -0 below +0 (the
    plain version by its integer keys, JAX's jnp.minimum/maximum by
    IEEE 754-2019), whatever the order of the reduction.  Lane counts that
    4 does not divide, and one beyond the Pallas kernel's 128-lane
    padding.  The same as the direct definition: the keys' min and max
    over each element's row of the [E, 9] neighbor table."""
    g, _, jf, _, tf, _ = grids
    mn, mx = _k6_bounds(g.nelem, L, dtype, g.ne * 100 + L)
    tgn, tgx = tdf.neighbor_minmax(torch.from_numpy(mn),
                                   torch.from_numpy(mx), tf.face)
    for want in (pallas_dss.neighbor_minmax_pallas(
                     jnp.asarray(mn), jnp.asarray(mx), jf.face,
                     interpret=True),
                 jdf.neighbor_minmax_face(jnp.asarray(mn), jnp.asarray(mx),
                                          jf.face)):
        _same_bits(tgn, want[0])
        _same_bits(tgx, want[1])
    nbr = tf.face.nbr
    for got, q, op in ((tgn, mn, torch.amin), (tgx, mx, torch.amax)):
        key = op(tdf._ordered(torch.from_numpy(q))[nbr], dim=1)
        _same_bits(got, tdf._ordered(key).view(got.dtype))
    # tied zeros resolved: -0 minima and +0 maxima
    assert torch.signbit(tgn[tgn == 0]).any()
    assert (~torch.signbit(tgx[tgx == 0])).any()


def test_ordered_keys():
    """_ordered sorts as the values with -0 below +0 and is its own
    inverse."""
    for f in (np.float32, np.float64):
        v = np.array([np.inf, 1.5, 0.0, -0.0, -1e-30, -np.inf, 2.0 ** -149
                      if f == np.float32 else 5e-324, -2.5], f)
        k = tdf._ordered(torch.from_numpy(v))
        order = np.argsort(k.numpy(), kind="stable")
        assert [str(x) for x in v[order]] == [
            "-inf", "-2.5", "-1e-30", "-0.0", "0.0",
            str(v[6]), "1.5", "inf"]
        np.testing.assert_array_equal(
            tdf._ordered(k).view(v.dtype.name == "float32" and torch.float32
                                 or torch.float64).numpy().view(
                k.numpy().dtype), v.view(k.numpy().dtype))
