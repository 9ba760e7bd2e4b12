"""The T subcycle's tracer-group plan (model/core.py), the lane kernels'
plain versions (ops/lanes.py), the reference's limiter pass count in f64,
and the reader of the lane kernels' device time, on the CPU.

Tracers are independent within a subcycle (tests/test_torch_lanes.py), so
a subcycle run a group of tracers at a time, over lanes gathered into a
group buffer and scattered back, gives the bits of the one-group plan, which
runs on the state itself.  Both are the one T subcycle of make_subcycle_fn.
The planner runs one group wherever four states fit the device: the
benchmark's f32 cells run one group; NE120 with 35 tracers in f64
(25.96 GiB a state) runs in groups.
"""

import dataclasses

import pytest
import torch

from transport_se_tpu_torch import counters
from transport_se_tpu_torch.config import Config
from transport_se_tpu_torch.model import core
from transport_se_tpu_torch.ops import lanes

torch.set_num_threads(1)

CFG = Config(ne=2, nlev=16, qsize=5, tstep=1200.0, vcoord="dcmip16",
             test_case="dcmip1-1", nu_q=6e16, nmax=6, dtype="f64",
             use_pallas=True, disable_diagnostics=True, dss_mode="face",
             elem_order="raster")
CAP = {"f32": 4, "f64": 0}
WIDTHS = [[5], [2, 2, 1], [1] * 5]
SUBCYCLES = 2
GIB = 2**30
CARD = 80e9          # an 80 GB card's total memory, bytes


def model(dtype, **kw):
    return core.build_model(dataclasses.replace(
        CFG, dtype=dtype, limiter_iter_cap=CAP[dtype], **kw), "cpu")


def run(step, Q0, n=SUBCYCLES, handed=True):
    """n subcycles from Q0 -> (states, ps_v, min_dp of each).  Handed
    over, a group plan writes the next subcycle into the state it was
    given, so each state is kept as a copy."""
    Q, nstep, out = (Q0.clone() if handed else Q0), 0, []
    for _ in range(n):
        Q, ps, nstep, md = step([Q] if handed else Q, nstep)
        out.append((Q.clone(), ps, float(md)))
    assert nstep == n * CFG.rsplit
    return out


@pytest.mark.parametrize("widths", WIDTHS, ids=lambda w: "-".join(map(str, w)))
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_grouped_subcycle_is_bitwise_the_ungrouped(dtype, widths):
    m = model(dtype)
    Q0 = core.initial_qdp_t(m)
    want = run(core.make_subcycle_fn(m, io_layout="t"), Q0)
    step = core.make_subcycle_fn(m, io_layout="t", groups=widths)
    counters.reset()
    handed = run(step, Q0)
    c = counters.snapshot()
    # one gather and one scatter a group and subcycle, by the plain
    # versions on the CPU; one group runs on the state and copies nothing
    copies = 0 if len(widths) == 1 else len(widths) * SUBCYCLES
    assert c["lane_gather_t_plain"] == c["lane_scatter_t_plain"] == copies
    assert c["lane_gather_t"] == c["lane_scatter_t"] == 0
    kept_in = Q0.clone()
    kept = run(step, kept_in, handed=False)
    # the caller's tensor stays as it was
    assert torch.equal(kept_in, Q0)
    for (a, pa, ma), (b, pb, mb), (k, pk, mk) in zip(want, handed, kept):
        assert torch.equal(a, b) and torch.equal(a, k)
        assert torch.equal(pa, pb) and torch.equal(pa, pk)
        assert ma == mb == mk and ma > 0


@pytest.mark.parametrize("widths", [[5], [2, 2, 1]],
                         ids=lambda w: "-".join(map(str, w)))
def test_stages_take_the_thicknesses_stage_dps_made(widths, monkeypatch):
    """Every stage's dp_t is the very tensor stage_dps made for its tracer
    step, once a subcycle for all groups, and stage 0 is handed no bounds:
    no stage remakes its thickness or fills a bound pair, in one group or
    several."""
    m = model("f64")
    made, calls = [], []

    def stage_dps(*a, _fn=core.stage_dps):
        made.append(_fn(*a))
        return made[-1]

    def euler_step_t(mg, Qt, qmin, qmax, divdp_t, dp_t, uv_t, dt, rhs, *a,
                     _fn=core.euler_step_t, **kw):
        bounds = [b[0] if isinstance(b, list) else b for b in (qmin, qmax)]
        calls.append((rhs, dp_t, bounds))
        return _fn(mg, Qt, qmin, qmax, divdp_t, dp_t, uv_t, dt, rhs, *a, **kw)

    monkeypatch.setattr(core, "stage_dps", stage_dps)
    monkeypatch.setattr(core, "euler_step_t", euler_step_t)
    step = core.make_subcycle_fn(m, io_layout="t", groups=widths)
    _, _, nstep, md = step([core.initial_qdp_t(m)], 0)
    assert nstep == CFG.rsplit and float(md) > 0
    assert len(made) == CFG.rsplit
    assert len(calls) == len(widths) * CFG.rsplit * 3
    for c, (rhs, dp_t, bounds) in enumerate(calls):
        assert rhs == c % 3
        assert dp_t is made[(c // 3) % CFG.rsplit][rhs]
        if rhs == 0:
            assert bounds == [None, None]


def test_grouped_std_layout_is_bitwise_the_ungrouped():
    """io_layout="std" ([E, q, k, 4, 4]) goes through the same plan."""
    m = model("f64")
    Q0 = core.initial_qdp(m)
    a = core.make_subcycle_fn(m, io_layout="std")([Q0.clone()], 0)
    b = core.make_subcycle_fn(m, io_layout="std", groups=[3, 2])(
        [Q0.clone()], 0)
    assert torch.equal(a[0], b[0]) and a[2] == b[2] == 3


@pytest.mark.parametrize("widths", [[5, 1], [0, 5], [2, 2]])
def test_groups_must_split_the_tracers(widths):
    with pytest.raises(ValueError):
        core.make_subcycle_fn(model("f64"), io_layout="t", groups=widths)


def _held_per_element(dtype):
    """The model's and the wind basis's bytes an element, from ne = 2 (the
    planner's `held`, which grows with the elements)."""
    from transport_se_tpu_torch.model.wind_basis import build_wind_basis
    m = core.build_model(dataclasses.replace(
        CFG, nlev=72, vcoord="acme72", qsize=35, dtype=dtype,
        limiter_iter_cap=CAP[dtype]), "cpu")
    return core.held_bytes(m, build_wind_basis(m)) / m.lon.shape[0]


@pytest.mark.parametrize("ne", [30, 120])
def test_the_f32_cells_run_one_group(ne):
    """The benchmark's ne120_perf.q35 and ne30_perf.q35 (35 tracers, 72
    levels, f32) fit four states on an 80 GB card: one group, run on the
    state itself."""
    E = 6 * ne * ne
    held = _held_per_element("f32") * E
    assert core.plan_groups(E, 35, 72, 4, CARD, held) == [35]
    # the model of NE120's four-state plan against the card's reading,
    # 58.49 GiB (PERF.md): within 5% above it
    if ne == 120:
        peak = core.subcycle_bytes(E, 35, 72, 4, [35], held)
        assert 58.49 * GIB <= peak <= 1.05 * 58.49 * GIB


def test_ne120_35_tracers_f64_runs_in_groups():
    """One f64 state is 25.96 GiB: four do not fit, the plan takes three
    groups or more, even ones, under 75 GiB."""
    E = 86400
    held = _held_per_element("f64") * E
    state = E * 16 * 35 * 72 * 8
    assert state / GIB == pytest.approx(25.96, abs=0.01)
    assert core.subcycle_bytes(E, 35, 72, 8, [35], held) > CARD
    widths = core.plan_groups(E, 35, 72, 8, CARD, held)
    assert len(widths) >= 3 and sum(widths) == 35
    assert max(widths) - min(widths) <= 1
    peak = core.subcycle_bytes(E, 35, 72, 8, widths, held)
    assert peak < 75 * GIB and peak <= core.MEMORY_SHARE * CARD
    # the fewest groups that fit: one group fewer does not
    n = len(widths) - 1
    fewer = [35 // n + (i < 35 % n) for i in range(n)]
    assert core.subcycle_bytes(E, 35, 72, 8, fewer, held) \
        > core.MEMORY_SHARE * CARD


def test_plan_that_cannot_fit_raises():
    with pytest.raises(ValueError):
        core.plan_groups(86400, 35, 72, 8, 20e9)


@pytest.mark.parametrize("lo,width", [(0, 5), (3, 4), (0, 16), (15, 1)])
def test_lane_copies(lo, width):
    x = torch.randn(3, 16, 16, dtype=torch.float64)
    counters.reset()
    g = lanes.lane_gather(x, lo, width)
    assert g.is_contiguous() and g.shape == (3, 16, width)
    assert torch.equal(g, x[:, :, lo:lo + width])
    assert g.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
    y = torch.zeros_like(x)
    assert lanes.lane_scatter(g, y, lo) is y
    assert torch.equal(y[:, :, lo:lo + width], g)
    assert not y[:, :, :lo].any() and not y[:, :, lo + width:].any()
    c = counters.snapshot()
    assert c["lane_gather_t_plain"] == c["lane_scatter_t_plain"] == 1


def test_lane_copies_reject_bad_ranges():
    x = torch.zeros(2, 16, 8)
    for lo, width in ((-1, 2), (0, 0), (5, 4)):
        with pytest.raises(ValueError):
            lanes.lane_gather(x, lo, width)
    with pytest.raises(ValueError):
        lanes.lane_scatter(torch.zeros(2, 16, 4), x, 6)
    with pytest.raises(ValueError):
        lanes.lane_gather(x.transpose(0, 2), 0, 1)


def test_limiter_cap_15_is_the_full_iteration_in_f64():
    """In f64 the reference's own pass count, 15, is accepted and gives
    the bits of cap 0; any other cap still raises."""
    out = {}
    for cap in (0, 15):
        m = core.build_model(dataclasses.replace(
            CFG, limiter_iter_cap=cap), "cpu")
        Q0 = core.initial_qdp_t(m)
        out[cap] = run(core.make_subcycle_fn(m, io_layout="t"), Q0)
    for (a, pa, ma), (b, pb, mb) in zip(out[0], out[15]):
        assert torch.equal(a, b) and torch.equal(pa, pb) and ma == mb
    for cap in (4, 14, 16):
        with pytest.raises(ValueError):
            dataclasses.replace(CFG, limiter_iter_cap=cap)
    assert dataclasses.replace(CFG, dtype="f32",
                               limiter_iter_cap=4).limiter_iter_cap == 4


def test_grouped_f64_against_the_benchmark_reference():
    """The grouped port in f64 at the reference's 15 limiter passes
    against the benchmark's plain reference (benchmark/reference), ne = 2,
    72 levels, q1-q4 and the checkerboard, two subcycles.  Tolerance 1e-12
    of each tracer's largest value: the same algorithm in f64, summed in
    another order (the reference's einsum derivatives, its DSS sums by
    global point), which the limiter's passes carry on at roundoff; the
    same bound as benchmark/tests/test_benchmark_reference.py."""
    from benchmark.reference import transport as R
    names = ["q1", "q2", "q3", "q4", "checkerboard"]
    cfg = Config(ne=2, test_case="dcmip1-1", tstep=1200.0, qsize=5,
                 nu_q=6e16, disable_diagnostics=True, dss_mode="face",
                 elem_order="raster", dtype="f64", use_pallas=True,
                 limiter_iter_cap=15)
    m = core.build_model(cfg, "cpu")
    step = core.make_subcycle_fn(m, io_layout="t", groups=[2, 2, 1])
    Qt = core.initial_qdp_t(m)
    rm = R.build_model(dict(ne=2, nlev=72, dtype="f64", tstep=1200.0,
                            rsplit=3, nu_q=6e16, limiter_iter_cap=15), "cpu")
    f = R.initial_fields(rm)
    Q = torch.stack([f[n] for n in names], 1) \
        * rm.dp0col[None, None, :, None, None]
    E = Q.shape[0]

    def std(x):
        return x.reshape(E, 16, 5, 72).permute(0, 2, 3, 1) \
            .reshape(E, 5, 72, 4, 4)
    assert torch.equal(std(Qt), Q)
    n = nr = 0
    for _ in range(2):
        Qt, _, n, md = step([Qt], n)
        Q, nr, mdr = R.subcycle(rm, Q, nr)
        d = (std(Qt) - Q).abs().amax(dim=(0, 2, 3, 4)) \
            / Q.abs().amax(dim=(0, 2, 3, 4))
        assert float(d.max()) < 1e-12
        assert float(md) == pytest.approx(float(mdr), rel=1e-6)


def _trace(lane_ms):
    """A made-up trace of 2 subcycles: a K1 launch, a fill and, if
    lane_ms, one gather and one scatter of lane_ms each."""
    from benchmark.trace import Trace
    ev = [{"ph": "X", "cat": "kernel", "ts": 0, "dur": 3000,
           "name": "void euler_kernel<double>(double const*)",
           "args": {"correlation": 1}},
          {"ph": "X", "cat": "gpu_memset", "ts": 3000, "dur": 500,
           "name": "Memset (Device)", "args": {"correlation": 2}}]
    if lane_ms:
        ev += [{"ph": "X", "cat": "kernel", "ts": 4000, "dur": lane_ms * 1e3,
                "name": "void (anonymous namespace)::lane_gather_kernel"
                        "<uint4>(uint4 const*, uint4*, long long)",
                "args": {"correlation": 3}},
               {"ph": "X", "cat": "kernel", "ts": 9000, "dur": lane_ms * 1e3,
                "name": "void (anonymous namespace)::lane_scatter_kernel"
                        "<uint4>(uint4 const*, uint4*, long long)",
                "args": {"correlation": 4}}]
    return Trace.from_events(ev, 2, dict(E=86400, qsize=35, nlev=72,
                                         dtype="f64", rsplit=3))


def test_lane_group_reader():
    from benchmark.readers import glue_ms_per_subcycle as glue
    from benchmark.readers import lane_group_ms_per_subcycle as lg
    from benchmark.rooflines import lane_group
    tr = _trace(4.0)
    assert tr.kernel_s("lane_group") == pytest.approx(8e-3)
    assert lg.read(tr) == pytest.approx(8.0 / 2)
    # the lane kernels are the port's, not glue
    assert glue.read(tr) == pytest.approx(0.5 / 2)
    # a trace of subcycles without a group plan reads 0
    assert lg.read(_trace(0)) == 0.0
    # the bound: the state read and written twice, at 3.35 TB/s
    nbytes = 4 * 86400 * 16 * 35 * 72 * 8
    assert lane_group.subcycle_bytes(86400, 35, 72, "f64") == nbytes
    assert lane_group.subcycle_bound_ms(86400, 35, 72, "f64") \
        == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert 33.2 < lane_group.subcycle_bound_ms(86400, 35, 72, "f64") < 33.4
