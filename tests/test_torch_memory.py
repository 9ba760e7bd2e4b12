"""The memory plan of the face T subcycle, on the CPU through the plain
versions.

At NE120 with 35 tracers one state [E, 16, q*k] is 12.98 GiB in f32, so
the subcycle fits the card only if its stages free each state-sized
buffer at its last use, as XLA frees them in the JAX package: a stage's
input after its K1, the first Laplacian once the hyperviscosity input is
made, that input after K1.  These tests count, at every kernel call of a
face T subcycle (on entry, and on return with the outputs alive, which is
the launch's footprint on the card), the distinct storages that live
tensors hold of at least one state's bytes, and hold the count to 4.  The
state is handed to the subcycle as a one-element list (`model.core
_take`); a tensor the caller keeps would be a fifth.

The bench's initial state (`bench.initial_state`, `model.core
initial_qdp_t`) is built in place: counted after every operator
(`TorchDispatchMode`), it holds one state, and it equals
`_tp(initial_qdp(m))` bit for bit.
"""

import dataclasses
import gc

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from transport_se_tpu_torch import bench, counters
from transport_se_tpu_torch.config import Config
from transport_se_tpu_torch.model import core
from transport_se_tpu_torch.ops import dss_face

torch.set_num_threads(1)

# the face T path at ne = 2 with 5 tracers: one state is 5 [E, 16, k]
# fields, so the per-level fields of the winds and the bounds [E, L] stay
# below a state's bytes
CFG = Config(ne=2, nlev=16, qsize=5, tstep=1200.0, vcoord="dcmip16",
             test_case="dcmip1-1", nu_q=6e16, nmax=6, dtype="f64",
             use_pallas=True, disable_diagnostics=True, dss_mode="face",
             elem_order="raster")
MAX_STATES = 4
# [E, L] limiter-bound arrays (a sixteenth of a state each, 0.81 GiB at
# NE120): a launch's inputs and outputs
MAX_BOUNDS = 4
# the kernel wrappers the T path calls (model/core.py, ops/dss.py), and
# their calls in one face subcycle
WRAPPERS = ((core, "fused_advect_limit"), (core, "laplace_wk_t"),
            (core, "remap_q_ppm_t"), (core, "remap_health_t"),
            (dss_face, "dss_face"), (dss_face, "minmax_prep"),
            (dss_face, "neighbor_minmax"))
FACE_CALLS = {"fused_advect_limit": 9, "remap_q_ppm_t": 1, "dss_face": 12,
              "minmax_prep": 1, "neighbor_minmax": 6, "remap_health_t": 1}


def state_storages(nbytes, exact=False, skip=frozenset()):
    """The distinct storages of at least nbytes (exactly nbytes) that live
    tensors hold, but for those at the addresses in skip."""
    return {o.untyped_storage().data_ptr() for o in gc.get_objects()
            if issubclass(type(o), torch.Tensor)
            and o.untyped_storage().data_ptr() not in skip
            and (o.untyped_storage().nbytes() == nbytes if exact
                 else o.untyped_storage().nbytes() >= nbytes)}


def model(dtype):
    return core.build_model(dataclasses.replace(CFG, dtype=dtype), "cpu")


def state_bytes(m):
    cfg = m.cfg
    return (m.lon.shape[0] * 16 * cfg.qsize * cfg.nlev
            * m.lon.element_size())


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_face_subcycle_holds_at_most_four_states(dtype, monkeypatch):
    m = model(dtype)
    step = core.make_subcycle_fn(m, io_layout="t")
    nbytes = state_bytes(m)
    box = [bench.initial_state(m)]
    seen, bounds = [], []
    # the storages held before the subcycle but for its state (the model,
    # and what other tests of the process keep, such as a cached int64
    # table of a state's bytes) are not the subcycle's
    skip = state_storages(1) - {box[0].untyped_storage().data_ptr()}

    def count(name, when):
        seen.append((name, when, len(state_storages(nbytes, skip=skip))))
        bounds.append((name, when, len(state_storages(
            nbytes // 16, exact=True, skip=skip))))

    for mod, name in WRAPPERS:
        def counted(*a, _fn=getattr(mod, name), _name=name, **kw):
            count(_name, "call")
            out = _fn(*a, **kw)
            count(_name, "return")
            return out
        monkeypatch.setattr(mod, name, counted)
    counters.reset()
    out, _, nstep, min_dp = step(box, 0)
    assert box == [None] and nstep == 3 and float(min_dp) > 0
    calls = {}
    for name, when, _ in seen:
        calls[name] = calls.get(name, 0) + (when == "call")
    assert calls == FACE_CALLS
    worst = max(n for _, _, n in seen)
    assert worst <= MAX_STATES, [s for s in seen if s[2] > MAX_STATES]
    # the plan is tight: stage 2's Laplacian launch and stage 3's K1 hold
    # four (the step's input, the stage input or the Laplacian, the
    # hyperviscosity input or K1's output, and the launch's output)
    assert worst == MAX_STATES
    assert max(n for _, _, n in bounds) <= MAX_BOUNDS, \
        [b for b in bounds if b[2] > MAX_BOUNDS]
    del out


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_handed_over_state_changes_no_bit(dtype):
    """The subcycle gives the same bits whether the caller keeps its state
    or hands it over, over two subcycles."""
    m = model(dtype)
    step = core.make_subcycle_fn(m, io_layout="t")
    Q0 = bench.initial_state(m)
    kept, nk = Q0, 0
    box, nb = [Q0.clone()], 0
    for _ in range(2):
        kept, _, nk, _ = step(kept, nk)
        box[0], _, nb, _ = step(box, nb)
    assert nk == nb == 6
    assert torch.equal(kept, box[0])


class StatePeak(TorchDispatchMode):
    """The most state-sized storages alive after any operator, beyond
    those alive when the mode was made."""

    def __init__(self, nbytes):
        super().__init__()
        self.nbytes, self.peak = nbytes, 0
        self.base = len(state_storages(nbytes))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        # the count can only rise where an operator makes a state-sized
        # storage
        if any(isinstance(o, torch.Tensor)
               and o.untyped_storage().nbytes() >= self.nbytes
               for o in outs):
            self.peak = max(self.peak, len(state_storages(self.nbytes))
                            - self.base)
        return out


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_bench_initial_state_is_built_in_place(dtype):
    m = model(dtype)
    nbytes = state_bytes(m)
    with StatePeak(nbytes) as built:
        Q = bench.initial_state(m)
    # one state: the buffer written a tracer at a time
    assert built.peak == 1 <= MAX_STATES
    E, qk = m.lon.shape[0], CFG.qsize * CFG.nlev
    with StatePeak(nbytes) as old:
        want = core._tp(core.initial_qdp(m), E, qk)
    # the two-step build holds two states (initial_qdp's, _tp's copy)
    assert old.peak == 2
    assert Q.shape == (E, 16, qk) and Q.is_contiguous()
    assert torch.equal(Q, want)


@pytest.mark.parametrize("test_case", ["dcmip1-1", "dcmip1-2"])
@pytest.mark.parametrize("qsize", [1, 2, 5])
def test_initial_qdp_t_matches_the_two_step_build(test_case, qsize):
    cfg = dataclasses.replace(CFG, test_case=test_case, qsize=qsize)
    m = core.build_model(cfg, "cpu")
    E, qk = m.lon.shape[0], qsize * cfg.nlev
    assert torch.equal(core.initial_qdp_t(m),
                       core._tp(core.initial_qdp(m), E, qk))


# the group plan at ne = 2 with 7 tracers in groups of 3 and 4: a group's
# buffers hold 3 or 4 level fields' bytes, its bounds [E, g*k] a sixteenth
# of that, and neither size is a level field's [E, 16, k]
GROUP_CFG = dataclasses.replace(CFG, qsize=7)
GROUPS = [3, 4]


def level_bytes(m):
    return m.lon.shape[0] * 16 * m.cfg.nlev * m.lon.element_size()


def storage_sizes():
    """{storage pointer: bytes} of the storages live tensors hold."""
    return {o.untyped_storage().data_ptr(): o.untyped_storage().nbytes()
            for o in gc.get_objects() if issubclass(type(o), torch.Tensor)}


def count_at_calls(step, box, monkeypatch):
    """Run step(box, 0), taking storage_sizes() at every kernel call (on
    entry and on return) -> the list of those, and the sizes held before
    the subcycle."""
    from transport_se_tpu_torch.ops import lanes
    seen = []
    wrappers = WRAPPERS + ((core, "lane_gather"), (core, "lane_scatter"))
    for mod, name in wrappers:
        def counted(*a, _fn=getattr(mod, name), **kw):
            seen.append(storage_sizes())
            out = _fn(*a, **kw)
            seen.append(storage_sizes())
            return out
        monkeypatch.setattr(mod, name, counted)
    assert lanes is not None
    before = storage_sizes()
    out = step(box, 0)
    assert float(out[3]) > 0
    return seen, before


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_group_plan_holds_one_state_and_four_group_buffers(dtype,
                                                           monkeypatch):
    """With groups, every kernel call of a face T subcycle holds the one
    handed-over state, at most STATES group-sized buffers, at most BOUNDS
    group bound arrays and at most LEVEL_FIELDS["groups"] level fields;
    the bytes they hold stay under the planner's model (subcycle_bytes)."""
    m = core.build_model(dataclasses.replace(GROUP_CFG, dtype=dtype), "cpu")
    step = core.make_subcycle_fn(m, io_layout="t", groups=GROUPS)
    lev = level_bytes(m)
    full = state_bytes(m)
    box = [bench.initial_state(m)]
    seen, before = count_at_calls(step, box, monkeypatch)
    assert box == [None] and seen
    state_ptr = next(p for p, n in before.items() if n == full)
    groups = {g * lev for g in GROUPS}
    bounds = {g * lev // 16 for g in GROUPS}
    for sizes in seen:
        new = {p: n for p, n in sizes.items() if p not in before}
        # the state is written in place: no second full state
        assert state_ptr in sizes
        assert sum(n == full for n in new.values()) == 0
        assert sum(n in groups for n in new.values()) <= core.STATES
        assert sum(n in bounds for n in new.values()) <= core.BOUNDS
        assert sum(n == lev for n in new.values()) \
            <= core.LEVEL_FIELDS["groups"]
        assert full + sum(new.values()) <= core.subcycle_bytes(
            m.lon.shape[0], 7, m.cfg.nlev, m.lon.element_size(), GROUPS)
    # the plan is tight: four group buffers at some launch
    assert max(sum(n in groups for p, n in s.items() if p not in before)
               for s in seen) == core.STATES


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_one_group_stays_inside_the_planner_model(dtype, monkeypatch):
    """The one-group subcycle's level fields and bytes at every kernel
    call, against LEVEL_FIELDS["one"] and subcycle_bytes."""
    m = core.build_model(dataclasses.replace(GROUP_CFG, dtype=dtype), "cpu")
    step = core.make_subcycle_fn(m, io_layout="t")
    lev = level_bytes(m)
    box = [bench.initial_state(m)]
    state_ptr = box[0].untyped_storage().data_ptr()
    seen, before = count_at_calls(step, box, monkeypatch)
    for sizes in seen:
        # the handed-over state counts while it lives, as a new storage
        # at its address would
        new = {p: n for p, n in sizes.items()
               if p not in before or p == state_ptr}
        assert sum(n == lev for n in new.values()) \
            <= core.LEVEL_FIELDS["one"]
        assert sum(new.values()) <= core.subcycle_bytes(
            m.lon.shape[0], 7, m.cfg.nlev, m.lon.element_size(), [7])
