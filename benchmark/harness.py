"""One run of one cell of the benchmark (see README.md).

The cell (a `workloads` entry of BENCHMARK.json) names a configuration
file (configs/), a traffic file (traffic/) and has its limits in
limits/<cell>.json.  The configuration file chooses the port's pipeline
and the DCMIP test:

* `use_pallas` (absent: true), the port's own `Config` field: true runs
  the T-layout pipeline ([E, 16, q*k], the hand-written stage kernels),
  false the std-layout verification path ([E, q, k, 4, 4], K10 the row
  limiter); the port says which a configuration runs
  (`model.core.uses_t_layout`), as its driver asks it;
* `dss_mode` and `elem_order`, the port's own fields: the face DSS on the
  raster order, or the gather DSS on the gilbert curve (or the raster);
* `test_case` ("dcmip1-1" or "dcmip1-2", equal to the traffic's `winds`):
  the winds and the named initial fields (q1-q4; the Hadley layer), the
  checkerboard in the other tracers, as the reference model fills them.

The run:

1. set-up: the port's model of the configuration (`perf_config` with the
   file's settings and the traffic's tracer count), its subcycle function
   (`make_subcycle_fn(m, io_layout=...)` of the layout the port runs) and
   its initial state (`initial_qdp_t` or `initial_qdp`), the named fields
   moved to lanes drawn from the seed; then the traffic's warm-up
   subcycles, the first one's output kept at the checked lanes;
2. the window: subcycles back to back, the state handed over as a
   one-element list, each launched as soon as the one two back has
   finished on the device (so the device always has a whole subcycle
   queued and the window closes on time), until `--seconds` have passed.
   The wall time runs from the first launch to `torch.cuda.synchronize()`
   after the last.  With `--trace 1`, torch.profiler records a block of
   subcycles inside the window;
3. after the window, off the clock: the peak memory is read, then one
   closing subcycle of the same program runs, its input and output kept at
   the checked lanes; the least layer thickness and the finiteness of the
   state are read, and the program is freed;
4. the check: the plain reference (reference/) builds its own grid (raster
   order), levels, winds and initial state, runs the first subcycle and
   the closing subcycle (from the program's input to it) at the checked
   lanes, and both are compared with the program's outputs.  The
   program's elements and points are mapped onto the reference's by the
   places that each side computes from its own longitudes and latitudes
   (`element_map`); a map that is not one-to-one refuses the run.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names the run may not hold (the JAX stack and the JAX
# package the port was made from), compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "transport_se_tpu")
BASELINE = 3.53e9    # gridpoint-tracers/s: the reference's NE120 run, 960 cores
LOOKAHEAD = 2        # subcycles the host keeps queued ahead of the device
TRACE_AFTER = 2      # window subcycles before the traced block
TRACE_SECONDS = 1.0  # host seconds of the traced block (two subcycles or more)
CHECK_LANES = 6      # tracer lanes the check compares


def log(msg):
    print(msg, file=sys.stderr, flush=True)


class Refused(Exception):
    """A run that prints no result."""


# ---------------------------------------------------------------------------
# the cell's files
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    spec: dict           # BENCHMARK.json


def load_cell(workload: str, config_overrides=None,
              traffic_overrides=None) -> Cell:
    """The cell's files, with the tests' overrides (smaller grids, other
    pipelines and test cases) laid over its configuration and traffic."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())
    config.update(config_overrides or {})
    traffic.update(traffic_overrides or {})
    if config.get("test_case") != traffic["winds"]:
        raise Refused(f"{workload}: the traffic's winds {traffic['winds']} "
                      f"are not the configuration's {config.get('test_case')}")
    return Cell(workload, int(w["chips"]), config, traffic, limits, spec)


def named_fields(test_case: str, qsize: int):
    """The test case's initial fields other than the checkerboard, in the
    reference model's tracer order (1-1: q1..q4, 1-2: the Hadley layer)."""
    from benchmark.reference.transport import lane_fields
    return [f for f in lane_fields(test_case, qsize) if f != "checkerboard"]


def draw_lanes(seed: int, qsize: int, nlanes: int,
               test_case: str = "dcmip1-1"):
    """(fields, lanes): the initial field of each tracer lane, the test
    case's named fields at lanes drawn from the seed and the checkerboard
    in the others, and the checked lanes: those of the named fields and
    checkerboard lanes drawn from the seed, each added to the half of the
    lanes that has fewer."""
    rng = np.random.default_rng(seed)
    named = named_fields(test_case, qsize)
    pos = [int(p) for p in rng.choice(qsize, size=len(named),
                                      replace=False)]
    fields = ["checkerboard"] * qsize
    for name, p in zip(named, pos):
        fields[p] = name
    others = [lane for lane in range(qsize) if lane not in pos]
    rng.shuffle(others)
    lanes, half = list(pos), qsize // 2
    while len(lanes) < min(nlanes, qsize):
        low = sum(lane < half for lane in lanes) <= len(lanes) / 2
        pick = next((o for o in others if (o < half) == low), others[0])
        others.remove(pick)
        lanes.append(pick)
    return fields, sorted(lanes)


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------

class Program:
    """The port's subcycle on one device, driven as a user drives it: the
    model, the subcycle function of the layout the port runs for the
    configuration, and the state in a one-element list."""

    def __init__(self, cell: Cell, device, fields, lanes, fault=None):
        import torch

        from transport_se_tpu_torch.config import perf_config
        from transport_se_tpu_torch.model.core import (
            build_model, initial_qdp, initial_qdp_t, make_subcycle_fn,
            uses_t_layout)
        c, tr = cell.config, cell.traffic
        pallas = c.get("use_pallas", True)
        try:
            cfg = perf_config(c["ne"], dtype=c["dtype"], use_pallas=pallas)
        except KeyError:
            # a grid outside perf_config's table (the tests' small ones):
            # every setting below comes from the file all the same
            cfg = perf_config(30, dtype=c["dtype"], use_pallas=pallas)
        cfg = dataclasses.replace(cfg, ne=c["ne"])
        self.cfg = cfg = dataclasses.replace(
            cfg, qsize=tr["qsize"], nlev=c["nlev"], vcoord=c["vcoord"],
            test_case=tr["winds"], tstep=float(c["tstep"]),
            qsplit=c["qsplit"], rsplit=c["rsplit"], nu_q=float(c["nu_q"]),
            hypervis_order=c["hypervis_order"],
            hypervis_subcycle_q=c["hypervis_subcycle_q"],
            limiter_option=c["limiter_option"],
            vert_remap_q_alg=c["vert_remap_q_alg"],
            limiter_iter_cap=c["limiter_iter_cap"], dss_mode=c["dss_mode"],
            elem_order=c["elem_order"])
        # [E, 16, q*k] with the tracers' levels in dim 2, or [E, q, k, 4, 4]
        self.t_layout = uses_t_layout(cfg)
        self.torch = torch
        self.device = device
        self.cuda = device.type == "cuda"
        self.build = {}
        t0 = time.perf_counter()
        if self.cuda:
            from transport_se_tpu_torch import _build
            _build.library()     # nvcc on a checkout's first run, then cached
            self.build["kernels"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.m = build_model(cfg, device)
        self.sync()
        self.build["model"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.step = make_subcycle_fn(
            self.m, io_layout="t" if self.t_layout else "std")
        if fault is not None:
            self.step = fault(self.step)
        self.sync()
        self.build["subcycle_fn"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.E = self.m.lon.shape[0]
        self.box = [initial_qdp_t(self.m) if self.t_layout
                    else initial_qdp(self.m)]
        self._place(fields)
        self.sync()
        self.build["state"] = time.perf_counter() - t0
        self.lanes = torch.as_tensor(lanes, device=device)
        self.nstep = 0
        self.events = []
        shape = ((self.E, 16, len(lanes), cfg.nlev) if self.t_layout
                 else (self.E, len(lanes), cfg.nlev, 4, 4))
        self.kept = torch.empty(shape, dtype=self.m.dtype,
                                pin_memory=self.cuda)

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def _by_tracer(self):
        """(the state with a tracer axis, that axis)."""
        if self.t_layout:
            return self.box[0].view(self.E, 16, self.cfg.qsize,
                                    self.cfg.nlev), 2
        return self.box[0], 1

    def _place(self, fields):
        """Move the initial state's tracers (in the reference model's order,
        `lane_fields`) to the lanes of `fields`, a lane swap at a time."""
        from benchmark.reference.transport import lane_fields
        cfg = self.cfg
        view, ax = self._by_tracer()
        have = lane_fields(cfg.test_case, cfg.qsize)
        for a in range(cfg.qsize):
            if have[a] == fields[a]:
                continue
            b = next(j for j in range(a + 1, cfg.qsize)
                     if have[j] == fields[a] and have[j] != fields[j])
            tmp = view.select(ax, a).clone()
            view.select(ax, a).copy_(view.select(ax, b))
            view.select(ax, b).copy_(tmp)
            have[a], have[b] = have[b], have[a]

    def keep(self):
        """Copy the checked lanes of the current state into the pinned
        buffer `kept`, in stream order: the gathered lanes are freed before
        the next subcycle allocates, so the copy never adds to its peak."""
        view, ax = self._by_tracer()
        self.kept.copy_(view.index_select(ax, self.lanes),
                        non_blocking=self.cuda)

    def kept_copy(self):
        """The kept lanes once copied, as a host tensor in the program's
        layout ([E, 16, n, k] or [E, n, k, 4, 4])."""
        self.sync()
        return self.kept.clone()

    def subcycle(self):
        """One subcycle -> its min_dp; on the card an event marks its end."""
        self.box[0], _, self.nstep, md = self.step(self.box, self.nstep)
        if self.cuda:
            ev = self.torch.cuda.Event()
            ev.record()
            self.events.append(ev)
        return md

    def wait(self, back):
        """Wait for the subcycle `back` launches before the next one."""
        if self.cuda and len(self.events) >= back:
            self.events[-back].synchronize()

    def places(self):
        """The program's longitudes and latitudes [E, 4, 4], on the host in
        float64: where each of its elements and points lies."""
        return self.m.lon.cpu().double(), self.m.lat.cpu().double()

    def free(self):
        for k in ("box", "step", "m", "kept"):
            setattr(self, k, None)
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()


def window(prog: Program, seconds, trace):
    """The measured window -> (subcycles run, wall s, min_dp tensors,
    profiler block or None): subcycles until `seconds` have passed, one at
    least.  With trace, a block of whole subcycles under torch.profiler
    after the first TRACE_AFTER."""
    mins, block = [], None
    i = 0
    t0 = time.perf_counter()
    while True:
        prog.wait(LOOKAHEAD)
        if trace and i == TRACE_AFTER:
            block = profile_block(prog, mins)
            i += block["subcycles"]
        mins.append(prog.subcycle())
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    prog.sync()
    return i, time.perf_counter() - t0, mins, block


def profile_block(prog: Program, mins):
    """Whole subcycles under torch.profiler, from a drained device until
    TRACE_SECONDS of host time and two subcycles have passed."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if prog.cuda else [])
    prog.sync()
    # the block is one profiler cycle; its note that events are cleared
    # between cycles does not apply
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    pr = profile(activities=acts)
    pr.start()
    t0, n = time.perf_counter(), 0
    while n < 2 or time.perf_counter() - t0 < TRACE_SECONDS:
        prog.wait(LOOKAHEAD)
        mins.append(prog.subcycle())
        n += 1
    prog.sync()
    pr.stop()
    return {"profiler": pr, "subcycles": n}


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

def to_std(lanes, E, nk, t_layout):
    """The program's state at the checked lanes -> [E, n, k, 4, 4] (the
    reference's layout): [E, 16, n, k] from the T layout, as it is from
    the std layout."""
    if not t_layout:
        return lanes
    n = lanes.shape[2]
    return lanes.permute(0, 2, 3, 1).reshape(E, n, nk, 4, 4)


def _unit_xyz(lon, lat):
    """[..., 3] unit vectors of float64 longitudes and latitudes."""
    import torch
    return torch.stack([torch.cos(lat) * torch.cos(lon),
                        torch.cos(lat) * torch.sin(lon), torch.sin(lat)], -1)


def _nearest(a, b):
    """For each unit vector of a [N, 3], the index of the nearest of b
    [M, 3] and whether it is far nearer than the second nearest (its
    squared chord under 1e-4 of the second's)."""
    import torch
    idx, sure = [], []
    step = max(1, 2**26 // b.shape[0])
    for i in range(0, a.shape[0], step):
        cos = a[i:i + step] @ b.T
        top = cos.topk(2, dim=1)
        chord2 = 2.0 - 2.0 * top.values
        idx.append(top.indices[:, 0])
        sure.append(chord2[:, 0] <= 1e-4 * chord2[:, 1])
    return torch.cat(idx), torch.cat(sure)


def _one_to_one(idx, n):
    import torch
    return bool((torch.sort(idx, dim=-1).values
                 == torch.arange(n, device=idx.device)).all())


def element_map(plon, plat, rlon, rlat):
    """Where the reference's elements and points lie among the program's:
    (elem [E], point [E, 16]) with reference element r at program element
    elem[r], and its point p at that element's point point[r, p]; None
    where both sides keep the same order.  Each side's places come from
    its own longitudes and latitudes [E, 4, 4]: element centres matched to
    the nearest centre, then the points within the matched elements.
    Refused where a place has no clearly nearest partner or the map is not
    one-to-one."""
    import torch
    E = rlon.shape[0]
    if plon.shape != rlon.shape:
        raise Refused(f"the program has {tuple(plon.shape)} points, the "
                      f"reference {tuple(rlon.shape)}")
    P = _unit_xyz(plon.double(), plat.double()).reshape(E, 16, 3)
    R = _unit_xyz(rlon.double(), rlat.double()).reshape(E, 16, 3)
    pc, rc = P.mean(1), R.mean(1)
    pc = pc / torch.linalg.vector_norm(pc, dim=1, keepdim=True)
    rc = rc / torch.linalg.vector_norm(rc, dim=1, keepdim=True)
    elem, sure = _nearest(rc, pc)
    if not (bool(sure.all()) and _one_to_one(elem, E)):
        raise Refused("the program's elements do not map one to one onto "
                      "the reference's by their centres")
    cos = torch.einsum("rpd,rqd->rpq", R, P[elem])
    top = cos.topk(2, dim=2)
    chord2 = 2.0 - 2.0 * top.values
    point = top.indices[:, :, 0]
    if not (bool((chord2[..., 0] <= 1e-4 * chord2[..., 1]).all())
            and _one_to_one(point, 16)):
        raise Refused("the points of the program's elements do not map one "
                      "to one onto the reference's")
    if bool((elem == torch.arange(E, device=elem.device)).all()) and bool(
            (point == torch.arange(16, device=point.device)).all()):
        return None
    return elem, point


def to_reference_order(x, emap):
    """[E, n, k, 4, 4] in the program's element and point order -> the
    reference's (emap from element_map; None: as it is)."""
    if emap is None:
        return x
    elem, point = emap
    E, n, nk = x.shape[:3]
    y = x.index_select(0, elem.to(x.device)).reshape(E, n, nk, 16)
    idx = point.to(x.device)[:, None, None, :].expand(E, n, nk, 16)
    return y.gather(3, idx).reshape(E, n, nk, 4, 4)


def reference_subcycle(rm, Q, nstep, chunk, tf32=False):
    """The reference's subcycle of Q [E, n, k, 4, 4] from tracer step
    nstep, `chunk` tracers at a time; tf32 allows TF32 matrix products
    (the control)."""
    import torch

    from benchmark.reference import transport as R
    out = []
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        for a in range(0, Q.shape[1], chunk):
            q, _, _ = R.subcycle(rm, Q[:, a:a + chunk].contiguous(), nstep)
            out.append(q)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
        torch.backends.cudnn.allow_tf32 = prev
    return torch.cat(out, dim=1)


def gaps(P, R):
    """(relative L2 gap, relative widest gap), each the largest over the
    tracers: ||P - R|| / ||R|| and max|P - R| / max|R| of each tracer."""
    import torch
    d = (P.double() - R.double())
    Rd = R.double()
    dims = (0, 2, 3, 4)
    l2 = (torch.linalg.vector_norm(d, dim=dims)
          / torch.linalg.vector_norm(Rd, dim=dims))
    mx = d.abs().amax(dim=dims) / Rd.abs().amax(dim=dims)
    return float(l2.max()), float(mx.max())


def check(cell, device, fields, lanes, first_out, last_in, n_in, last_out,
          places, t_layout, control=None):
    """The reference's first subcycle from its own initial state and its
    closing subcycle from the program's input to it, against the program's
    outputs (or, with control="tf32", the reference computed with TF32
    matrix products in the program's place) -> {name: value}.  places: the
    program's (lon, lat), which map its elements onto the reference's."""
    import torch

    from benchmark.reference import transport as R
    c = cell.config
    rcfg = dict(ne=c["ne"], nlev=c["nlev"], dtype=c["dtype"],
                tstep=float(c["tstep"]), rsplit=c["rsplit"],
                nu_q=float(c["nu_q"]), limiter_iter_cap=c["limiter_iter_cap"],
                test_case=c["test_case"])
    t0 = time.perf_counter()
    rm = R.build_model(rcfg, device)
    E, nk = rm.lon.shape[0], c["nlev"]
    emap = element_map(places[0].to(device), places[1].to(device),
                       rm.lon, rm.lat)

    def ref(x):
        return to_reference_order(to_std(x.to(device), E, nk, t_layout),
                                  emap)
    init = R.initial_fields(rm)
    Q0 = torch.stack([init[fields[lane]] for lane in lanes], 1) \
        * rm.dp0col[None, None, :, None, None]
    del init
    # about 1.5 GB of state a chunk
    chunk = max(1, int(1.5e9 // (E * 16 * nk * Q0.element_size())))
    log(f"check: reference model {time.perf_counter() - t0:.2f} s, "
        f"{len(lanes)} lanes in chunks of {chunk}; the program's elements "
        + ("in the reference's order" if emap is None else "mapped onto "
           "the reference's"))
    out = {}
    for name, Qin, nstep, got in (
            ("first", Q0, 0, first_out),
            ("last", ref(last_in), n_in, last_out)):
        t0 = time.perf_counter()
        want = reference_subcycle(rm, Qin, nstep, chunk)
        if control:
            got = reference_subcycle(rm, Qin, nstep, chunk, tf32=True)
        else:
            got = ref(got)
        out[f"{name}_l2"], out[f"{name}_max"] = gaps(got, want)
        del want, got
        log(f"check: {name} subcycle (from tracer step {nstep}) "
            f"{time.perf_counter() - t0:.2f} s")
    return out


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def card_line(torch, device):
    if device.type != "cuda":
        return "cpu"
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader", "--id=0"],
                           capture_output=True, text=True, timeout=60)
        if r.returncode == 0 and r.stdout.strip():
            return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(device)}, power limit not read"


def read_per_layer(cell, tr):
    """The cell's per-layer metrics from the trace, by their readers."""
    out = {}
    for met in cell.spec["per_layer"]:
        if cell.name not in met.get("workloads", [cell.name]):
            continue
        mod = importlib.import_module(f"benchmark.readers.{met['name']}")
        v = mod.read(tr)
        if v is not None:
            out[met["name"]] = {"value": v, "unit": met["unit"]}
    return out


def run_cell(workload, seed, seconds, trace, t_start, device=None,
             control=None, fault=None, config_overrides=None,
             traffic_overrides=None):
    """One run -> the result line (dict).  device None: the card, which
    must be there; the tests pass "cpu", the overrides (a smaller grid and
    tracer count) and a fault (a wrapper of the subcycle function)."""
    import torch
    cell = load_cell(workload, config_overrides, traffic_overrides)
    if device is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if found < cell.chips:
            raise Refused(f"{workload} needs {cell.chips} CUDA device(s); "
                          f"found {found}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    else:
        device = torch.device(device)
    # as the port's CLI sets them: float32 products in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device.type == "cuda"
    log(f"card: {card_line(torch, device)}; torch {torch.__version__}")
    tr = cell.traffic
    fields, lanes = draw_lanes(seed, tr["qsize"], CHECK_LANES, tr["winds"])
    named = named_fields(tr["winds"], tr["qsize"])
    log(f"{workload} seed {seed}: {tr['winds']}, {', '.join(named)} at "
        f"lanes {', '.join(str(fields.index(f)) for f in named)}; checked "
        f"lanes {lanes}")

    from transport_se_tpu_torch import counters
    prog = Program(cell, device, fields, lanes, fault=fault)
    cfg = prog.cfg
    for i in range(tr["warmup_subcycles"]):
        prog.subcycle()
        if i == 0:
            prog.keep()
            first_out = prog.kept_copy()
    prog.sync()
    counters.reset()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    n, wall, mins, block = window(prog, seconds, trace)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    launches = {k: v for k, v in counters.snapshot().items() if v}
    # the closing subcycle, off the clock: its input and output at the
    # checked lanes
    prog.keep()
    last_in, n_in = prog.kept_copy(), prog.nstep
    mins.append(prog.subcycle())
    prog.keep()
    last_out = prog.kept_copy()
    min_dp = float(torch.stack(mins).min())
    finite = bool(torch.isfinite(prog.box[0]).all())
    E = prog.E
    work = n * cfg.rsplit * E * 16 * cfg.nlev * cfg.qsize
    log(f"{workload}: set-up {setup_s:.3f} s (" + ", ".join(
        f"{k} {v:.2f}" for k, v in prog.build.items()) + "); window "
        f"{n} subcycles in {wall:.4f} s = {wall / n * 1e3:.3f} ms a "
        f"subcycle; {work / wall:.6e} gridpoint-tracers/s "
        f"({work / wall / BASELINE:.3f}x the reference's 3.53e9 on 960 "
        f"cores); peak {peak} B = {peak / 2**30:.3f} GiB; launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items()))
    tr_data = None
    if block is not None:
        from benchmark.trace import Trace
        path = BENCH / "out" / f"trace.{workload}.json"
        path.parent.mkdir(exist_ok=True)
        block["profiler"].export_chrome_trace(str(path))
        tr_data = Trace.from_chrome(path, block["subcycles"], dict(
            E=E, qsize=cfg.qsize, nlev=cfg.nlev, dtype=cfg.dtype,
            rsplit=cfg.rsplit))
        log(f"{workload}: traced {block['subcycles']} subcycles: span "
            f"{tr_data.span_s:.6f} s, busy {tr_data.busy_s:.6f} s")
    places, t_layout = prog.places(), prog.t_layout
    prog.free()
    del prog

    values = check(cell, device, fields, lanes, first_out, last_in, n_in,
                   last_out, places, t_layout, control=control)
    limits = cell.limits["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    checks["min_dp"] = {"value": min_dp, "limit": "> 0"}
    checks["finite"] = {"value": int(finite), "limit": "= 1"}
    correct = (all(v <= limits[k] for k, v in values.items())
               and min_dp > 0 and finite)

    result = {"correct": correct, "attempted": n + 1,
              "failed": sum(float(m) <= 0 for m in mins) + (not finite)}
    if trace:
        metrics = read_per_layer(cell, tr_data) if tr_data else {}
    else:
        units = {m["name"]: m["unit"] for m in cell.spec["end_to_end"]}
        metrics = {"throughput": {"value": work / wall,
                                  "unit": units["throughput"]},
                   "peak_mem_gib": {"value": peak / 2**30,
                                    "unit": units["peak_mem_gib"]},
                   "setup_s": {"value": setup_s, "unit": units["setup_s"]}}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": peak}
    if tr_data is not None:
        result["device"].update(busy_s=tr_data.busy_s,
                                window_s=tr_data.span_s)
        result["breakdown"] = tr_data.breakdown()
    result["check"] = checks
    for k, v in checks.items():
        log(f"check {k} {v['value']!r} limit {v['limit']}")
    return result


def forbidden_modules():
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv, t_start):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32",),
                   help="put the reference, with TF32 matrix products, in "
                        "the program's place in the check")
    a = p.parse_args(argv)
    try:
        result = run_cell(a.workload, a.seed, a.seconds, a.trace, t_start,
                          control=a.control)
    except Refused as e:
        log(f"error: {e}")
        return 3
    bad = forbidden_modules()
    if bad:
        log(f"error: the run loaded {', '.join(bad)}")
        return 4
    print(json.dumps(result), flush=True)
    return 0
