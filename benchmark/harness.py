"""One run of one cell of the benchmark (see README.md).

The cell (a `workloads` entry of BENCHMARK.json) names a configuration
file (configs/), a traffic file (traffic/) and has its limits in
limits/<cell>.json.  The run:

1. set-up: the port's model of the configuration (`perf_config` with the
   file's settings and the traffic's tracer count), its subcycle function
   (`make_subcycle_fn(m, io_layout="t")`) and its initial state
   (`initial_qdp_t`), the DCMIP tracers moved to lanes drawn from the seed;
   then the traffic's warm-up subcycles, the first one's output kept at the
   checked lanes;
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
4. the check: the plain reference (reference/) builds its own grid,
   levels, winds and initial state, runs the first subcycle and the
   closing subcycle (from the program's input to it) at the
   checked lanes, and both are compared with the program's outputs.
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


def load_cell(workload: str) -> Cell:
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
    if config.get("test_case") != traffic["winds"]:
        raise Refused(f"{workload}: the traffic's winds {traffic['winds']} "
                      f"are not the configuration's {config.get('test_case')}")
    return Cell(workload, int(w["chips"]), config, traffic, limits, spec)


def draw_lanes(seed: int, qsize: int, nlanes: int):
    """(fields, lanes): the initial field of each tracer lane, q1..q4 at
    lanes drawn from the seed and the checkerboard in the others, and the
    checked lanes: those of q1..q4 and checkerboard lanes drawn from the
    seed, each added to the half of the lanes that has fewer."""
    rng = np.random.default_rng(seed)
    nq = min(4, qsize)
    pos = [int(p) for p in rng.choice(qsize, size=nq, replace=False)]
    fields = ["checkerboard"] * qsize
    for i, p in enumerate(pos):
        fields[p] = f"q{i + 1}"
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
    """The port's production subcycle on one device, driven as a user
    drives it: the model, the subcycle function and the state in a
    one-element list."""

    def __init__(self, cell: Cell, device, fields, lanes, fault=None):
        import torch

        from transport_se_tpu_torch.config import perf_config
        from transport_se_tpu_torch.model.core import (
            build_model, initial_qdp_t, make_subcycle_fn)
        c, tr = cell.config, cell.traffic
        try:
            cfg = perf_config(c["ne"], dtype=c["dtype"], use_pallas=True)
        except KeyError:
            # a grid outside perf_config's table (the tests' small ones):
            # every setting below comes from the file all the same
            cfg = perf_config(30, dtype=c["dtype"], use_pallas=True)
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
        self.step = make_subcycle_fn(self.m, io_layout="t")
        if fault is not None:
            self.step = fault(self.step)
        self.sync()
        self.build["subcycle_fn"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.E = self.m.lon.shape[0]
        self.box = [initial_qdp_t(self.m)]
        self._place(fields)
        self.sync()
        self.build["state"] = time.perf_counter() - t0
        self.lanes = torch.as_tensor(lanes, device=device)
        self.nstep = 0
        self.events = []
        shape = (self.E, 16, len(lanes), cfg.nlev)
        self.kept = torch.empty(shape, dtype=self.m.dtype,
                                pin_memory=self.cuda)

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def _place(self, fields):
        """Move initial_qdp_t's tracers (q1..q4 first, then the
        checkerboard) to the lanes of `fields`, a lane swap at a time."""
        cfg = self.cfg
        view = self.box[0].view(self.E, 16, cfg.qsize, cfg.nlev)
        have = ([f"q{i + 1}" for i in range(min(4, cfg.qsize))]
                + ["checkerboard"] * max(0, cfg.qsize - 4))
        for a in range(cfg.qsize):
            if have[a] == fields[a]:
                continue
            b = next(j for j in range(a + 1, cfg.qsize)
                     if have[j] == fields[a] and have[j] != fields[j])
            tmp = view[:, :, a].clone()
            view[:, :, a] = view[:, :, b]
            view[:, :, b] = tmp
            have[a], have[b] = have[b], have[a]

    def keep(self):
        """Copy the checked lanes of the current state into the pinned
        buffer `kept`, in stream order: the gathered lanes are freed before
        the next subcycle allocates, so the copy never adds to its peak."""
        sel = self.box[0].view(self.E, 16, self.cfg.qsize, self.cfg.nlev) \
            .index_select(2, self.lanes)
        self.kept.copy_(sel, non_blocking=self.cuda)

    def kept_copy(self):
        """The kept lanes once copied, as a host tensor [E, 16, n, k]."""
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

def to_std(lanes_t, E, nk):
    """[E, 16, n, k] (the program's T layout at the checked lanes) ->
    [E, n, k, 4, 4] (the reference's)."""
    n = lanes_t.shape[2]
    return lanes_t.permute(0, 2, 3, 1).reshape(E, n, nk, 4, 4)


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
          control=None):
    """The reference's first subcycle from its own initial state and its
    closing subcycle from the program's input to it, against the program's
    outputs (or, with control="tf32", the reference computed with TF32
    matrix products in the program's place) -> {name: value}."""
    import torch

    from benchmark.reference import transport as R
    c = cell.config
    rcfg = dict(ne=c["ne"], nlev=c["nlev"], dtype=c["dtype"],
                tstep=float(c["tstep"]), rsplit=c["rsplit"],
                nu_q=float(c["nu_q"]), limiter_iter_cap=c["limiter_iter_cap"])
    t0 = time.perf_counter()
    rm = R.build_model(rcfg, device)
    E, nk = rm.lon.shape[0], c["nlev"]
    init = R.initial_fields(rm)
    Q0 = torch.stack([init[fields[lane]] for lane in lanes], 1) \
        * rm.dp0col[None, None, :, None, None]
    del init
    # about 1.5 GB of state a chunk
    chunk = max(1, int(1.5e9 // (E * 16 * nk * Q0.element_size())))
    log(f"check: reference model {time.perf_counter() - t0:.2f} s, "
        f"{len(lanes)} lanes in chunks of {chunk}")
    out = {}
    for name, Qin, nstep, got in (
            ("first", Q0, 0, first_out),
            ("last", to_std(last_in.to(device), E, nk), n_in, last_out)):
        t0 = time.perf_counter()
        want = reference_subcycle(rm, Qin, nstep, chunk)
        if control:
            got = reference_subcycle(rm, Qin, nstep, chunk, tf32=True)
        else:
            got = to_std(got.to(device), E, nk)
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
    cell = load_cell(workload)
    cell.config.update(config_overrides or {})
    cell.traffic.update(traffic_overrides or {})
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
    fields, lanes = draw_lanes(seed, tr["qsize"], CHECK_LANES)
    log(f"{workload} seed {seed}: q1-q4 at lanes "
        + ", ".join(str(fields.index(f"q{i + 1}"))
                    for i in range(min(4, tr["qsize"])))
        + f"; checked lanes {lanes}")

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
    prog.free()
    del prog

    values = check(cell, device, fields, lanes, first_out, last_in, n_in,
                   last_out, control=control)
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
