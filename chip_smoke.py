#!/usr/bin/env python3
"""Smoke run of transport_se_tpu_torch on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints one line or two; any failure exits non-zero before
the result lines):
  1. the card: name and power limit; TF32 off for matmuls and cuDNN
  2. build the CUDA kernels from csrc/ (one nvcc call, sm_90a)
  3. each T-path kernel against its plain PyTorch version at NE30 shapes
     (E=5400, 35 tracers x 72 levels), f32 and f64, with times: K1-K3 and
     the face trio K4 (in the five variants the face path takes), K5, K6;
     K1 bitwise at each stage kind, and its times at limiter iteration
     caps 1, 2, 4 and 15; K3 bitwise at alg 0 and 2, with its registers,
     shared memory and resident blocks per SM; K5 bitwise on the sphere
     and on every shard of S = 8, with its registers and spills, launch
     shape and resident blocks per SM; K6 bitwise with its registers,
     launch shape and resident blocks per SM
  4. the T-layout perf path, run_simulation(perf_config(30, f32,
     use_pallas=True)) in the production face DSS mode for 6 steps, then
     the same in gather mode (the path that runs K2): launch counts,
     min_dp, finiteness and tracer mass
  5. one NE30 face subcycle through the plain versions against the kernels
  6. one NE8 f64 T-layout subcycle in gather and one in face mode, kernels
     against plain versions
  7. five steady-state NE30 f32 T-layout subcycles timed with CUDA events,
     face mode, then gather mode for comparison; one more face subcycle
     under torch.profiler: device ms by kernel name and the idle share
  8. the row limiter K10 against its plain version at NE30 std shapes
     (1,555,200 rows of the DCMIP 1-1 stage 0 with its neighbor bounds),
     f32 and f64, bitwise, with times, registers and spills, launch shape
     and resident blocks per SM; then on the nine limiter inputs of the
     third subcycle of phase 12's configuration (steady state, f64):
     bitwise, its time, and the share of rows limited and relaxed and the
     histogram of iteration passes per row
  9. one NE8 f64 std-layout subcycle in gather and in segsum mode, kernels
     against plain versions; segsum twice, bitwise
 10. the CLI (python -m transport_se_tpu_torch.main, one subprocess per
     run) on the published f64 verification runs NE8 DCMIP 1-2 (1 day),
     NE30 DCMIP 1-2 (1 day) and NE8 DCMIP 1-1 (12 days): error norms
     against the published digits, mass drift, K10 launches
 11. exact restart through the CLI at NE8: 3 steps + restart + 3 steps
     gives the 6-step run's last history record bitwise
 12. three steady-state NE30 f64 std-layout subcycles (the NE30 CLI run's
     configuration) timed with CUDA events
 13. the banded face DSS K7 against its plain version at NE30 shapes, f32
     and f64, in its four variants, on every shard of 6 (row-aligned
     chunks) and of 8 (chunks cut rows), bit for bit; its raw and scale
     variants against K4; its times at S = 1 (one shard holds the sphere)
     and on shard 0 of S = 8 (partners in the halo); its registers and
     spills per variant (ptxas) and its launch shape and resident blocks
     per SM
 14. the sharded NE30 f32 face subcycle (perf_config, 35 tracers) through
     ThreadComm at S = 1, S = 8 and S = 8 with the face+overlap
     composition, against the single-device face subcycle: launch counts
     per shard, min_dp, tracer mass, time per subcycle
 15. the std-layout sharded subcycle, NE8 f64 DCMIP 1-1, 8 shards against
     one device
 16. the f32 verification of the production path: python -m
     transport_se_tpu_torch.verify (in-process) on NE8 DCMIP 1-1, 12 days,
     f32 --pallas (the T path through K1 and K3-K6), its L1, L2 and Linf
     within 1e-2 relative of the published f64 norms; then the
     conservation gate (python -m transport_se_tpu_torch.audit_drift) on
     the NE8 perf configuration over 12 days, drift below 2e-4
Then one JSON line of per-kernel results (the launches of K2 from the
gather run of phase 4, of K10 from the NE30 CLI run of phase 10, of K7
from the S = 8 run of phase 14, all others from the face run of phase 4;
each kernel's bound from its call's bytes and operations), the card line,
and as the last line {"ok": true, "device": {...}}.
"""

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NE = 30
N_TIMED = 5          # timed repetitions (median) per kernel and for phase 7
SWEEP_ITERS = (1, 2, 4, 15)   # K1's limiter iteration caps timed in phase 3
N_NAMES = 10         # kernel names printed by phase 7's profile
BURST = 20           # launches timed back to back (K6 in phase 3)
# kernel vs plain, max |kernel - plain| / max |plain|.  Both sides do the
# same operations in the same order (csrc/*.cu is built with --fmad=false),
# so the expected difference is 0.  f32: 1e-5 leaves room for a one-ulp
# difference flipping one limiter clip, which moves that column by about
# the clip residual; f64: 1e-12 is the JAX package's own f64 parity scale.
TOL = {"f32": 1e-5, "f64": 1e-12}
# relative change of the global tracer mass sum(spheremp*Qdp) per tracer
# over 6 f32 steps.  Every stage and the remap conserve mass exactly in
# exact arithmetic; f32 rounding (unit roundoff 6e-8) of the 18 stages and
# 2 remaps accumulates to about 1e-6 at most.
MASS_TOL = 1e-5

KERNELS = {
    "fused_advect_limit": ("transport_se_tpu_torch/csrc/euler.cu",
                           "transport_se_tpu/ops/pallas_euler.py:585"),
    "laplace_wk_t": ("transport_se_tpu_torch/csrc/euler.cu",
                     "transport_se_tpu/ops/pallas_euler.py:747"),
    "remap_q_ppm_t": ("transport_se_tpu_torch/csrc/ppm.cu",
                      "transport_se_tpu/ops/pallas_ppm.py:107"),
    "dss_face": ("transport_se_tpu_torch/csrc/dss.cu",
                 "transport_se_tpu/ops/pallas_dss.py:73"),
    "minmax_prep": ("transport_se_tpu_torch/csrc/dss.cu",
                    "transport_se_tpu/ops/pallas_dss.py:387"),
    "neighbor_minmax": ("transport_se_tpu_torch/csrc/dss.cu",
                        "transport_se_tpu/ops/pallas_dss.py:442"),
    "limiter_optim": ("transport_se_tpu_torch/csrc/limiter.cu",
                      "transport_se_tpu/ops/pallas_limiter.py:40"),
    "dss_band": ("transport_se_tpu_torch/csrc/band.cu",
                 "transport_se_tpu/ops/pallas_band.py:38"),
}
KEY = {"fused_advect_limit": "K1", "laplace_wk_t": "K2",
       "remap_q_ppm_t": "K3", "dss_face": "K4", "minmax_prep": "K5",
       "neighbor_minmax": "K6", "limiter_optim": "K10",
       "dss_band": "K7"}
# the single-device T path's kernels (phase 3); K10 has phase 8, K7 13
T_KERNELS = tuple(k for k in KERNELS if k not in ("limiter_optim",
                                                   "dss_band"))
# 6 steps = 2 subcycles.  The face path runs 4 face DSS per step (stage 0
# and 1 with the next stage's bounds, stage 1 also with the first
# Laplacian, stage 2's hyperviscosity input, stage 2's output with the
# time average) plus one per DCMIP 1-1 wind term (6) when the subcycle
# function builds its wind basis; one bound prep per subcycle; neighbor
# min/max on stages 0 and 2; no weak-Laplacian launch.
# The T path runs no K10 (K1 limits inside the fused stage).
FACE_COUNTS = {"fused_advect_limit": 18, "laplace_wk_t": 0,
               "remap_q_ppm_t": 2, "dss_face": 4 * 6 + 6, "minmax_prep": 2,
               "neighbor_minmax": 12, "limiter_optim": 0, "dss_band": 0}
GATHER_COUNTS = {"fused_advect_limit": 18, "laplace_wk_t": 6,
                 "remap_q_ppm_t": 2, "dss_face": 0, "minmax_prep": 0,
                 "neighbor_minmax": 0, "limiter_optim": 0, "dss_band": 0}
# The sharded face path, per shard and subcycle (rsplit = 3 steps): K7
# four times a step and six times when the subcycle function builds its
# wind basis (the DCMIP 1-1 terms); K1 once a stage, twice with the
# face+overlap composition (the boundary group's duplicate); K5 at the
# start and after the averaged third stage of the first two steps; K3
# once; never K4, K6 or K2.
SHARDED_SUBCYCLES = 4            # one warm-up, three timed
K7_VARIANTS = ("raw", "scale", "scale+minmax", "scale+minmax+lap")
SHARDED_S = 8


def sharded_counts(S, nsub, overlap):
    return {"dss_band": S * (6 + 4 * 3 * nsub),
            "fused_advect_limit": S * 9 * nsub * (2 if overlap else 1),
            "minmax_prep": S * 3 * nsub, "remap_q_ppm_t": S * nsub,
            "dss_face": 0, "neighbor_minmax": 0, "laplace_wk_t": 0,
            "limiter_optim": 0}
# The std-layout step launches K10 once per stage: 3 per tracer step.
K10_PER_STEP = 3

# The published f64 verification runs: (test, ne, tstep, nu_q, days, held)
# -> the norms as published are verify.PUBLISHED's (the reference
# README:94-96, 127-129; BASELINE.md); `held` replaces those of them that
# the port must give otherwise: the JAX package's own f64 result for the
# run, where that differs from the published one.  It differs for NE8
# DCMIP 1-2 only:
# `scripts/verify.py --test dcmip1-2 --ne 8 --platform cpu --dtype f64`
# gives L1 0.307660 and q_min -1.053362e-12 against the published 0.307665
# and -9.385639e-06 (L2, Linf and q_max as published).  There the Hadley
# downdraft moves a remap interface two source levels down; the JAX
# package's PPM cell search follows it, while the reference's walking loop
# stops one level down, and the JAX package with that one select removed
# gives every published digit.  tests/test_torch_cli.py
# (test_ne8_dcmip12_cli_matches_jax, marked slow) holds the port's CLI to
# the JAX package's CLI on this run on the CPU.  q_min is checked to 1e-3
# relative where it is a real undershoot (NE30 DCMIP 1-2), to roundoff
# scale (|q_min| < QMIN_ROUNDOFF, held q_min 0.0) where the JAX package's
# is, and only printed for NE8 DCMIP 1-1 (held q_min None).
QMIN_ROUNDOFF = 1e-10
NORM_KEYS = ("l1", "l2", "linf", "q_max", "q_min")
CLI_RUNS = (
    ("dcmip1-2", 8, 400.0, 6e16, 1, dict(l1=0.307660, q_min=0.0)),
    ("dcmip1-2", 30, 300.0, 1e15, 1, {}),
    ("dcmip1-1", 8, 400.0, 6e16, 12, dict(q_min=None)),
)
# phase 16: the f32 T path's norms against the published f64 norms of
# NE8 DCMIP 1-1, relative.  VERIFICATION.md holds the f32 path to 2-3
# digits of them (the JAX package's f32 run on its TPU came within 2e-3);
# 1e-2 catches a fault of the path, not its f32 roundoff
VERIFY_TOL = 1e-2
VERIFY_KERNELS = ("fused_advect_limit", "remap_q_ppm_t", "dss_face",
                  "minmax_prep", "neighbor_minmax")
# the relative tracer-mass drift of a run (the printstate masses); the
# JAX package's CPU runs show 2e-12 (NE8 1-2) and 5e-13 (NE30 1-2)
DRIFT_TOL = 1e-11


def namelist(test, ne, tstep, nu_q, days, nmax=0, restartfreq=-1,
             runtype=0, output=("days", None)):
    """The reference's namelist of a verification run (test/run_ne*_tests.sh
    settings: 72 acme levels, rsplit 3, limiter 8, 4 tracers; diagnostics
    every 12 hours rounded to whole subcycles, as scripts/verify.py).
    output: ("days", n) writes the history every n days (None: at the
    end), ("steps", n) every n steps."""
    units, freq = output
    if units == "days":
        tu, freq = 1, int(days) if freq is None else freq
    else:
        tu = 0
    length = f"ndays = {days}" if nmax == 0 else f"nmax = {nmax}"
    return f"""&ctl_nl
  test_case = "{test}"
  ne = {ne}
  qsize = 4
  {length}
  statefreq = {int(12 * 3600 / tstep) * 3}
  restartfreq = {restartfreq}
  restartfile = "./R0001"
  runtype = {runtype}
  tstep = {tstep:g}
  tstep_type = 1
  qsplit = 1
  rsplit = 3
  nu_q = {nu_q:g}
  limiter_option = 8
  prescribed_wind = 1
/
&vert_nl
  vfile_mid = "vcoord/acme-72m.ascii"
  vfile_int = "vcoord/acme-72i.ascii"
/
&analysis_nl
  output_dir = "./movies/"
  output_timeunits = {tu}
  output_frequency = {freq}
  output_varnames1 = 'Q','ps'
/
"""


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok, msg):
    if not ok:
        fail(msg)


def say(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# the bool template parameters of the kernels, for the ptxas report
FLAG_NAMES = {"euler_kernel": ("bih",),
              "dss_face_kernel": ("avg", "minmax", "lap"),
              "dss_band_kernel": ("scale", "minmax", "lap")}

# A kernel's bound: the least time the card could take for the call, the
# larger of its bytes (each input read once, each output written once) over
# the memory rate and its operations over the peak rate outside the tensor
# cores (NVIDIA's H100 SXM data sheet; the rates assume the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}
# floating-point operations, counted from the plain versions: per point of
# an (element, lane) column for the stage parts and the DSS epilogues, per
# (point, tracer, level) cell for the PPM remap, and one limiter pass per
# column or row (each makes at least one; how many more is the data's)
OPS = {"advect": 16 * 30, "limiter_iter": 16 * 8, "lap": 16 * 50,
       "ppm": 100, "dss_add": 3, "scale": 1, "avg": 3, "minmax": 2}


def bound(nbytes, nops, dtype):
    """(bound ms, "bytes" or "operations") of a call."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dss_cost(E, L, nk, es, avg=False, minmax=False, lap=False, scale=True,
             part=8):
    """(bytes, operations) of one face or band DSS call on [E, 16, L]:
    field in and out, the [E, 16, 3] partner table (part bytes a slot),
    rspheremp, and per variant the average, dp and the two bounds, the
    metric pack and the Laplacian."""
    F, EL = E * 16 * L, E * L
    nbytes = 2 * F * es + E * 48 * part + (E * 16 * es if scale else 0) \
        + (F * es if avg else 0) \
        + ((E * 16 * nk + 2 * EL) * es if minmax else 0) \
        + ((F + E * 160 + 16) * es if lap else 0)
    per = (OPS["dss_add"] + (OPS["scale"] if scale else 0)
           + (OPS["avg"] if avg else 0) + (OPS["minmax"] if minmax else 0))
    return nbytes, EL * (16 * per + (OPS["lap"] if lap else 0))


def dss_matrix(torch, part, rsp16):
    """The assembly as a sparse CSR matrix [E*16, E*16]: row p holds
    rsp16[p] at p and at each partner slot of part [E, 16, 3] (-1:
    none), so one torch.sparse.mm computes rsp * DSS(x)."""
    n = part.shape[0] * 16
    idx = torch.cat([torch.arange(n, device=part.device)[:, None],
                     part.reshape(n, 3)], dim=1)
    keep = idx >= 0
    crow = torch.zeros(n + 1, dtype=torch.int64, device=part.device)
    crow[1:] = keep.sum(dim=1).cumsum(0)
    vals = rsp16.reshape(n, 1).expand(n, 4)[keep]
    return torch.sparse_csr_tensor(crow, idx[keep], vals, (n, n),
                                   check_invariants=False)


def ptxas_usage(log_path):
    """'kernel<type> N regs, S B spill' per kernel from nvcc's -Xptxas -v."""
    if not log_path.exists():
        return ["no build log (library was cached)"]
    out, name = [], None
    for ln in log_path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"([a-z_]+_kernel)I([fd])((?:Lb[01]E)*)"
                          r"(?:Li(\d+)E)?", m.group(1))
            if k:
                on = [f for f, b in zip(FLAG_NAMES.get(k.group(1), ()),
                                        re.findall(r"Lb([01])", k.group(3)))
                      if b == "1"]
                # K7's last template argument: the lanes a thread owns
                vec = [f"V{k.group(4)}"] if k.group(4) else []
                name = (f"{k.group(1)}<"
                        + ",".join(["f32" if k.group(2) == "f" else "f64"]
                                   + on + vec) + ">")
            else:
                name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name} {m.group(1)} regs, {spill} B spill")
            name = None
    return out


def timed(torch, fn, n=N_TIMED):
    """Median milliseconds of fn() over n runs, CUDA events, after one
    warm-up run."""
    fn()
    ts = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def bits(torch, a):
    """a's bits as integers: -0 and +0 differ."""
    return a.view(torch.int32 if a.element_size() == 4 else torch.int64)


def rel_err(torch, got, want):
    """(max abs error, max abs error / max |want|), in f64."""
    d = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item()
    return d, d / scale if scale > 0 else d


def port_modules():
    """The port's modules this script drives, imported (the script's one
    import block of the port)."""
    from transport_se_tpu_torch import (_build, audit_drift, counters,
                                        k10_variants, verify)
    from transport_se_tpu_torch.config import (dcmip11_ne8, dcmip11_ne30,
                                               dcmip12_ne30, perf_config)
    from transport_se_tpu_torch.model import core, driver, wind_basis
    from transport_se_tpu_torch.norms import history_norms
    from transport_se_tpu_torch.ops import (band, dss_face, euler, limiter,
                                            remap)
    from transport_se_tpu_torch.parallel import (comm, face_sharded, halo,
                                                 sharded)
    return dict(_build=_build, audit_drift=audit_drift, counters=counters,
                k10_variants=k10_variants, verify=verify,
                dcmip11_ne8=dcmip11_ne8,
                dcmip11_ne30=dcmip11_ne30, dcmip12_ne30=dcmip12_ne30,
                perf_config=perf_config, core=core, driver=driver,
                wind_basis=wind_basis, history_norms=history_norms,
                band=band, dss_face=dss_face, euler=euler, limiter=limiter,
                remap=remap,
                comm=comm, face_sharded=face_sharded, halo=halo,
                sharded=sharded)


def main():
    try:
        import torch
    except ImportError as e:
        fail(f"PyTorch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    try:
        mods = port_modules()
    except ImportError as e:
        fail(f"transport_se_tpu_torch is not importable ({e}): run this "
             "from the repository root")
    _build, counters, core = mods["_build"], mods["counters"], mods["core"]
    dcmip11_ne30, dcmip12_ne30, perf_config = (
        mods["dcmip11_ne30"], mods["dcmip12_ne30"], mods["perf_config"])
    _tp, build_model = core._tp, core.build_model
    initial_qdp, make_subcycle_fn = core.initial_qdp, core.make_subcycle_fn
    run_simulation = mods["driver"].run_simulation
    build_wind_basis = mods["wind_basis"].build_wind_basis
    history_norms = mods["history_norms"]
    euler, limiter, remap = mods["euler"], mods["limiter"], mods["remap"]
    check("jax" not in sys.modules, "the port imported jax")
    check("transport_se_tpu" not in sys.modules,
          "the port imported the JAX package transport_se_tpu")
    dev = torch.device("cuda", 0)

    # ---- 1. the card -----------------------------------------------------
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"phase 1 card: {card}; {torch.cuda.get_device_name(0)}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off "
        "(torch.backends.cuda.matmul.allow_tf32 = cudnn.allow_tf32 = False)")

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    say(f"phase 2 build: {build_s:.1f} s (0 if cached); ptxas: "
        + "; ".join(ptxas_usage(_build.BUILD_DIR / "build.log")))

    # ---- 3. each kernel against its plain version at NE30 shapes ---------
    results = {k: {} for k in KERNELS}

    def stage_inputs(m):
        cfg = m.cfg
        E, nk, nq = m.lon.shape[0], cfg.nlev, cfg.qsize
        Qt = _tp(initial_qdp(m), E, nq * nk)
        wb = build_wind_basis(m)
        _, _, u, v, divdp, divp = wb.eval(
            torch.tensor(cfg.tstep, dtype=m.dtype, device=dev))
        dp0 = m.dp0col[None, None, :].expand(E, 16, nk).contiguous()
        mn, mx = m.tables.neighbor_minmax(*m.tables.minmax_prep(Qt, dp0, nq))
        return Qt, u, v, divdp, divp, mn, mx

    def phase3(dtype):
        cfg = perf_config(NE, dtype=dtype, use_pallas=True)
        m = build_model(cfg, dev)
        tb = m.tables
        E, nk, nq = m.lon.shape[0], cfg.nlev, cfg.qsize
        Qt, u, v, divdp, divp, mn, mx = stage_inputs(m)
        dt2 = cfg.dt_tracer / 2.0
        max_iter = cfg.limiter_iter_cap or euler.MAX_ITER
        rsp16 = m.rspheremp.reshape(E, 16)
        line = []
        errs = {}
        times = {k: ([], []) for k in T_KERNELS}
        bounds = {k: [] for k in T_KERNELS}
        libs = {}
        # bytes and operations per call (module docstring: bounds)
        es = Qt.element_size()
        F, EL, lv = E * 16 * nq * nk, E * nq * nk, E * 16 * nk

        def hold(name, kernel, plain, key, nbytes, nops):
            """Run kernel and plain on the same inputs, record the errors
            of every output, both times and the bound of the call."""
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            if isinstance(want, torch.Tensor):
                got, want = (got,), (want,)
            errs[name] = [rel_err(torch, g, w) for g, w in zip(got, want)]
            del got, want
            times[key][0].append(timed(torch, kernel))
            times[key][1].append(timed(torch, plain))
            bounds[key].append(bound(nbytes, nops, dtype))

        # K1, the three stage kinds: dp of stage s = dp0 - s*dt2*divdp_proj;
        # stage 2 adds the hyperviscosity of the DSS'd first Laplacian
        out0 = None
        sweep = {}
        for s in (0, 1, 2):
            dp = (m.dp0col[None, None, :] - s * dt2 * divp).contiguous()
            bih, nu = None, 0.0
            if s == 2:
                Q_t = (Qt.reshape(E, 16, nq, nk)
                       / dp[:, :, None, :]).reshape(Qt.shape)
                bih = tb.dss_scale_t(
                    euler.laplace_wk_t(Q_t, m.met, m.deriv), rsp16)
                nu = -3 * dt2 * cfg.nu_q
            args = (Qt, (u, v), dp, divdp, mn, mx, m.met, m.deriv, dt2)
            kw = dict(bih=bih, nu_coef=nu, dp0=m.dp0ref, max_iter=max_iter)
            hold(f"K1 stage{s}",
                 lambda: euler.fused_advect_limit(*args, **kw),
                 lambda: euler.fused_advect_limit_plain(*args, **kw),
                 "fused_advect_limit",
                 (2 * F + 4 * lv + 4 * EL + E * 160 + 16
                  + (F + nk if s == 2 else 0)) * es,
                 EL * (OPS["advect"] + OPS["limiter_iter"]
                       + (OPS["lap"] if s == 2 else 0)))
            if s == 0:
                out0 = euler.fused_advect_limit(*args, **kw)[0]
            # the limiter's share: K1's time at each iteration cap
            sweep[s] = [timed(torch, lambda: euler.fused_advect_limit(
                *args, **dict(kw, max_iter=it))) for it in SWEEP_ITERS]
        check(all(a == 0.0 for n, e in errs.items() if n.startswith("K1")
                  for a, _ in e), f"{dtype} K1 is not bitwise equal to its "
              f"plain version: {[errs[f'K1 stage{s}'] for s in range(3)]}")
        line.append("K1 ms at max_iter " + "/".join(map(str, SWEEP_ITERS))
                    + ": " + ", ".join(
                        f"stage{s} " + "/".join(f"{t:.3f}" for t in ts)
                        for s, ts in sweep.items()))
        Q_t = (Qt.reshape(E, 16, nq, nk)
               / m.dp0col[None, None, None, :]).reshape(Qt.shape)
        hold("K2", lambda: euler.laplace_wk_t(Q_t, m.met, m.deriv),
             lambda: euler.laplace_wk_t_plain(Q_t, m.met, m.deriv),
             "laplace_wk_t", (2 * F + E * 160 + 16) * es, EL * OPS["lap"])
        # one PyTorch call of K2: the Laplacian is linear, so a batched
        # product with each element's 16 x 16 matrix (its columns the
        # Laplacians of the unit vectors; timed, used nowhere in the port)
        M = euler.laplace_wk_t_plain(
            torch.eye(16, dtype=Qt.dtype, device=dev).expand(E, 16, 16)
            .contiguous(), m.met, m.deriv)
        lib_err = rel_err(torch, torch.bmm(M, Q_t),
                          euler.laplace_wk_t(Q_t, m.met, m.deriv))[1]
        check(lib_err < TOL[dtype], f"bmm Laplacian rel {lib_err:.3e}")
        libs["laplace_wk_t"] = timed(torch, lambda: torch.bmm(M, Q_t))
        line.append(f"K2 as one torch.bmm call {libs['laplace_wk_t']:.3f} "
                    f"ms (rel {lib_err:.1e} from K2)")
        del M
        del Q_t
        dps = (m.dp0col[None, None, :] - cfg.dt_remap * divp).contiguous()
        ps = m.hyai[0] * 1e5 + dps.sum(dim=2)
        dpr = ((m.hyai[1:] - m.hyai[:-1])[None, None, :] * 1e5
               + (m.hybi[1:] - m.hybi[:-1])[None, None, :] * ps[..., None])
        for alg in (0, 2):
            hold(f"K3 alg{alg}",
                 lambda: remap.remap_q_ppm_t(Qt, dps, dpr, alg=alg),
                 lambda: remap.remap_q_ppm_t_plain(Qt, dps, dpr, alg=alg),
                 "remap_q_ppm_t", (2 * F + 2 * lv) * es, F * OPS["ppm"])
        check(all(a == 0.0 for n, e in errs.items() if n.startswith("K3")
                  for a, _ in e), f"{dtype} K3 is not bitwise equal to its "
              f"plain version: {[errs[f'K3 alg{a}'] for a in (0, 2)]}")
        # K3's launch shape: registers and spills (ptxas), shared memory and
        # resident blocks per SM (the occupancy API)
        shape = remap.kernel_config(nq, nk, Qt.dtype)
        regs = [u for u in ptxas_usage(_build.BUILD_DIR / "build.log")
                if u.startswith(f"ppm_kernel<{dtype}>")]
        line.append(f"K3 {'; '.join(regs) or 'ptxas report not found'}; "
                    f"{shape['rows']} rows, {shape['threads']} threads, "
                    f"{shape['smem_bytes']} B shared a block, "
                    f"{shape['blocks_per_sm']} blocks/SM")
        # K4 in the face path's five variants, on a stage output with the
        # state as the time-average input; K5 and K6 on stage-1 bounds
        dp1 = (m.dp0col[None, None, :] - dt2 * divp).contiguous()
        variants = {"scale": {}, "scale+minmax": dict(dp=dp1),
                    "scale+minmax+lap": dict(dp=dp1, lap=True),
                    "scale+avg": dict(avg=Qt),
                    "scale+avg+minmax": dict(avg=Qt, dp=dp1)}
        for vname, kw in variants.items():
            if "dp" in kw:
                def run(plain, kw=kw):
                    r = tb.dss_scale_minmax_t(out0, rsp16, kw["dp"], nq,
                                              avg=kw.get("avg"),
                                              lap=kw.get("lap", False),
                                              plain=plain)
                    return r if kw.get("lap") else r[:3]
            else:
                def run(plain, kw=kw):
                    return tb.dss_scale_t(out0, rsp16, avg=kw.get("avg"),
                                          plain=plain)
            hold(f"K4 {vname}", lambda: run(False), lambda: run(True),
                 "dss_face", *dss_cost(E, nq * nk, nk, es, avg="avg" in kw,
                                       minmax="dp" in kw,
                                       lap=kw.get("lap", False), part=8))
        hold("K5", lambda: tb.minmax_prep(out0, dp1, nq),
             lambda: tb.minmax_prep(out0, dp1, nq, plain=True),
             "minmax_prep", (F + lv + 2 * EL) * es, EL * 16 * OPS["minmax"])
        # K5 bit for bit (-0 included) on the sphere and on every shard
        # of S = 8 (the sharded path's calls, chunks of the raster order),
        # with its launch shape
        eloc = E // SHARDED_S
        for sl in [slice(0, E)] + [slice(r * eloc, (r + 1) * eloc)
                                   for r in range(SHARDED_S)]:
            got = tb.minmax_prep(out0[sl], dp1[sl], nq)
            want = tb.minmax_prep(out0[sl], dp1[sl], nq, plain=True)
            check(all(torch.equal(bits(torch, a), bits(torch, b))
                      for a, b in zip(got, want)),
                  f"{dtype} K5 on elements {sl.start}:{sl.stop} is not "
                  "bitwise equal to its plain version")
            del got, want
        shape = mods["dss_face"].kernel_config(nq * nk, nk, Qt.dtype)
        regs = [u for u in ptxas_usage(_build.BUILD_DIR / "build.log")
                if u.startswith(f"minmax_kernel<{dtype}")]
        regs = "; ".join(regs) or "ptxas report not found"
        line.append(f"K5 bitwise on the sphere and every shard of S="
                    f"{SHARDED_S}; {regs}; {shape['vec']} lanes a thread, "
                    f"{shape['threads']} "
                    f"threads, {shape['groups']} lane groups an element, "
                    f"{shape['smem_bytes']} B shared a block, "
                    f"{shape['blocks_per_sm']} blocks/SM")
        bmn, bmx = tb.minmax_prep(out0, dp1, nq)
        hold("K6", lambda: tb.neighbor_minmax(bmn, bmx),
             lambda: tb.neighbor_minmax(bmn, bmx, plain=True),
             "neighbor_minmax", 4 * EL * es + E * 9 * 8, EL * 16)
        # K6 bit for bit (-0 included), with its launch shape
        check(all(torch.equal(bits(torch, a), bits(torch, b)) for a, b in
                  zip(tb.neighbor_minmax(bmn, bmx),
                      tb.neighbor_minmax(bmn, bmx, plain=True))),
              f"{dtype} K6 is not bitwise equal to its plain version")
        shape = mods["dss_face"].nbr_kernel_config(E, nq * nk, Qt.dtype)
        regs = [u for u in ptxas_usage(_build.BUILD_DIR / "build.log")
                if u.startswith(f"nbr_minmax_kernel<{dtype}")]
        regs = "; ".join(regs) or "ptxas report not found"
        # a K6 launch takes about 0.1 ms, so one launch between two events
        # also times the host's launch path: its time over a burst
        burst = timed(torch, lambda: [tb.neighbor_minmax(bmn, bmx)
                                      for _ in range(BURST)]) / BURST
        line.append(f"K6 bitwise; {burst:.4f} ms a launch over {BURST} "
                    f"back to back; {regs}; {shape['vec']} lanes a thread, "
                    f"{shape['threads']} threads a block, {shape['blocks']} "
                    f"blocks, {shape['smem_bytes']} B shared a block, "
                    f"{shape['blocks_per_sm']} blocks/SM")
        # one PyTorch call of K4's scale variant: a sparse product with the
        # rspheremp-scaled assembly matrix (timed, used nowhere in the port)
        A = dss_matrix(torch, tb.face.part, rsp16)
        lib = torch.sparse.mm(A, out0.reshape(E * 16, -1)).reshape(E, 16, -1)
        lib_err = rel_err(torch, lib, tb.dss_scale_t(out0, rsp16))[1]
        check(lib_err < TOL[dtype], f"sparse DSS product rel {lib_err:.3e}")
        libs["dss_face"] = timed(torch, lambda: torch.sparse.mm(
            A, out0.reshape(E * 16, -1)))
        line.append(f"K4 scale as one torch.sparse.mm call "
                    f"{libs['dss_face']:.3f} ms (rel {lib_err:.1e} from K4)")
        del A, lib
        del out0, bmn, bmx
        for name, e in errs.items():
            worst = max(r for _, r in e)
            line.append(f"{name} abs {max(a for a, _ in e):.3e} "
                        f"rel {worst:.3e}")
            check(worst <= TOL[dtype],
                  f"{dtype} {name}: kernel vs plain rel err {worst:.3e} > "
                  f"{TOL[dtype]:.0e}")
        for k, (tk, tp) in times.items():
            each = "" if len(tk) == 1 else " [" + ", ".join(
                f"{a:.3f}/{b:.3f}" for a, b in zip(tk, tp)) + "]"
            line.append(f"{k} {statistics.mean(tk):.3f} ms (plain "
                        f"{statistics.mean(tp):.3f} ms){each}")
            b_ms = statistics.mean(b for b, _ in bounds[k])
            line.append(f"{k} bound {b_ms:.3f} ms by "
                        + "/".join(sorted({w for _, w in bounds[k]})))
            if dtype == "f32":
                results[k] = dict(
                    max_abs_err=max(a for n, e in errs.items()
                                    if n.split()[0] == KEY[k] for a, _ in e),
                    ms=statistics.mean(tk), plain_ms=statistics.mean(tp),
                    bound_ms=b_ms, bound_by=bounds[k][0][1],
                    library_ms=libs.get(k))
        say(f"phase 3 kernels vs plain NE{NE} {dtype} (E={E}, L={nq * nk}, "
            f"k={nk}, max_iter={max_iter}, tol {TOL[dtype]:.0e}; times are "
            "means over the stage kinds, algorithms or variants, each the "
            "median of 5, [kernel/plain] per kind): " + "; ".join(line))
        return m if dtype == "f32" else None

    m = phase3("f32")
    torch.cuda.empty_cache()
    phase3("f64")
    torch.cuda.empty_cache()

    # ---- 4. the main path through the kernels ----------------------------
    def main_path(model, cfg, want_counts):
        E, nq, nk = model.lon.shape[0], cfg.qsize, cfg.nlev
        qdp0 = initial_qdp(model)
        sp = model.spheremp.double()
        mass0 = torch.einsum("eqkij,eij->q", qdp0.double(), sp)
        del qdp0
        counters.reset()
        res = run_simulation(cfg, dev, model=model)
        torch.cuda.synchronize()
        counts = counters.snapshot()
        for k, n in want_counts.items():
            check(counts[k] == n, f"{cfg.dss_mode}: {k} launched {counts[k]} "
                  f"times, want {n}")
            check(counts[k + "_plain"] == 0,
                  f"{cfg.dss_mode}: {k}_plain ran {counts[k + '_plain']} "
                  "times on the main path")
        finite = bool(torch.isfinite(res.state).all()) and \
            bool(torch.isfinite(res.q_final).all())
        check(finite, f"{cfg.dss_mode}: non-finite values in the final state")
        check(all(md > 0 for md in res.min_dp),
              f"{cfg.dss_mode}: min_dp {res.min_dp}")
        mass1 = torch.einsum("epqk,ep->q",
                             res.state.double().reshape(E, 16, nq, nk),
                             sp.reshape(E, 16))
        dmass = ((mass1 - mass0).abs() / mass0.abs()).max().item()
        check(dmass < MASS_TOL, f"{cfg.dss_mode}: tracer mass change "
              f"{dmass:.3e} >= {MASS_TOL}")
        say(f"phase 4 main path NE{NE} f32 {cfg.dss_mode}, {cfg.nsteps} "
            "steps: launches "
            + ", ".join(f"{k} {v}" for k, v in counts.items())
            + f"; min_dp per subcycle {res.min_dp}; finite {finite}; max "
            f"relative tracer-mass change {dmass:.3e} (bound "
            f"{MASS_TOL:.0e}); wall {res.wall_seconds:.3f} s")
        del res
        return counts

    cfg = perf_config(NE, dtype="f32", nmax=6, use_pallas=True)
    check(cfg.dss_mode == "face" and cfg.elem_order == "raster",
          f"perf_config gives {cfg.dss_mode}/{cfg.elem_order}")
    check(core.uses_t_layout(cfg), "the perf config does not take the T path")
    E, nq, nk = m.lon.shape[0], cfg.qsize, cfg.nlev
    face_counts = main_path(m, cfg, FACE_COUNTS)
    cfg_g = perf_config(NE, dtype="f32", dss_mode="gather", nmax=6,
                        use_pallas=True)
    m_g = build_model(cfg_g, dev)
    gather_counts = main_path(m_g, cfg_g, GATHER_COUNTS)
    launches = {k: (gather_counts if k == "laplace_wk_t" else face_counts)[k]
                for k in T_KERNELS}

    # ---- 5. one face subcycle through the plain versions -----------------
    Qt0 = _tp(initial_qdp(m), E, nq * nk)
    out_k = make_subcycle_fn(m, io_layout="t")(Qt0, 0)[0]
    counters.reset()
    out_p = make_subcycle_fn(m, io_layout="t", plain=True)(Qt0, 0)[0]
    torch.cuda.synchronize()
    pc = counters.snapshot()
    check(all(pc[k] == 0 for k in KERNELS) and pc["dss_face_plain"] > 0
          and pc["minmax_prep_plain"] > 0 and pc["neighbor_minmax_plain"] > 0,
          f"plain subcycle launched kernels or skipped plain versions: {pc}")
    a, r = rel_err(torch, out_k, out_p)
    check(r <= TOL["f32"], f"NE{NE} subcycle kernels vs plain rel {r:.3e}")
    say(f"phase 5 NE{NE} f32 face subcycle kernels vs plain: max abs "
        f"{a:.3e}, max rel {r:.3e} (tol {TOL['f32']:.0e}); plain run "
        "counts " + ", ".join(f"{k} {v}" for k, v in pc.items() if v))
    del out_k, out_p

    # ---- 6. NE8 f64 subcycles, gather and face ---------------------------
    for mode in ("gather", "face"):
        cfg8 = perf_config(8, dtype="f64", dss_mode=mode, use_pallas=True)
        m8 = build_model(cfg8, dev)
        Q8 = _tp(initial_qdp(m8), m8.lon.shape[0], cfg8.qsize * cfg8.nlev)
        counters.reset()
        o_k, _, _, md_k = make_subcycle_fn(m8, io_layout="t")(Q8, 0)
        kc = counters.snapshot()
        o_p, _, _, md_p = make_subcycle_fn(m8, io_layout="t", plain=True)(
            Q8, 0)
        a8, r8 = rel_err(torch, o_k, o_p)
        check(bool(torch.isfinite(o_k).all()), f"NE8 f64 {mode}: non-finite")
        check(r8 <= TOL["f64"],
              f"NE8 f64 {mode} subcycle kernels vs plain rel {r8:.3e}")
        want_k = ("laplace_wk_t",) if mode == "gather" else (
            "dss_face", "minmax_prep", "neighbor_minmax")
        check(all(kc[k] > 0 for k in want_k), f"NE8 {mode} launches {kc}")
        say(f"phase 6 NE8 f64 {mode} DCMIP 1-1 subcycle kernels vs plain: "
            f"max abs {a8:.3e}, max rel {r8:.3e} (tol {TOL['f64']:.0e}); "
            f"min_dp {float(md_k):.6g} / {float(md_p):.6g}; launches "
            + ", ".join(f"{k} {v}" for k, v in kc.items() if v))
        del m8, Q8, o_k, o_p

    # ---- 7. steady-state subcycle time -----------------------------------
    def steady(model):
        step = make_subcycle_fn(model, io_layout="t")
        Qt, _, nstep, _ = step(_tp(initial_qdp(model), E, nq * nk), 0)
        torch.cuda.synchronize()
        per = []
        t0 = time.perf_counter()
        for _ in range(N_TIMED):
            a_ev = torch.cuda.Event(enable_timing=True)
            b_ev = torch.cuda.Event(enable_timing=True)
            a_ev.record()
            Qt, _, nstep, _ = step(Qt, nstep)
            b_ev.record()
            per.append((a_ev, b_ev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(bool(torch.isfinite(Qt).all()), "phase 7: non-finite state")
        return [a_ev.elapsed_time(b_ev) for a_ev, b_ev in per], wall

    def profile(model):
        """Device ms by kernel name and the idle share of one steady-state
        subcycle under torch.profiler (after a warm-up subcycle)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        step = make_subcycle_fn(model, io_layout="t")
        Qt, _, nstep, _ = step(_tp(initial_qdp(model), E, nq * nk), 0)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as pr:
            step(Qt, nstep)
            torch.cuda.synchronize()
        spans = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                       for ev in pr.events()
                       if ev.device_type == DeviceType.CUDA)
        check(bool(spans), "phase 7: the profiler saw no device activity")
        by_name, busy, end = {}, 0.0, spans[0][0]
        for a, b, name in spans:
            # a kernel's name without its namespace, arguments and template
            # arguments, e.g. euler_kernel or vectorized_elementwise_kernel
            short = re.split(r"[<(]", name.replace(
                "(anonymous namespace)::", "").removeprefix("void "))[0]
            short = short.split("::")[-1].strip()
            by_name[short] = by_name.get(short, 0.0) + (b - a) / 1e3
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        span_ms = (end - spans[0][0]) / 1e3
        return by_name, busy / 1e3, span_ms

    for mode, model in (("face", m), ("gather", m_g)):
        sub_ms, wall = steady(model)
        rate = N_TIMED * cfg.rsplit * E * 16 * nk * nq / wall
        say(f"phase 7 NE{NE} f32 {mode} steady state: {N_TIMED} subcycles, "
            f"per subcycle (CUDA events) median "
            f"{statistics.median(sub_ms):.2f} ms, min {min(sub_ms):.2f}, max "
            f"{max(sub_ms):.2f}; host wall {wall / N_TIMED * 1e3:.2f} "
            f"ms/subcycle; {rate:.4e} gridpoint-tracers/s "
            f"(steps*E*16*nlev*qsize/wall, information only) on {card}")
        if mode == "face":
            by_name, busy, span = profile(model)
            top = sorted(by_name.items(), key=lambda kv: -kv[1])
            rest = sum(t for _, t in top[N_NAMES:])
            say(f"phase 7 NE{NE} f32 face subcycle under torch.profiler: "
                f"device span {span:.2f} ms, busy {busy:.2f} ms, idle "
                f"{1 - busy / span:.1%}; device ms by kernel: "
                + ", ".join(f"{k} {t:.2f}" for k, t in top[:N_NAMES])
                + f", {max(0, len(top) - N_NAMES)} others {rest:.2f}")

    del m, m_g
    torch.cuda.empty_cache()

    # ---- 8. K10 against its plain version at NE30 std shapes -------------
    def stage0_args(model):
        """The limiter arguments of stage 0 of the model's initial state
        (DCMIP winds at t=0, the neighbor bounds), as the std step makes
        them: (ptens [E,q,k,16], spheremp [E,16], dp_star [E,k,16], qmin,
        qmax)."""
        c = model.cfg
        Qdp = initial_qdp(model)
        vn0 = core.dcmip.winds(c.test_case, model.lon, model.lat,
                               model.etam, 0.0) \
            * model.dp0col[None, :, None, None, None]
        divdp = core.so.divergence_sphere(vn0, model.deriv, model.Dinv,
                                          model.metdet, model.rmetdet)
        zero = Qdp.new_zeros(Qdp.shape[:3])
        Qtens, qmn, qmx, dp_star = core.euler_stage_tens(
            model, Qdp, zero, zero, divdp, divdp, vn0, c.dt_tracer / 2.0, 0)
        return (*core.limiter_args(model, Qtens, dp_star), qmn, qmx)

    for dtype in ("f32", "f64"):
        m10 = build_model(dcmip11_ne30(dtype=dtype), dev)
        ptens, sph, dps, qmn, qmx = stage0_args(m10)
        nrows = qmn.numel()
        del m10
        args = (ptens, sph, dps, qmn, qmx)
        got = limiter.limiter_optim_stage(*args)
        want = limiter.limiter_optim_stage(*args, plain=True)
        # the JAX signature's [N, 16] rows: the same kernel, full operands
        full = (ptens, sph[:, None, None].expand(ptens.shape).contiguous(),
                qmn, qmx, dps[:, None].expand(ptens.shape).contiguous())
        got_f = limiter.limiter_optim_iter_full(*full)
        torch.cuda.synchronize()
        errs = [rel_err(torch, g, w) for g, w in zip(got + got_f, want * 2)]
        worst = max(r for _, r in errs)
        check(all(torch.equal(bits(torch, g), bits(torch, w))
                  for g, w in zip(got + got_f, want * 2)),
              f"K10 {dtype}: not bitwise equal to its plain version")
        limited = (want[0] != ptens).any(-1).double().mean().item()
        relaxed = ((want[1] != qmn) | (want[2] != qmx)).double().mean().item()
        del got, want, got_f, full
        ms_k = timed(torch, lambda: limiter.limiter_optim_stage(*args))
        ms_p = timed(torch,
                     lambda: limiter.limiter_optim_stage(*args, plain=True))
        nbytes = (2 * ptens.numel() + sph.numel() + dps.numel()
                  + 4 * nrows) * ptens.element_size()
        b_ms, b_by = bound(nbytes, nrows * OPS["limiter_iter"], dtype)
        check(worst <= TOL[dtype], f"K10 {dtype}: kernel vs plain rel err "
              f"{worst:.3e} > {TOL[dtype]:.0e}")
        # K10's launch shape and registers
        shape = limiter.kernel_config(ptens.dtype)
        regs = [u for u in ptxas_usage(_build.BUILD_DIR / "build.log")
                if u.startswith(f"limiter_kernel<{dtype}")]
        say(f"phase 8 K10 vs plain NE30 {dtype}, {nrows} rows of the DCMIP "
            f"1-1 stage 0 ({limited:.1%} of rows limited, {relaxed:.1%} with "
            f"a relaxed bound; stage operands, and [N, 16] operands through "
            f"limiter_optim_iter_full): bitwise equal, max abs "
            f"{max(a for a, _ in errs):.3e}, max rel {worst:.3e} (tol "
            f"{TOL[dtype]:.0e}); {ms_k:.3f} ms (plain {ms_p:.3f} ms), "
            f"{nbytes / 1e9:.3f} GB moved, {nbytes / ms_k / 1e9:.3f} TB/s; "
            f"bound {b_ms:.3f} ms by {b_by}; "
            f"{'; '.join(regs) or 'ptxas report not found'}; "
            f"{shape['row_lanes']} lanes a row, {shape['threads']} threads "
            f"a block, {shape['blocks_per_sm']} blocks/SM")
        if dtype == "f64":
            results["limiter_optim"] = dict(
                max_abs_err=max(a for a, _ in errs), ms=ms_k, plain_ms=ms_p,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del ptens, sph, dps, qmn, qmx, args
        torch.cuda.empty_cache()
    # K10 on the limiter input of a steady-state std NE30 f64 subcycle: the
    # nine launches of the third subcycle of phase 12's configuration
    k10v = mods["k10_variants"]
    m8 = build_model(dcmip12_ne30(), dev)
    steady = k10v.steady_inputs(m8)
    del m8
    for a in steady:
        want = limiter.limiter_optim_stage(*a, plain=True)
        pt, sp, dps, mn, mx = a
        got = limiter.limiter_optim_stage(*a)
        got += limiter.limiter_optim_iter_full(
            pt, sp[:, None, None].expand(pt.shape).contiguous(), mn, mx,
            dps[:, None].expand(pt.shape).contiguous())
        check(all(torch.equal(bits(torch, g), bits(torch, w))
                  for g, w in zip(got, want * 2)),
              "K10 f64 on the steady-state input: not bitwise equal to its "
              "plain version")
        del want, got
    ms_s = timed(torch, lambda: [limiter.limiter_optim_stage(*a)
                                 for a in steady])
    say(f"phase 8 K10 on the steady-state std NE30 f64 DCMIP 1-2 input (the "
        f"{len(steady)} launches of the third subcycle), stage and [N, 16] "
        f"operands bitwise equal to the plain version: {ms_s:.3f} ms for "
        f"the {len(steady)}, {ms_s / len(steady):.3f} ms a launch; "
        + k10v.describe(steady))
    del steady
    torch.cuda.empty_cache()

    # ---- 9. NE8 f64 std-layout subcycles, gather and segsum --------------
    dcmip11_ne8 = mods["dcmip11_ne8"]
    for mode in ("gather", "segsum"):
        m8 = build_model(dcmip11_ne8(dss_mode=mode), dev)
        check(not core.uses_t_layout(m8.cfg), "NE8 std config takes T path")
        Q8 = initial_qdp(m8)
        counters.reset()
        o_k, _, n8, md_k = make_subcycle_fn(m8)(Q8, 0)
        torch.cuda.synchronize()
        kc = counters.snapshot()
        o_p = make_subcycle_fn(m8, plain=True)(Q8, 0)[0]
        pc = {k: v for k, v in counters.snapshot().items() if v}
        a8, r8 = rel_err(torch, o_k, o_p)
        check(kc["limiter_optim"] == K10_PER_STEP * n8
              and kc["limiter_optim_plain"] == 0,
              f"NE8 std {mode}: launches {kc}")
        check(r8 <= TOL["f64"],
              f"NE8 f64 std {mode} subcycle kernels vs plain rel {r8:.3e}")
        check(bool(torch.isfinite(o_k).all()), f"NE8 std {mode}: non-finite")
        again = ""
        if mode == "segsum":
            o_2 = make_subcycle_fn(m8)(Q8, 0)[0]
            check(torch.equal(o_2, o_k), "segsum: two runs differ")
            again = "; a second run bitwise equal"
        say(f"phase 9 NE8 f64 std {mode} DCMIP 1-1 subcycle kernels vs "
            f"plain: max abs {a8:.3e}, max rel {r8:.3e} (tol "
            f"{TOL['f64']:.0e}); min_dp {float(md_k):.6g}; launches "
            + ", ".join(f"{k} {v}" for k, v in kc.items() if v)
            + f"; plain run {pc}{again}")
        del m8, Q8, o_k, o_p

    # ---- 10. the CLI on the published verification runs ------------------
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    k10_launches = None
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        for test, ne, tstep, nu_q, days, held in CLI_RUNS:
            pub = dict(zip(NORM_KEYS, mods["verify"].PUBLISHED[(test, ne)]))
            by_jax = any(k in held for k in NORM_KEYS[:4])
            held = dict(pub, **held)
            d = Path(tmp) / f"{test}_ne{ne}"
            d.mkdir()
            (d / "run.nl").write_text(namelist(test, ne, tstep, nu_q, days))
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "transport_se_tpu_torch.main",
                 "run.nl", "--quiet"], cwd=d, env=env, capture_output=True,
                text=True, timeout=900)
            wall = time.perf_counter() - t0
            (d / "out.txt").write_text(proc.stdout + proc.stderr)
            check(proc.returncode == 0, f"CLI {test} NE{ne} exited "
                  f"{proc.returncode}: {proc.stderr[-3000:]}")
            out = proc.stdout
            done = re.search(r"done: (\d+) steps, wall ([\d.]+) s, max "
                             r"relative tracer-mass drift (\S+)", out)
            lines = re.search(r"^launches: (.*)$", out, re.M)
            check(done is not None and lines is not None,
                  f"CLI {test} NE{ne}: no done/launches line:\n{out[-2000:]}")
            nsteps, run_wall, drift = (int(done.group(1)),
                                       float(done.group(2)),
                                       float(done.group(3)))
            launched = dict((k, int(v)) for k, v in (
                item.rsplit(" ", 1) for item in lines.group(1).split(", ")))
            check(launched.get("limiter_optim") == K10_PER_STEP * nsteps
                  and not any(k.endswith("_plain") for k in launched),
                  f"CLI {test} NE{ne}: launches {launched}, want "
                  f"limiter_optim {K10_PER_STEP * nsteps} and no plain")
            check(drift < DRIFT_TOL, f"CLI {test} NE{ne}: mass drift "
                  f"{drift:.3e} >= {DRIFT_TOL:.0e}")
            nrm = history_norms(str(d / "movies" / f"{test}1.nc"), test, ne)
            keys = ("l1", "l2", "linf", "q_max")
            for key in keys:
                check(f"{getattr(nrm, key):.6f}" == f"{held[key]:.6f}",
                      f"CLI {test} NE{ne}: {key} {getattr(nrm, key):.6f} != "
                      f"{held[key]:.6f}")
            if held["q_min"] == 0.0:
                check(abs(nrm.q_min) < QMIN_ROUNDOFF,
                      f"CLI {test} NE{ne}: q_min {nrm.q_min:.6e} is not at "
                      f"roundoff scale (< {QMIN_ROUNDOFF:.0e})")
            elif held["q_min"] is not None:
                check(abs(nrm.q_min - held["q_min"])
                      <= 1e-3 * abs(held["q_min"]),
                      f"CLI {test} NE{ne}: q_min {nrm.q_min:.6e} vs "
                      f"{held['q_min']:.6e}")
            if ne == NE:
                k10_launches = launched["limiter_optim"]
            same = [k for k in keys
                    if f"{getattr(nrm, k):.6f}" == f"{pub[k]:.6f}"]
            say(f"phase 10 CLI {test} NE{ne} f64, {days} day(s), {nsteps} "
                f"steps: {nrm}; published L1={pub['l1']:.6f} "
                f"L2={pub['l2']:.6f} Linf={pub['linf']:.6f} "
                f"q_max={pub['q_max']:.6f}"
                + (f" q_min={pub['q_min']:.6e}" if pub["q_min"] else "")
                + f" ({len(same)} of 4 published to six decimals; held to "
                + ("the JAX package's digits" if by_jax
                   else "the published digits")
                + f"); max relative mass drift {drift:.3e}; launches "
                f"{launched}; run wall {run_wall:.2f} s, process wall "
                f"{wall:.2f} s")
    check(k10_launches is not None, "no NE30 CLI run")
    launches["limiter_optim"] = k10_launches

    # ---- 11. exact restart through the CLI -------------------------------
    from transport_se_tpu_torch.main import main as cli_main
    from scipy.io import netcdf_file

    def cli(d, **kw):
        (d / "run.nl").write_text(namelist("dcmip1-2", 8, 400.0, 6e16, 1,
                                           output=("steps", 3), **kw))
        here = os.getcwd()
        os.chdir(d)
        try:
            with contextlib.redirect_stdout(io.StringIO()) as buf:
                code = cli_main(["run.nl", "--quiet"])
        finally:
            os.chdir(here)
        check(code == 0, f"CLI restart run {kw} exited {code}")
        return buf.getvalue()

    def last_record(d):
        with netcdf_file(str(d / "movies" / "dcmip1-21.nc"), "r",
                         mmap=False) as f:
            return {k: f.variables[k][-1].copy() for k in ("Q", "Q2", "ps")}

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        straight, split = Path(tmp) / "straight", Path(tmp) / "split"
        straight.mkdir()
        split.mkdir()
        cli(straight, nmax=6)
        out1 = cli(split, nmax=3, restartfreq=3)
        out2 = cli(split, nmax=6, runtype=1)
        check("wrote restart ./R0001 at nstep=3" in out1
              and "restart (runtype=1)" in out2, "restart runs: " + out2)
        want_r, got_r = last_record(straight), last_record(split)
        same = all(bool((want_r[k] == got_r[k]).all()) for k in want_r)
        check(same, "exact restart through the CLI is not bitwise")
        say("phase 11 exact restart through the CLI, NE8 f64 DCMIP 1-2: 6 "
            "steps straight == 3 steps + restart + 3 steps, last history "
            "record (Q, Q2, ps) bitwise equal")

    # ---- 12. steady-state NE30 f64 std-layout subcycle -------------------
    m12 = build_model(dcmip12_ne30(), dev)
    step = make_subcycle_fn(m12)
    Qdp, _, nstep, _ = step(initial_qdp(m12), 0)
    torch.cuda.synchronize()
    per = []
    t0 = time.perf_counter()
    for _ in range(3):
        a_ev = torch.cuda.Event(enable_timing=True)
        b_ev = torch.cuda.Event(enable_timing=True)
        a_ev.record()
        Qdp, _, nstep, _ = step(Qdp, nstep)
        b_ev.record()
        per.append((a_ev, b_ev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(bool(torch.isfinite(Qdp).all()), "phase 12: non-finite state")
    sub_ms = [a_ev.elapsed_time(b_ev) for a_ev, b_ev in per]
    say(f"phase 12 NE30 f64 std DCMIP 1-2 steady state: 3 subcycles, per "
        f"subcycle (CUDA events) median {statistics.median(sub_ms):.2f} ms, "
        f"min {min(sub_ms):.2f}, max {max(sub_ms):.2f}; host wall "
        f"{wall / 3 * 1e3:.2f} ms/subcycle on {card}")
    del m12, Qdp
    torch.cuda.empty_cache()

    # ---- 13. K7 against its plain version, and its times -----------------
    band, fsm, halo_mod = mods["band"], mods["face_sharded"], mods["halo"]

    def band_shards(model, S):
        """(local slice, halo_gid, ShardedFaceTables) of each shard of the
        model's raster grid cut into S chunks."""
        g, ne = model.grid, model.cfg.ne
        plan = halo_mod.build_shard_plan(g, S)
        ftd = mods["dss_face"].build_face_tables(g.part_idx, g.part_mask, ne)
        stack = fsm.build_sharded_face_tables(g, plan, ftd)
        roles = fsm.band_roles(plan, ftd, ne)
        for r in range(S):
            sl = slice(r * plan.eloc, (r + 1) * plan.eloc)
            yield sl, torch.as_tensor(plan.halo_gid[r], device=dev), \
                fsm.ShardedFaceTables.from_stack(
                    stack, roles, r, plan.nhalo, dev, met=model.met[sl],
                    deriv=model.deriv), stack["_dims"]

    def band_variants(sl, rsp16, dp):
        return {"raw": {}, "scale": dict(rsp=rsp16[sl]),
                "scale+minmax": dict(rsp=rsp16[sl], dp=dp[sl]),
                "scale+minmax+lap": dict(rsp=rsp16[sl], dp=dp[sl], lap=True)}

    k7 = dict(err=0.0, k4=0.0)
    for dtype in ("f32", "f64"):
        m13 = build_model(perf_config(NE, dtype=dtype, use_pallas=True), dev)
        cfg13 = m13.cfg
        E, nq, nk = m13.lon.shape[0], cfg13.qsize, cfg13.nlev
        L = nq * nk
        x, _, _, _, divp, _, _ = stage_inputs(m13)
        dp1 = (m13.dp0col[None, None, :]
               - cfg13.dt_tracer / 2.0 * divp).contiguous()
        rsp16 = m13.rspheremp.reshape(E, 16)
        # K4 on the whole sphere; it adds a three-partner slot (an interior
        # element corner) as (x + (x partner + corner)) + y partner, the
        # band as ((x + x partner) + y partner) + corner
        k4 = {"raw": m13.tables.dss_sum_t(x),
              "scale": m13.tables.dss_scale_t(x, rsp16)}
        three = (m13.tables.face.part >= 0).all(-1)
        eps = torch.finfo(m13.dtype).eps
        notes = []
        for S in (6, 8):
            n_sh = 0
            for sl, hg, t, dims in band_shards(m13, S):
                halo = torch.where((hg >= 0)[:, None, None],
                                   x.index_select(0, hg.clamp(min=0)), 0.0)
                ext = torch.cat([x[sl], halo])
                for vname, kw in band_variants(sl, rsp16, dp1).items():
                    got = band.dss_band(x[sl], ext, t, nq=nq, **kw)
                    want = band.dss_band_plain(x[sl], ext, t, nq=nq, **kw)
                    if isinstance(got, torch.Tensor):
                        got, want = (got,), (want,)
                    torch.cuda.synchronize()
                    err = max((a - b).abs().max().item()
                              for a, b in zip(got, want))
                    k7["err"] = max(k7["err"], err)
                    check(all(torch.equal(bits(torch, a), bits(torch, b))
                              for a, b in zip(got, want)),
                          f"K7 {dtype} S={S} {vname}: not bitwise equal to "
                          f"its plain version (max abs {err:.3e})")
                    if vname in k4:
                        ref, th = k4[vname][sl], three[sl]
                        check(torch.equal(got[0][~th], ref[~th]),
                              f"K7 {dtype} S={S} {vname}: differs from K4 "
                              "off the three-partner slots")
                        d = (got[0] - ref)[th].abs().max().item()
                        lim = 16 * eps * ref.abs().max().item()
                        k7["k4"] = max(k7["k4"], d / ref.abs().max().item())
                        check(d <= lim, f"K7 {dtype} S={S} {vname}: "
                              f"{d:.3e} from K4 at three-partner slots")
                    del got, want
                del ext, halo
                n_sh += 1
            notes.append(f"S={S} ({n_sh} shards of {E // S}, band_o_static "
                         f"{dims['band_o_static']})")
        del k4
        # times at S = 1: one shard holds the sphere, K4's inputs
        sl, hg, t, _ = next(band_shards(m13, 1))
        halo = x.new_zeros((t.nhalo, 16, L))
        es = x.element_size()
        tk, tp, tb = [], [], []
        for vname, kw in band_variants(sl, rsp16, dp1).items():
            tk.append(timed(torch, lambda: band.dss_band(x, halo, t, nq=nq,
                                                         **kw)))
            tp.append(timed(torch, lambda: band.dss_band_plain(
                x, halo, t, nq=nq, **kw)))
            tb.append(bound(*dss_cost(
                E, L, nk, es, minmax="dp" in kw, lap=kw.get("lap", False),
                scale="rsp" in kw, part=4), dtype))
        # times on shard 0 of S = 8: 675 elements, partners in the halo
        sl8, hg8, t8, _ = next(band_shards(m13, 8))
        x8 = x[sl8]
        halo8 = torch.where((hg8 >= 0)[:, None, None],
                            x.index_select(0, hg8.clamp(min=0)), 0.0)
        t8k = [timed(torch, lambda: band.dss_band(x8, halo8, t8, nq=nq,
                                                  **kw))
               for kw in band_variants(sl8, rsp16, dp1).values()]
        del x8, halo8, t8
        A = dss_matrix(torch, m13.tables.face.part, rsp16)
        lib_ms = timed(torch, lambda: torch.sparse.mm(A, x.reshape(E * 16,
                                                                   L)))
        del A
        # the launch shape of each variant and the registers of each
        # instantiation (V: lanes a thread)
        shapes = [band.kernel_config(L, nk, x.dtype, rsp=v != "raw",
                                     dp="minmax" in v, lap=v.endswith("lap"))
                  for v in K7_VARIANTS]
        regs = [u for u in ptxas_usage(_build.BUILD_DIR / "build.log")
                if u.startswith(f"dss_band_kernel<{dtype}")]
        say(f"phase 13 K7 vs plain NE{NE} {dtype}, {nq} x {nk} lanes, "
            f"every shard of " + ", ".join(notes) + ", raw/scale/"
            "scale+minmax/scale+minmax+lap: bitwise equal to dss_band_plain "
            f"(max abs {k7['err']:.3e}); raw and scale against K4: bitwise "
            "off the three-partner slots, there within "
            f"{k7['k4']:.3e} of the field max; S=1 times (CUDA events, "
            "median of 5) " + ", ".join(
                f"{v} {a:.3f} ms (plain {b:.3f}, bound {c[0]:.3f} by "
                f"{c[1]})" for v, a, b, c in zip(
                    K7_VARIANTS, tk, tp, tb))
            + "; shard 0 of S=8 times " + ", ".join(
                f"{v} {a:.3f} ms" for v, a in zip(K7_VARIANTS, t8k))
            + f"; scale as one torch.sparse.mm call {lib_ms:.3f} ms; launch "
            "shape (lanes a thread/threads/lane groups an element/shared B "
            "a block/resident blocks an SM) " + ", ".join(
                f"{v} {c['vec']}/{c['threads']}/{c['groups']}/"
                f"{c['smem_bytes']}/{c['blocks_per_sm']}"
                for v, c in zip(K7_VARIANTS, shapes))
            + "; ptxas " + "; ".join(regs or ["report not found"])
            + "; on " + card)
        if dtype == "f32":
            results["dss_band"] = dict(
                ms=statistics.mean(tk), plain_ms=statistics.mean(tp),
                bound_ms=statistics.mean(b for b, _ in tb),
                bound_by=tb[0][1], library_ms=lib_ms)
        del m13, x, dp1, halo, t
        torch.cuda.empty_cache()
    results["dss_band"]["max_abs_err"] = k7["err"]

    # ---- 14. the sharded NE30 f32 face subcycle on the one card ----------
    comm_mod, sharded = mods["comm"], mods["sharded"]
    cfg14 = perf_config(NE, dtype="f32", use_pallas=True)
    m14 = build_model(cfg14, dev)
    E, nq, nk = m14.lon.shape[0], cfg14.qsize, cfg14.nlev
    Q0 = initial_qdp(m14)
    sp = m14.spheremp.double()
    mass0 = torch.einsum("eqkij,eij->q", Q0.double(), sp)

    def subcycles(step, state, gather, n=SHARDED_SUBCYCLES):
        """n subcycles -> (std Qdp after the first and after the last,
        min_dp list, ms per timed subcycle); the first is the warm-up."""
        nstep, mds, ev, first = 0, [], [], None
        t0 = time.perf_counter()
        for i in range(n):
            a_ev = torch.cuda.Event(enable_timing=True)
            b_ev = torch.cuda.Event(enable_timing=True)
            a_ev.record()
            state, _, nstep, md = step(state, nstep)
            b_ev.record()
            mds.append(float(md))
            if i:
                ev.append((a_ev, b_ev))
            else:
                first = gather(state)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / max(n - 1, 1)
        return (first, gather(state), mds,
                [a.elapsed_time(b) for a, b in ev], host)

    # the sharded face path against one device in f64, where the one
    # difference of the two assemblies (the association of the
    # three-partner slots) stays at roundoff: NE8, 8 shards
    m8 = build_model(perf_config(8, dtype="f64", use_pallas=True), dev)
    Q8 = initial_qdp(m8)
    one8 = subcycles(make_subcycle_fn(m8, io_layout="t"),
                     _tp(Q8, Q8.shape[0], m8.cfg.qsize * m8.cfg.nlev),
                     lambda st: core._tp_back(st, Q8.shape), n=1)[1]
    r8 = sharded.make_sharded_subcycle(m8, comm_mod.ThreadComm(8))
    sh8 = subcycles(r8.step, r8.shard_qdp(Q8), r8.gather, n=1)[1]
    rel8 = rel_err(torch, sh8, one8)[1]
    check(rel8 <= TOL["f64"], f"sharded NE8 f64 face: {rel8:.3e} from one "
          "device")
    say(f"phase 14 NE8 f64 sharded face subcycle, 8 shards (overlap "
        f"{r8.overlap_face}), against one device: max rel {rel8:.3e} (tol "
        f"{TOL['f64']:.0e})")
    del m8, Q8, one8, r8, sh8

    step1 = make_subcycle_fn(m14, io_layout="t")
    single1, single, md1, ms1, host1 = subcycles(
        step1, _tp(Q0, E, nq * nk),
        lambda st: core._tp_back(st, Q0.shape))
    del step1
    say(f"phase 14 NE{NE} f32 single-device face subcycle (phase 4's "
        f"configuration), {SHARDED_SUBCYCLES} subcycles: median "
        f"{statistics.median(ms1):.2f} ms per subcycle (host wall "
        f"{host1:.2f} ms); min_dp {md1}")
    for S, overlap in ((1, False), (SHARDED_S, False), (SHARDED_S, True)):
        counters.reset()
        runner = sharded.make_sharded_subcycle(
            m14, comm_mod.ThreadComm(S), overlap=overlap)
        out1, out, mds, ms, host = subcycles(
            runner.step, runner.shard_qdp(Q0), runner.gather)
        counts = counters.snapshot()
        want = sharded_counts(S, SHARDED_SUBCYCLES, runner.overlap_face)
        for k, n in want.items():
            check(counts[k] == n and counts[k + "_plain"] == 0,
                  f"sharded S={S} overlap={overlap}: {k} {counts[k]} "
                  f"(plain {counts[k + '_plain']}), want {n}")
        check(runner.overlap_face == overlap and runner.io_layout == "t",
              f"sharded S={S}: overlap_face {runner.overlap_face}, layout "
              f"{runner.io_layout}")
        check(bool(torch.isfinite(out).all()) and min(mds) > 0,
              f"sharded S={S}: non-finite state or min_dp {mds}")
        mass1 = torch.einsum("eqkij,eij->q", out.double(), sp)
        dmass = ((mass1 - mass0).abs() / mass0.abs()).max().item()
        check(dmass < MASS_TOL, f"sharded S={S}: mass change {dmass:.3e}")
        # K4 and K7 associate the three-partner slots differently, and in
        # f32 that roundoff moves limiter clips, so the two paths part by
        # ~1e-5 of the field; the f64 run above holds the path to 1e-12,
        # and this bound only catches a fault of the assembly or the halo,
        # which is O(1)
        rel1 = rel_err(torch, out1, single1)[1]
        diff = (out - single).abs().max().item()
        rel = diff / single.abs().max().item()
        check(rel1 < 1e-3 and rel < 1e-3, f"sharded S={S}: {rel1:.3e} "
              f"after one subcycle, {rel:.3e} after {SHARDED_SUBCYCLES} "
              "from one device")
        if S == 1:
            first = out
        else:
            check(torch.equal(out, first), f"S={S} overlap={overlap} "
                  "changed the bits of S=1")
        if S == SHARDED_S and not overlap:
            launches["dss_band"] = counts["dss_band"]
        say(f"phase 14 NE{NE} f32 sharded face subcycle, S={S} shards as "
            f"threads on the one card (ThreadComm), overlap {overlap}: "
            + ("" if S == 1 else "bitwise equal to S=1; ")
            + f"max rel {rel1:.3e} from the single-device subcycle after "
            f"one subcycle, max abs {diff:.3e} (rel {rel:.3e}) after "
            f"{SHARDED_SUBCYCLES}; launches per "
            "shard " + ", ".join(f"{k} {counts[k] / S:g}" for k in want)
            + f"; min_dp {mds}; max relative tracer-mass change "
            f"{dmass:.3e}; median {statistics.median(ms):.2f} ms per "
            f"subcycle (min {min(ms):.2f}, max {max(ms):.2f}; host wall "
            f"{host:.2f} ms); {S} threads "
            "share one card, so these are no scaling figures")
        del runner, out, out1
    del m14, single, single1, first
    torch.cuda.empty_cache()

    # ---- 15. the std sharded subcycle, NE8 f64 ---------------------------
    m15 = build_model(mods["dcmip11_ne8"](), dev)
    Q15 = initial_qdp(m15)
    ref = make_subcycle_fn(m15)(Q15, 0)
    counters.reset()
    runner = sharded.make_sharded_subcycle(m15, comm_mod.ThreadComm(8))
    states, _, n15, md15 = runner.step(runner.shard_qdp(Q15), 0)
    got = runner.gather(states)
    torch.cuda.synchronize()
    c15 = counters.snapshot()
    scale = ref[0].abs().max().item()
    d15 = (got - ref[0]).abs().max().item()
    check(runner.io_layout == "std" and n15 == m15.cfg.rsplit,
          f"std sharded: layout {runner.io_layout}, nstep {n15}")
    check(d15 < 1e-13 * scale, f"std sharded NE8 f64: {d15:.3e} from "
          f"single (scale {scale:.3e})")
    check(abs(float(md15) - float(ref[3])) < 1e-9, "std sharded min_dp")
    check(c15["limiter_optim"] == 8 * K10_PER_STEP * n15
          and c15["dss_band"] == 0, f"std sharded launches {c15}")
    say(f"phase 15 NE8 f64 std-layout sharded subcycle, 8 shards as "
        f"threads, gather DSS: max abs {d15:.3e} from the single-device "
        f"subcycle (bound 1e-13 x {scale:.3e}); min_dp {float(md15):.6g}; "
        "launches " + ", ".join(f"{k} {v}" for k, v in c15.items() if v))
    del m15, runner, states, got, ref

    # ---- 16. the f32 verification of the production path -----------------
    with contextlib.redirect_stdout(io.StringIO()):
        v = mods["verify"].main(["--test", "dcmip1-1", "--ne", "8",
                                 "--dtype", "f32", "--pallas"])
    nrm, pub, la = v["norms"], v["published"], v["launches"]
    rel = [abs(a - b) / abs(b)
           for a, b in zip((nrm.l1, nrm.l2, nrm.linf), pub[:3])]
    check(all(la.get(k, 0) > 0 for k in VERIFY_KERNELS)
          and not la.get("laplace_wk_t") and not la.get("limiter_optim")
          and not any(k.endswith("_plain") for k in la),
          f"verify NE8 f32: launches {la}, want {VERIFY_KERNELS} and no "
          "K2, K10 or plain version")
    check(v["config"].use_pallas and v["config"].dss_mode == "face"
          and all(md > 0 for md in v["min_dp"]),
          f"verify NE8 f32: {v['config']}, min_dp {min(v['min_dp'])}")
    check(max(rel) <= VERIFY_TOL, f"verify NE8 f32: L1/L2/Linf "
          f"{nrm.l1:.6f}/{nrm.l2:.6f}/{nrm.linf:.6f}, relative "
          f"{max(rel):.3e} from the published {pub[:3]} > {VERIFY_TOL}")
    say(f"phase 16 verify NE8 DCMIP 1-1 f32 --pallas, {v['steps']} steps "
        f"({v['subcycles']} subcycles): {nrm}; published L1/L2/Linf "
        f"{pub[0]:.6f}/{pub[1]:.6f}/{pub[2]:.6f} q_max {pub[3]:.6f}, "
        "relative " + "/".join(f"{r:.2e}" for r in rel)
        + f" (tol {VERIFY_TOL:.0e}); max relative mass drift "
        f"{v['drift']:.3e}; launches " + ", ".join(
            f"{k} {n}" for k, n in la.items())
        + f"; run wall {v['wall']:.2f} s on {card}")
    with contextlib.redirect_stdout(io.StringIO()):
        a = mods["audit_drift"].main(["--ne", "8", "--days", "12"])
    check(a["ok"], f"audit_drift NE8: drift {a['max']:.3e} >= "
          f"{mods['audit_drift'].GATE:.0e}")
    say(f"phase 16 audit_drift NE8 perf config f32 (35 tracers, limiter cap "
        f"{a['cap']}), {a['subcycles']} subcycles = 12 days: per-tracer "
        f"relative mass drift max {a['max']:.3e}, median "
        f"{a['median']:.3e} (gate {mods['audit_drift'].GATE:.0e}); min_dp "
        f"{a['min_dp']:.6g}; wall {a['wall']:.2f} s")

    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=launches[k], **results[k])
               for k, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
