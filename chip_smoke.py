#!/usr/bin/env python3
"""Smoke run of transport_se_tpu_torch on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py
(python3 chip_smoke.py --phase 21: phases 1, 2 and 21 alone)

Phases (each prints one line or two; any failure exits non-zero before
the result lines):
  1. the card: name and power limit; TF32 off for matmuls and cuDNN
  2. build the CUDA kernels from csrc/ (one nvcc call, sm_90a)
  3. each T-path kernel against its plain PyTorch version at NE30 shapes
     (E=5400, 35 tracers x 72 levels), f32 and f64, with times: K1-K3 and
     the face trio K4, K5, K6; K4 bitwise in its seven launch cases, each
     with its time against its bound, its registers and spills and its
     launch shape, then its launch-weighted fraction of its bound over the
     12 launches of a face subcycle;
     the wind kernel bitwise, with its registers and launch shape, timed
     at the NE30 and NE120 shapes beside its bound, its plain chain and
     one torch.einsum per field; the remap's health kernel bitwise on
     K3's widths, timed at the NE30 and NE120 shapes beside its bound, its
     plain version and the chain it replaced, with its registers and
     launch shape;
     K1 bitwise at each stage kind, and its times at limiter iteration
     caps 1, 2, 4 and 15; K3 bitwise at alg 0 and 2 at 35 tracers, at
     the f64 cell's tracer-group widths, 9 and 8, and at the std cell's 4
     (the state's first lanes), each width timed beside its bound with
     its tile form, with its
     registers, shared memory, resident blocks and walking warps per SM;
     K5 bitwise on the sphere
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
     histogram of iteration passes per row; K10's counting form on them
     bitwise with the plain version's counts: passes a row, capped share
  9. one NE8 f64 std-layout subcycle in gather and in segsum mode, kernels
     against plain versions, K10, K3 and the health kernel counted under
     their own names and under the plain ones; segsum twice, bitwise
 10. the CLI (python -m transport_se_tpu_torch.main, one subprocess per
     run) on the published f64 verification runs NE8 DCMIP 1-2 (1 day),
     NE30 DCMIP 1-2 (1 day) and NE8 DCMIP 1-1 (12 days): error norms
     against the published digits, mass drift, K10 launches, K3 and
     health kernel launches (one a subcycle)
 11. exact restart through the CLI at NE8: 3 steps + restart + 3 steps
     gives the 6-step run's last history record bitwise
 12. three steady-state NE30 f64 std-layout subcycles (the NE30 CLI run's
     configuration) timed with CUDA events; K3 and the health kernel on
     the first subcycle's remap inputs bitwise against their plain
     versions, each timed beside its bound
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
     one device; K10, K3 and the health kernel counted a shard
 16. the f32 verification of the production path: python -m
     transport_se_tpu_torch.verify (in-process) on NE8 DCMIP 1-1, 12 days,
     f32 --pallas (the T path through K1 and K3-K6), its L1, L2 and Linf
     within 1e-2 relative of the published f64 norms; then the
     conservation gate (python -m transport_se_tpu_torch.audit_drift) on
     the NE8 perf configuration over 12 days, drift below 2e-4
 17. the NE42 proxy (perf_config(42, f32), 10584 elements, NE120's tstep
     and nu): one face subcycle through the kernels against the plain
     versions, its launch counts, min_dp and tracer mass; then the port's
     benchmark (python -m transport_se_tpu_torch.bench, a subprocess, with
     its defaults: the NE30 row and the NE42 proxy row), its JSON line and
     each row's windows and launches
 18. the sharded NE30 f32 gather T subcycle at S = 8 with overlap on (the
     boundary-first split: K1 on the boundary group, then on the interior)
     and off, against each other and against one device: bits or max
     difference, each run's first subcycle against one device's through
     the plain versions (TOL f32), launches per shard, min_dp, tracer
     mass, ms per subcycle
 19. the dry run (transport_se_tpu_torch.dryrun dryrun_multichip(8) on the
     card: the face+overlap f64 case and the gather split f32 case), each
     case's state against one device's subcycle of its configuration
     through the plain versions (TOL of its dtype), and one step of its
     one-device entry(); the run's wall so far
 20. NE120 (perf_config(120, f32), 86,400 elements, 72 levels), each host
     and device build timed: (a) 2 tracers, two face subcycles through
     the kernels, the first bit for bit against the plain versions; (b)
     the full 35 tracers (12.98 GiB a state, offsets past 2^31), two face
     subcycles with the state handed over: launch counts, min_dp,
     finiteness, per-tracer mass drift, ms per subcycle (CUDA events),
     peak device memory against four states + 10 GiB, and tracers 0-1
     after each subcycle bit for bit against (a)'s; then a third subcycle
     under torch.profiler (device ms by kernel, share of busy, idle); the
     phase's wall
 21. NE120 with 35 tracers in f64 at the reference's 15 limiter passes
     (the benchmark's ne120_perf_f64.q35; 25.96 GiB a state, so the
     subcycle runs in tracer groups, model/core.py plan_groups): (a) at
     NE30 f64, a subcycle in forced groups bit for bit against the
     one-group plan of the same subcycle function, which copies no
     lanes; (b) the lane kernels on the NE120 state (3.48e9
     values) bit for bit against their plain versions, and a subcycle's
     gathers and scatters timed against their bound; (c) one subcycle
     with the plan, the state handed over: the groups, launch counts,
     min_dp, finiteness, per-tracer mass change, ms (CUDA events), peak
     device memory against NE120_F64_MAX_GIB, and tracers 0-1 bit for
     bit against a 2-tracer one-group run; then one more under
     torch.profiler: device ms by kernel, the lane kernels' ms against
     their bound, idle
Then one JSON line of per-kernel results (the launches of K2 from the
gather run of phase 4, of K10 from the NE30 CLI run of phase 10, of K7
from the S = 8 run of phase 14, all others from the face run of phase 4;
each kernel's bound from its call's bytes and operations; K4's times and
bound are per launch, weighted by its launches of a face subcycle), the
card line,
and as the last line {"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
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
    "wind_eval_t": ("transport_se_tpu_torch/csrc/wind.cu",
                    "none (transport_se_tpu/model/wind_basis.py "
                    "WindBasis.eval's einsum, left to XLA)"),
    "remap_health_t": ("transport_se_tpu_torch/csrc/health.cu",
                       "none (transport_se_tpu/ops/ppm.py ppm_fast_margin "
                       "beside dp_star.min(), left to XLA)"),
}
KEY = {"fused_advect_limit": "K1", "laplace_wk_t": "K2",
       "remap_q_ppm_t": "K3", "dss_face": "K4", "minmax_prep": "K5",
       "neighbor_minmax": "K6", "limiter_optim": "K10",
       "dss_band": "K7", "wind_eval_t": "wind", "remap_health_t": "health"}
# the single-device T path's kernels (phase 3); K10 has phase 8, K7 13
T_KERNELS = tuple(k for k in KERNELS if k not in ("limiter_optim",
                                                   "dss_band"))
# 6 steps = 2 subcycles.  The face path runs 4 face DSS per step (stage 0
# and 1 with the next stage's bounds, stage 1 also with the first
# Laplacian, stage 2's hyperviscosity input, stage 2's output with the
# time average) plus one per DCMIP 1-1 wind term (6) when the subcycle
# function builds its wind basis; one bound prep per subcycle; neighbor
# min/max on stages 0 and 2; no weak-Laplacian launch.
# The T path runs no K10 (K1 limits inside the fused stage), the wind
# kernel once a step and the remap's health kernel once a subcycle.
FACE_COUNTS = {"fused_advect_limit": 18, "laplace_wk_t": 0,
               "remap_q_ppm_t": 2, "dss_face": 4 * 6 + 6, "minmax_prep": 2,
               "neighbor_minmax": 12, "limiter_optim": 0, "dss_band": 0,
               "wind_eval_t": 6, "remap_health_t": 2}
GATHER_COUNTS = {"fused_advect_limit": 18, "laplace_wk_t": 6,
                 "remap_q_ppm_t": 2, "dss_face": 0, "minmax_prep": 0,
                 "neighbor_minmax": 0, "limiter_optim": 0, "dss_band": 0,
                 "wind_eval_t": 6, "remap_health_t": 2}
# The sharded face path, per shard and subcycle (rsplit = 3 steps): K7
# four times a step and six times when the subcycle function builds its
# wind basis (the DCMIP 1-1 terms); K1 once a stage, twice with the
# face+overlap composition (the boundary group's duplicate); K5 at the
# start and after the averaged third stage of the first two steps; K3
# once; never K4, K6 or K2.
SHARDED_SUBCYCLES = 4            # one warm-up, three timed
K7_VARIANTS = ("raw", "scale", "scale+minmax", "scale+minmax+lap")
SHARDED_S = 8
# K4's launches a face subcycle by launch case (ops/dss_face.py
# FACE_CASES): each of the 3 tracer steps runs stage 0 with min/max, stage
# 1 with min/max and the first Laplacian, stage 2's hyperviscosity input
# scaled, and stage 2's output with the time average, with min/max on the
# first two steps
K4_SUBCYCLE = {"scale": 3, "minmax": 3, "minmax+lap": 3, "avg+minmax": 2,
               "avg": 1}
# one face subcycle (phase 17): the 4 face DSS a step and the 6 of the wind
# basis built with the subcycle function, K1 a stage, K5 once, K6 on
# stages 0 and 2, K3 and the health kernel once, the wind kernel a step
FACE_SUBCYCLE_COUNTS = {"fused_advect_limit": 9, "laplace_wk_t": 0,
                        "remap_q_ppm_t": 1, "dss_face": 4 * 3 + 6,
                        "minmax_prep": 1, "neighbor_minmax": 6,
                        "limiter_optim": 0, "dss_band": 0, "wind_eval_t": 3,
                        "remap_health_t": 1}
PROXY_NE = 42
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "ne42_proxy_value",
              "ne42_proxy_vs_baseline"}
BENCH_TIMEOUT = 600      # s, the benchmark subprocess of phase 17
GATHER_SUBCYCLES = 3     # phase 18: one warm-up, two timed
# phase 20: NE120, the reference's headline grid (test/run_ne120_perf.sh,
# perf_config(120)): 86,400 elements, 72 levels.  (a) 2 tracers, held bit
# for bit against the plain versions; (b) the full 35 tracers, E*16*L =
# 3.48e9 values (past 2^31), where the plain versions do not fit the card:
# its tracers 0-1 are held bit for bit against (a)'s kernel run (every
# kernel's result in a lane is independent of the tracer count,
# tests/test_torch_lanes.py).  A subcycle holds at most four states
# (model/core.py, tests/test_torch_memory.py); the peak allowed over (b),
# above what phase 20 held before it, is four states plus NE120_SLACK of
# winds, bounds and the tracers (b) keeps for the comparison.
# phase 21: NE120 x 35 tracers in f64, the group plan; the cell's bound on
# its peak memory; NE30's forced groups
NE120_F64_MAX_GIB = 75
NE30_F64_GROUPS = [9, 9, 9, 8]
NE120 = 120
NE120_FEW = 2
NE120_SUBCYCLES = 2
NE120_MAX_STATES = 4
NE120_SLACK = 10 * 2**30


def gather_shard_counts(S, nsub, overlap):
    """The sharded gather T path, per shard and subcycle: K1 once a stage,
    twice with the boundary-first split; K2 for stage 2's first Laplacian
    of each step; K3 and the health kernel once; the wind kernel a step;
    the DSS, bound prep and neighbour bounds are plain gathers."""
    return {"fused_advect_limit": S * 9 * nsub * (2 if overlap else 1),
            "laplace_wk_t": S * 3 * nsub, "remap_q_ppm_t": S * nsub,
            "dss_face": 0, "minmax_prep": 0, "neighbor_minmax": 0,
            "limiter_optim": 0, "dss_band": 0, "wind_eval_t": S * 3 * nsub,
            "remap_health_t": S * nsub}


def sharded_counts(S, nsub, overlap):
    return {"dss_band": S * (6 + 4 * 3 * nsub),
            "fused_advect_limit": S * 9 * nsub * (2 if overlap else 1),
            "minmax_prep": S * 3 * nsub, "remap_q_ppm_t": S * nsub,
            "dss_face": 0, "neighbor_minmax": 0, "laplace_wk_t": 0,
            "limiter_optim": 0, "wind_eval_t": S * 3 * nsub,
            "remap_health_t": S * nsub}
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
                  "minmax_prep", "neighbor_minmax", "wind_eval_t",
                  "remap_health_t")
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
              "limiter_kernel": ("count",),
              "ppm_kernel": ("count", "whole"),
              "dss_face_kernel": ("scale", "avg", "minmax", "lap"),
              "dss_band_kernel": ("scale", "minmax", "lap")}

# A kernel's bound: the least time the card could take for the call, the
# larger of its bytes (each input read once, each output written once) over
# the memory rate and its operations over the peak rate outside the tensor
# cores (NVIDIA's H100 SXM data sheet; the rates assume the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}
# floating-point operations, counted from the plain versions: per point of
# an (element, lane) column for the stage parts and the DSS epilogues, per
# (point, tracer, level) cell for the PPM remap and per (point, level)
# width for the remap's health check (two sums, two differences, three
# minima), and one limiter pass per column or row (each makes at least
# one; how many more is the data's)
OPS = {"advect": 16 * 30, "limiter_iter": 16 * 8, "lap": 16 * 50,
       "ppm": 100, "dss_add": 3, "scale": 1, "avg": 3, "minmax": 2,
       "health": 7}


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
                # K4's and K7's last template argument: the lanes a
                # thread owns
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


def device_ms(pr, cuda, what):
    """(device ms by kernel name, busy ms, span ms) of a torch.profiler
    run pr: its events on device type cuda, busy time merged."""
    spans = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                   for ev in pr.events() if ev.device_type == cuda)
    check(bool(spans), f"{what}: the profiler saw no device activity")
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
    return by_name, busy / 1e3, (end - spans[0][0]) / 1e3


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
                                        dryrun, k10_variants, verify)
    from transport_se_tpu_torch.config import (dcmip11_ne8, dcmip11_ne30,
                                               dcmip12_ne30, perf_config)
    from transport_se_tpu_torch.grid.cubesphere import build_grid
    from transport_se_tpu_torch.model import core, driver, wind_basis
    from transport_se_tpu_torch.norms import history_norms
    from transport_se_tpu_torch.ops import (band, dss_face, euler, lanes,
                                            limiter, ppm, remap, wind)
    from transport_se_tpu_torch.parallel import (comm, face_sharded, halo,
                                                 sharded)
    return dict(_build=_build, audit_drift=audit_drift, counters=counters,
                dryrun=dryrun, k10_variants=k10_variants, verify=verify,
                dcmip11_ne8=dcmip11_ne8, build_grid=build_grid,
                dcmip11_ne30=dcmip11_ne30, dcmip12_ne30=dcmip12_ne30,
                perf_config=perf_config, core=core, driver=driver,
                wind_basis=wind_basis, history_norms=history_norms,
                band=band, dss_face=dss_face, euler=euler, lanes=lanes,
                limiter=limiter, ppm=ppm, remap=remap, wind=wind,
                comm=comm, face_sharded=face_sharded, halo=halo,
                sharded=sharded)


def phase_ne120(torch, mods, dev, t_start, ne=NE120):
    """Phase 20: the NE ne face path at full size on one card (module
    docstring).  Fails through check() on any mismatch."""
    core, counters = mods["core"], mods["counters"]
    build_model, make_subcycle_fn = core.build_model, core.make_subcycle_fn
    t20 = time.perf_counter()
    torch.cuda.empty_cache()
    builds = {}

    def built(name, t0):
        torch.cuda.synchronize()
        builds[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    g120 = mods["build_grid"](ne, order="raster")
    built("grid (host)", t0)
    t0 = time.perf_counter()
    mods["dss_face"].build_face_tables(g120.part_idx, g120.part_mask, ne)
    built("face tables (host)", t0)
    del g120
    cfg_b = mods["perf_config"](ne, dtype="f32", use_pallas=True)
    cfg_a = dataclasses.replace(cfg_b, qsize=NE120_FEW)
    t0 = time.perf_counter()
    m_a = build_model(cfg_a, dev)
    built("model (grid, face tables, copies to the card)", t0)
    E, nk = m_a.lon.shape[0], cfg_b.nlev
    sp16 = m_a.spheremp.reshape(E, 16).double()

    def masses(Qt, nq):
        """Per-tracer mass sum(spheremp * Qdp) in f64, a tracer at a time
        (a f64 copy of the whole 35-tracer state would be 26 GiB)."""
        v = Qt.view(E, 16, nq, nk)
        return torch.stack([(v[:, :, i].double() * sp16[:, :, None]).sum()
                            for i in range(nq)])

    def run_face(m, nq, box):
        """NE120_SUBCYCLES face subcycles of the handed-over state box ->
        (tracers 0..NE120_FEW-1 after each, ms of each, min_dp of each,
        launches, state's finiteness)."""
        counters.reset()
        t0 = time.perf_counter()
        step = make_subcycle_fn(m, io_layout="t")
        built(f"{nq}-tracer subcycle function (wind basis, 6 K4)", t0)
        outs, ms, mds, nstep = [], [], [], 0
        for _ in range(NE120_SUBCYCLES):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            box[0], _, nstep, md = step(box, nstep)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
            mds.append(float(md))
            outs.append(box[0].view(E, 16, nq, nk)[:, :, :NE120_FEW]
                        .clone())
        counts = counters.snapshot()
        return (outs, ms, mds, counts, bool(torch.isfinite(box[0]).all()),
                step, nstep)

    # (a) 2 tracers: the kernels against the plain versions
    t0 = time.perf_counter()
    Q_a = core.initial_qdp_t(m_a)
    built("2-tracer initial state", t0)
    box = [Q_a.clone()]
    outs_a, ms_a, mds_a, c_a, fin_a, _, _ = run_face(m_a, NE120_FEW, box)
    del box
    plain_a = make_subcycle_fn(m_a, io_layout="t", plain=True)(Q_a, 0)[0]
    torch.cuda.synchronize()
    same_a = torch.equal(bits(torch, outs_a[0].reshape(plain_a.shape)),
                         bits(torch, plain_a))
    d_a, r_a = rel_err(torch, outs_a[0].reshape(plain_a.shape), plain_a)
    del plain_a, Q_a
    torch.cuda.empty_cache()
    check(same_a, f"NE120 {NE120_FEW}-tracer subcycle: kernels differ from "
          f"the plain versions, max abs {d_a:.3e} (rel {r_a:.3e})")
    for k, n in FACE_COUNTS.items():
        check(c_a[k] == n and c_a[k + "_plain"] == 0,
              f"NE120 {NE120_FEW} tracers: {k} {c_a[k]} (plain "
              f"{c_a[k + '_plain']}), want {n}")
    check(fin_a and min(mds_a) > 0,
          f"NE120 {NE120_FEW} tracers: finite {fin_a}, min_dp {mds_a}")
    say(f"phase 20 NE{ne} f32 {NE120_FEW} tracers (E={E}, tstep "
        f"{cfg_a.tstep:g}, nu_q {cfg_a.nu_q:g}, limiter cap "
        f"{cfg_a.limiter_iter_cap}): first face subcycle bit for bit equal "
        f"to the plain versions; launches in {NE120_SUBCYCLES} subcycles "
        + ", ".join(f"{k} {c_a[k]}" for k in FACE_COUNTS if c_a[k])
        + f"; min_dp {mds_a}; ms a subcycle "
        + ", ".join(f"{t:.3f}" for t in ms_a))

    # (b) the full 35 tracers, the state handed over
    m_b = dataclasses.replace(m_a, cfg=cfg_b)
    nq_b = cfg_b.qsize
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    box = [core.initial_qdp_t(m_b)]
    built(f"{nq_b}-tracer initial state", t0)
    state_b = box[0].numel() * box[0].element_size()
    if ne == NE120:
        check(box[0].numel() > 2**31,
              f"NE120 state of {box[0].numel()} values")
    mass0 = masses(box[0], nq_b)
    outs_b, ms_b, mds_b, c_b, fin_b, step_b, nstep = run_face(m_b, nq_b,
                                                              box)
    peak = torch.cuda.max_memory_allocated()
    mass1 = masses(box[0], nq_b)
    dmass = ((mass1 - mass0).abs() / mass0.abs())
    # one more subcycle under torch.profiler: where the time goes at NE120
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as pr:
        box[0] = step_b(box, nstep)[0]
        torch.cuda.synchronize()
    by_name, busy, span = device_ms(pr, DeviceType.CUDA, "phase 20")
    del box, step_b, pr
    torch.cuda.empty_cache()
    for k, n in FACE_COUNTS.items():
        check(c_b[k] == n and c_b[k + "_plain"] == 0,
              f"NE120 {nq_b} tracers: {k} {c_b[k]} (plain "
              f"{c_b[k + '_plain']}), want {n}")
    check(fin_b and min(mds_b) > 0,
          f"NE120 {nq_b} tracers: finite {fin_b}, min_dp {mds_b}")
    check(dmass.max().item() < MASS_TOL,
          f"NE120 {nq_b} tracers: mass change {dmass.max().item():.3e}")
    # the run's own footprint: the peak above what was held before it
    allowed = NE120_MAX_STATES * state_b + NE120_SLACK
    check(peak - at_start <= allowed, f"NE120 {nq_b} tracers: peak {peak} "
          f"B, {peak - at_start} B above the {at_start} B held before, > "
          f"{NE120_MAX_STATES} states + {NE120_SLACK} B = {allowed} B")
    for i, (x, y) in enumerate(zip(outs_b, outs_a)):
        check(torch.equal(bits(torch, x), bits(torch, y)),
              f"NE120 subcycle {i + 1}: tracers 0-{NE120_FEW - 1} of the "
              f"{nq_b}-tracer run differ from the {NE120_FEW}-tracer run, "
              f"max abs {rel_err(torch, x, y)[0]:.3e}")
    del outs_a, outs_b, m_a, m_b, sp16
    torch.cuda.empty_cache()
    say(f"phase 20 NE{ne} f32 {nq_b} tracers (E*16*L = "
        f"{E * 16 * nq_b * nk}, state {state_b / 2**30:.2f} GiB): tracers "
        f"0-{NE120_FEW - 1} bit for bit equal to the {NE120_FEW}-tracer run "
        f"after each of {NE120_SUBCYCLES} subcycles; launches "
        + ", ".join(f"{k} {c_b[k]}" for k in FACE_COUNTS if c_b[k])
        + f"; min_dp {mds_b}; finite {fin_b}; per-tracer relative mass "
        f"change max {dmass.max().item():.3e}, median "
        f"{dmass.median().item():.3e}; ms a subcycle "
        + ", ".join(f"{t:.3f}" for t in ms_b)
        + f"; peak allocated {peak / 2**30:.2f} GiB, "
        f"{(peak - at_start) / 2**30:.2f} GiB = "
        f"{(peak - at_start) / state_b:.3f} states above the "
        f"{at_start / 2**30:.2f} GiB held before (allowed "
        f"{allowed / 2**30:.2f})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    rest = sum(t for _, t in top[N_NAMES:])
    say(f"phase 20 NE{ne} f32 {nq_b}-tracer face subcycle under "
        f"torch.profiler: device span {span:.2f} ms, busy {busy:.2f} ms, "
        f"idle {1 - busy / span:.1%}; device ms by kernel (share of busy): "
        + ", ".join(f"{k} {t:.2f} ({t / busy:.1%})" for k, t in top[:N_NAMES])
        + f", {max(0, len(top) - N_NAMES)} others {rest:.2f}")
    say(f"phase 20 NE{ne} builds (s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in builds.items())
        + f"; phase wall {time.perf_counter() - t20:.1f} s; chip_smoke wall "
        f"{time.perf_counter() - t_start:.1f} s")


def phase_ne120_f64(torch, mods, dev, t_start, ne=NE120):
    """Phase 21: NE ne with 35 tracers in f64 through the group plan
    (module docstring).  Fails through check() on any mismatch."""
    core, counters, lanes = mods["core"], mods["counters"], mods["lanes"]
    perf_config = mods["perf_config"]
    t21 = time.perf_counter()
    torch.cuda.empty_cache()

    # (a) NE30 f64: forced groups against the one-group plan of the same
    # subcycle function
    cfg30 = perf_config(30, dtype="f64", use_pallas=True,
                        limiter_iter_cap=15)
    m30 = core.build_model(cfg30, dev)
    Q0 = core.initial_qdp_t(m30)
    one = core.make_subcycle_fn(m30, io_layout="t")
    check(one.groups == [cfg30.qsize],
          f"NE30 f64 35 tracers: plan {one.groups}, want one group")
    counters.reset()
    want = one([Q0.clone()], 0)[0]
    c1 = counters.snapshot()
    check(c1["lane_gather_t"] == c1["lane_scatter_t"] == 0,
          f"NE30 f64 one group: launches {c1}")
    counters.reset()
    got = core.make_subcycle_fn(m30, io_layout="t", groups=NE30_F64_GROUPS)(
        [Q0.clone()], 0)[0]
    c30 = counters.snapshot()
    torch.cuda.synchronize()
    check(torch.equal(bits(torch, got), bits(torch, want)),
          f"NE30 f64: groups {NE30_F64_GROUPS} differ from the one-group "
          f"plan, max abs {rel_err(torch, got, want)[0]:.3e}")
    check(c30["lane_gather_t"] == c30["lane_scatter_t"]
          == len(NE30_F64_GROUPS) and c30["lane_gather_t_plain"] == 0,
          f"NE30 f64 groups: launches {c30}")
    del m30, Q0, one, want, got
    torch.cuda.empty_cache()
    say(f"phase 21 NE30 f64 35 tracers: a subcycle in groups "
        f"{NE30_F64_GROUPS} bit for bit equal to the one-group plan (no "
        f"lane copies); lane gathers {c30['lane_gather_t']}, scatters "
        f"{c30['lane_scatter_t']}")

    # (b) NE120: a 2-tracer one-group run, for tracers 0-1 of the plan's
    cfg = perf_config(ne, dtype="f64", use_pallas=True, limiter_iter_cap=15)
    m2 = core.build_model(dataclasses.replace(cfg, qsize=NE120_FEW), dev)
    E, nk, nq = m2.lon.shape[0], cfg.nlev, cfg.qsize
    few = core.make_subcycle_fn(m2, io_layout="t")([core.initial_qdp_t(m2)],
                                                   0)[0]
    m = dataclasses.replace(m2, cfg=cfg)
    del m2
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    X = core.initial_qdp_t(m)
    state = X.numel() * X.element_size()
    check(X.numel() > 2**31, f"NE120 state of {X.numel()} values")
    t0 = time.perf_counter()
    step = core.make_subcycle_fn(m, io_layout="t")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    groups = step.groups
    check(len(groups) > 1 and sum(groups) == nq,
          f"NE{ne} f64 35 tracers: plan {groups}, want groups")
    lo = (nq - groups[-1]) * nk
    width = groups[-1] * nk
    g_k = lanes.lane_gather(X, lo, width)
    g_p = lanes.lane_gather_plain(X, lo, width)
    torch.cuda.synchronize()
    check(torch.equal(bits(torch, g_k), bits(torch, g_p)),
          "lane_gather differs from its plain version at the last group")
    del g_p
    Y = torch.zeros_like(X)
    lanes.lane_scatter(g_k, Y, lo)
    torch.cuda.synchronize()
    check(torch.equal(bits(torch, Y[:, :, lo:]), bits(torch, g_k))
          and not bool(Y[:, :, :lo].any()),
          "lane_scatter: the last group's lanes are not as written")
    del g_k

    def copies():
        """A subcycle's lane copies: each group gathered and scattered."""
        a = 0
        for g in groups:
            lanes.lane_scatter(lanes.lane_gather(X, a * nk, g * nk), Y,
                               a * nk)
            a += g
    lane_ms = timed(torch, copies)
    lane_bound = 4 * state / HBM_BYTES_PER_S * 1e3
    check(torch.equal(bits(torch, Y), bits(torch, X)),
          "a subcycle's lane copies do not give the state back")
    del Y
    torch.cuda.empty_cache()
    say(f"phase 21 NE{ne} f64 lane kernels on the 35-tracer state "
        f"({X.numel()} values, {state / 2**30:.2f} GiB): gather and "
        f"scatter bit for bit equal to their plain versions; a subcycle's "
        f"copies in groups {groups}: {lane_ms:.3f} ms against their bound "
        f"{lane_bound:.3f} ms ({lane_bound / lane_ms:.1%})")

    # (c) one subcycle with the plan, the state handed over
    sp16 = m.spheremp.reshape(E, 16)

    def masses(Qt):
        v = Qt.view(E, 16, nq, nk)
        return torch.stack([(v[:, :, i] * sp16[:, :, None]).sum()
                            for i in range(nq)])
    mass0 = masses(X)
    box = [X]
    del X
    counters.reset()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    box[0], _, nstep, md = step(box, 0)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b)
    c = counters.snapshot()
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(box[0]).all())
    dmass = ((masses(box[0]) - mass0).abs() / mass0.abs()).max().item()
    same = torch.equal(
        bits(torch, box[0].view(E, 16, nq, nk)[:, :, :NE120_FEW]),
        bits(torch, few.view(E, 16, NE120_FEW, nk)))
    del few
    check(c["lane_gather_t"] == c["lane_scatter_t"] == len(groups)
          and c["fused_advect_limit"] == 9 * len(groups)
          and c["remap_q_ppm_t"] == len(groups) and c["wind_eval_t"] == 3
          and c["remap_health_t"] == 1,
          f"NE{ne} f64 groups {groups}: launches {c}")
    check(finite and float(md) > 0, f"NE{ne} f64: finite {finite}, min_dp "
          f"{float(md)}")
    check(dmass < MASS_TOL, f"NE{ne} f64: mass change {dmass:.3e}")
    check(same, f"NE{ne} f64: tracers 0-{NE120_FEW - 1} of the grouped "
          f"35-tracer subcycle differ from the {NE120_FEW}-tracer run")
    check(peak <= NE120_F64_MAX_GIB * 2**30,
          f"NE{ne} f64: peak {peak / 2**30:.2f} GiB > {NE120_F64_MAX_GIB}")
    say(f"phase 21 NE{ne} f64 35 tracers, limiter cap 15, groups {groups} "
        f"(planned in {build_s:.2f} s with the wind basis): one subcycle "
        f"{ms:.3f} ms; launches " + ", ".join(
            f"{k} {v}" for k, v in c.items() if v)
        + f"; min_dp {float(md):.6g}; finite; per-tracer relative mass "
        f"change max {dmass:.3e}; tracers 0-{NE120_FEW - 1} bit for bit "
        f"equal to the {NE120_FEW}-tracer one-group run; peak allocated "
        f"{peak / 2**30:.2f} GiB ({(peak - at_start) / 2**30:.2f} above the "
        f"{at_start / 2**30:.2f} held before; allowed {NE120_F64_MAX_GIB})")

    # one more under torch.profiler
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as pr:
        box[0], _, nstep, _ = step(box, nstep)
        torch.cuda.synchronize()
    by_name, busy, span = device_ms(pr, DeviceType.CUDA, "phase 21")
    # and one more counting K1's limiter work and K3's walks
    # (counters.WORK), from an emptied cache: after the earlier phases'
    # leftovers and two subcycles the cached blocks are too fragmented for
    # its 6.68 GiB Laplacian
    torch.cuda.empty_cache()
    counters.work_reset()
    with counters.counting():
        box[0] = step(box, nstep)[0]
        work = counters.work_snapshot()
    rows = max(work["limiter_rows"], 1)
    del box, step, pr, m
    torch.cuda.empty_cache()
    lane_dev = by_name.get("lane_gather_kernel", 0.0) \
        + by_name.get("lane_scatter_kernel", 0.0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    rest = sum(t for _, t in top[N_NAMES:])
    say(f"phase 21 NE{ne} f64 35-tracer subcycle in groups under "
        f"torch.profiler: device span {span:.2f} ms, busy {busy:.2f} ms, "
        f"idle {1 - busy / span:.2%}; lane kernels {lane_dev:.3f} ms against "
        f"their bound {lane_bound:.3f} "
        f"({lane_bound / max(lane_dev, 1e-9):.1%}); device ms by kernel "
        "(share of busy): "
        + ", ".join(f"{k} {t:.2f} ({t / busy:.1%})" for k, t in top[:N_NAMES])
        + f", {max(0, len(top) - N_NAMES)} others {rest:.2f}; K1's limiter "
        f"in the third subcycle: {work['limiter_passes'] / rows:.4f} passes "
        f"a column, {work['limiter_capped'] / rows:.4%} of "
        f"{work['limiter_rows']} columns stopped at the cap of 15; K3 walked "
        f"{work['remap_rewalked']} of {work['remap_columns']} columns again "
        f"with IEEE divisions; phase "
        f"wall {time.perf_counter() - t21:.1f} s; chip_smoke wall "
        f"{time.perf_counter() - t_start:.1f} s")


def main():
    t_start = time.perf_counter()
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

    if sys.argv[1:] == ["--phase", "21"]:
        phase_ne120_f64(torch, mods, dev, t_start)
        print(card)
        return
    check(not sys.argv[1:], f"unknown arguments {sys.argv[1:]}: the one "
          "option is --phase 21")

    # ---- 3. each kernel against its plain version at NE30 shapes ---------
    results = {k: {} for k in KERNELS}

    def stage_inputs(m):
        cfg = m.cfg
        E, nk, nq = m.lon.shape[0], cfg.nlev, cfg.qsize
        Qt = _tp(initial_qdp(m), E, nq * nk)
        wb = build_wind_basis(m)
        u, v, divdp, divp = wb.eval(
            torch.tensor(cfg.tstep, dtype=m.dtype, device=dev))
        dp0 = m.dp0col[None, None, :].expand(E, 16, nk).contiguous()
        mn, mx = m.tables.neighbor_minmax(*m.tables.minmax_prep(Qt, dp0, nq))
        return Qt, u, v, divdp, divp, mn, mx, wb

    def phase3(dtype):
        cfg = perf_config(NE, dtype=dtype, use_pallas=True)
        m = build_model(cfg, dev)
        tb = m.tables
        E, nk, nq = m.lon.shape[0], cfg.nlev, cfg.qsize
        Qt, u, v, divdp, divp, mn, mx, wb = stage_inputs(m)
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
        # and at the f64 cell's tracer-group widths and the std cell's 4
        # tracers, on the state's first n*nk lanes (each dtype's tile form
        # at that width), each timed under its own key
        for n in (9, 8, 4):
            Qn = Qt[..., :n * nk].contiguous()
            Fn = E * 16 * n * nk
            key = (f"remap_q_ppm_t nq{n} "
                   f"{remap.kernel_config(n, nk, Qt.dtype)['form']}")
            times[key], bounds[key] = ([], []), []
            for alg in (0, 2):
                hold(f"K3 nq{n} alg{alg}",
                     lambda: remap.remap_q_ppm_t(Qn, dps, dpr, alg=alg),
                     lambda: remap.remap_q_ppm_t_plain(Qn, dps, dpr,
                                                       alg=alg),
                     key, (2 * Fn + 2 * lv) * es, Fn * OPS["ppm"])
            del Qn
        k3 = {n: e for n, e in errs.items() if n.startswith("K3")}
        check(all(a == 0.0 for e in k3.values() for a, _ in e),
              f"{dtype} K3 is not bitwise equal to its plain version: {k3}")
        # K3's launch shape: registers and spills (ptxas, whole-column and
        # streamed forms), then at 35, 9, 8 and 4 tracers (the f32 cells,
        # the f64 cell's tracer groups, the std cell) its form, rows a tile,
        # shared memory
        # and resident blocks per SM (the occupancy API) and the walking
        # threads an SM, in warps
        regs = [u for u in ptxas_usage(_build.BUILD_DIR / "build.log")
                if u.startswith(f"ppm_kernel<{dtype}")
                and "count" not in u]
        shapes = []
        for n in (35, 9, 8, 4):
            sh = remap.kernel_config(n, nk, Qt.dtype)
            shapes.append(
                f"nq {n}: {sh['form']}"
                + (f" (chunks of {sh['chunk']})" if sh["form"] == "streamed"
                   else "")
                + f", {sh['rows']} rows, {sh['threads']} threads, "
                f"{sh['smem_bytes']} B shared a block, "
                f"{sh['blocks_per_sm']} blocks/SM, "
                f"{sh['walkers_per_sm'] / 32:.2f} walking warps/SM")
        line.append(f"K3 {'; '.join(regs) or 'ptxas report not found'}; "
                    + "; ".join(shapes))
        # the wind kernel on the model's basis at t = tstep, bit for bit
        # (-0 included), then at NE120's element count (the basis tiled);
        # beside it the plain chain, one torch.einsum per field (timed,
        # used nowhere in the port) and four fill_ of the output bytes (the
        # card's rate of plain stores).  A launch at NE30 takes about as
        # long as the host's call, so each is also timed over a burst of
        # launches back to back.  Bytes: four fields written, the four
        # bases read once
        wm = mods["wind"]
        s_w = wb.time_values(torch.tensor(cfg.tstep, dtype=m.dtype,
                                          device=dev))
        nt = wb.u2d.shape[0]

        def burst(fn):
            def run():
                for _ in range(BURST):
                    fn()
            return timed(torch, run) / BURST
        for ne_w in (NE, NE120):
            bases = [a.repeat(1, (ne_w // NE) ** 2, 1)
                     for a in (wb.u2d, wb.v2d, wb.g2d, wb.gp2d)]
            wargs = (*bases, s_w, wb.fk, wb.prof, wb.dp0)
            got, want = wm.wind_eval_t(*wargs), wm.wind_eval_t_plain(*wargs)
            check(all(torch.equal(bits(torch, a), bits(torch, b))
                      for a, b in zip(got, want)),
                  f"{dtype} wind kernel at NE{ne_w} is not bitwise equal to "
                  "its plain version")
            fks, prs = wb.fk * s_w[:, None], wb.prof * s_w[:, None]
            fkw = fks * wb.dp0

            def ein():
                return [torch.einsum("tep,tk->epk", a, x) for a, x in
                        zip(bases, (fkw, fkw, prs, prs))]
            lib_err = max(rel_err(torch, a, b)[1]
                          for a, b in zip(ein(), got))
            del want
            Ew = bases[0].shape[1]
            nbytes = (4 * Ew * 16 * nk + 4 * nt * Ew * 16
                      + (2 * nt + 1) * nk + nt) * es
            nops = Ew * 16 * nk * (4 * (2 * nt - 1) + 2)
            kern = lambda: wm.wind_eval_t(*wargs)  # noqa: E731
            plain = lambda: wm.wind_eval_t_plain(*wargs)  # noqa: E731
            fill = lambda: [o.fill_(1.0) for o in got]  # noqa: E731
            if ne_w == NE:
                hold(f"wind NE{NE}", kern, plain, "wind_eval_t", nbytes,
                     nops)
                libs["wind_eval_t"] = t_e = timed(torch, ein)
                t_k, t_p = (times["wind_eval_t"][0][-1],
                            times["wind_eval_t"][1][-1])
            else:
                t_k, t_p = timed(torch, kern), timed(torch, plain)
                t_e = timed(torch, ein)
            b = bound(nbytes, nops, dtype)[0]
            t_b, t_f = burst(kern), burst(fill)
            line.append(f"wind NE{ne_w} (E={Ew}, T={nt}, K={nk}) bitwise, "
                        f"{t_k:.4f} ms a launch alone, {t_b:.4f} over "
                        f"{BURST} back to back, against its bound {b:.4f} "
                        f"({b / t_b:.1%}); four fill_ of its outputs "
                        f"{t_f:.4f} ({b / t_f:.1%}); plain chain {t_p:.3f} "
                        f"ms; one torch.einsum a field {t_e:.3f} ms (rel "
                        f"{lib_err:.1e} from the kernel)")
            del bases, wargs, kern, plain, fill, got
            torch.cuda.empty_cache()
        shape = wm.kernel_config(nt, nk, Qt.dtype)
        regs = [u for u in ptxas_usage(_build.BUILD_DIR / "build.log")
                if u.startswith(f"wind_kernel<{dtype}")]
        regs = "; ".join(regs) or "ptxas report not found"
        line.append(f"wind kernel {regs}; {shape['vec']} values a thread a "
                    f"field, {shape['threads']} threads, "
                    f"{shape['smem_bytes']} B shared a block, "
                    f"{shape['blocks_per_sm']} blocks/SM")
        # the health kernel on K3's widths, bit for bit (-0 included), then
        # at NE120's column count (the widths tiled); beside it its plain
        # version and the chain it replaced (the least width beside
        # ppm_fast_margin; timed, no longer on the path).  A launch at NE30
        # is shorter than the host's call, so it is also timed over a burst
        # of launches back to back.  Bytes: both fields read once
        def chain(a, b):
            return torch.minimum(a.min(), mods["ppm"].ppm_fast_margin(a, b))
        for ne_h in (NE, NE120):
            tile = (ne_h // NE) ** 2
            hs, hr = dps.repeat(tile, 1, 1), dpr.repeat(tile, 1, 1)
            got = remap.remap_health_t(hs, hr)
            want = remap.remap_health_t_plain(hs, hr)
            ch = chain(hs, hr)
            check(torch.equal(bits(torch, got), bits(torch, want)),
                  f"{dtype} health kernel at NE{ne_h} is not bitwise equal "
                  f"to its plain version: {got.item()!r} {want.item()!r}")
            nbytes, nops = 2 * hs.numel() * es, hs.numel() * OPS["health"]
            kern = lambda: remap.remap_health_t(hs, hr)  # noqa: E731
            plain = lambda: remap.remap_health_t_plain(hs, hr)  # noqa: E731
            if ne_h == NE:
                hold(f"health NE{NE}", kern, plain, "remap_health_t", nbytes,
                     nops)
                t_k, t_p = (times["remap_health_t"][0][-1],
                            times["remap_health_t"][1][-1])
            else:
                t_k, t_p = timed(torch, kern), timed(torch, plain)
            t_c, t_b = timed(torch, lambda: chain(hs, hr)), burst(kern)
            b = bound(nbytes, nops, dtype)[0]
            line.append(f"health NE{ne_h} ({hs.shape[0] * 16} columns) "
                        f"bitwise, value {got.item():.9g} (chain "
                        f"{ch.item():.9g}), {t_k:.4f} ms a launch alone, "
                        f"{t_b:.4f} over {BURST} back to back, against its "
                        f"bound {b:.4f} ({b / t_b:.1%}); plain {t_p:.3f} "
                        f"ms; the chain it replaced {t_c:.3f} ms")
            del hs, hr, got, want, ch, kern, plain
            torch.cuda.empty_cache()
        shape = remap.health_kernel_config(nk, Qt.dtype)
        regs = [u for u in ptxas_usage(_build.BUILD_DIR / "build.log")
                if u.startswith(f"remap_health_kernel<{dtype}")
                or u.startswith(f"remap_health_reduce_kernel<{dtype}")]
        regs = "; ".join(regs) or "ptxas report not found"
        line.append(f"health kernel {regs}; "
                    f"{shape['threads']} columns a block, "
                    f"{shape['smem_bytes']} B shared a block, "
                    f"{shape['blocks_per_sm']} blocks/SM, {shape['blocks']} "
                    "blocks a launch")
        # K4 in its seven launch cases on a stage output, with the state as
        # the time average's input, bit for bit (-0 included); K5 and K6
        # on stage-1 bounds
        dp1 = (m.dp0col[None, None, :] - dt2 * divp).contiguous()
        fc = mods["dss_face"]
        k4 = {}
        for cname, (flags, scale) in fc.FACE_CASES.items():
            kw = fc.face_case(cname, rsp16, Qt, dp1, m.met, m.deriv)
            got = fc.dss_face(out0, tb.face, **kw)
            want = fc.dss_face_plain(out0, tb.face, **kw)
            torch.cuda.synchronize()
            if isinstance(want, torch.Tensor):
                got, want = (got,), (want,)
            check(all(torch.equal(bits(torch, a), bits(torch, b))
                      for a, b in zip(got, want)),
                  f"{dtype} K4 {cname} is not bitwise equal to its plain "
                  "version")
            del got, want
            hold(f"K4 {cname}", lambda: fc.dss_face(out0, tb.face, **kw),
                 lambda: fc.dss_face_plain(out0, tb.face, **kw), "dss_face",
                 *dss_cost(E, nq * nk, nk, es, avg=bool(flags & 1),
                           minmax=bool(flags & 2), lap=bool(flags & 4),
                           scale=scale, part=8))
            k4[cname] = (times["dss_face"][0][-1], times["dss_face"][1][-1],
                         bounds["dss_face"][-1][0])
            shape = fc.face_kernel_config(nq * nk, nk, Qt.dtype, flags,
                                          scale)
            kname = "dss_face_kernel<" + ",".join(
                [dtype] + [n for n, on in zip(
                    FLAG_NAMES["dss_face_kernel"],
                    (scale, flags & 1, flags & 2, flags & 4)) if on]
                + [f"V{shape['vec']}"]) + ">"
            regs = [u for u in ptxas_usage(_build.BUILD_DIR / "build.log")
                    if u.startswith(kname + " ")]
            t, _, b = k4[cname]
            line.append(f"K4 {cname} bitwise, {t:.4f} ms against its bound "
                        f"{b:.4f} ({b / t:.1%}); "
                        f"{'; '.join(regs) or 'ptxas report not found'}; "
                        f"{shape['vec']} lanes a thread, {shape['threads']} "
                        f"threads, {shape['groups']} lane groups an "
                        f"element, {shape['smem_bytes']} B shared a block, "
                        f"{shape['blocks_per_sm']} blocks/SM")
        k4w = [sum(w * k4[c][i] for c, w in K4_SUBCYCLE.items())
               for i in range(3)]
        nw = sum(K4_SUBCYCLE.values())
        line.append(f"K4 over a face subcycle's {nw} launches ("
                    + ", ".join(f"{w} {c}" for c, w in K4_SUBCYCLE.items())
                    + f"): {k4w[0]:.3f} ms against its bound {k4w[2]:.3f} "
                    f"({k4w[2] / k4w[0]:.1%}), plain {k4w[1]:.3f}")
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
            if dtype == "f32" and k in KERNELS:
                results[k] = dict(
                    max_abs_err=max(a for n, e in errs.items()
                                    if n.split()[0] == KEY[k] for a, _ in e),
                    ms=statistics.mean(tk), plain_ms=statistics.mean(tp),
                    bound_ms=b_ms, bound_by=bounds[k][0][1],
                    library_ms=libs.get(k))
        if dtype == "f32":
            results["dss_face"].update(ms=k4w[0] / nw, plain_ms=k4w[1] / nw,
                                       bound_ms=k4w[2] / nw)
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
        return device_ms(pr, DeviceType.CUDA, "phase 7")

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
    # K10's counting form on the same launches: the bits of the form
    # without counting, and the plain version's counts
    counted = {}
    for plain in (False, True):
        counters.work_reset()
        with counters.counting():
            outs = [limiter.limiter_optim_stage(*a, plain=plain)
                    for a in steady]
            counted[plain] = counters.work_snapshot()
        if not plain:
            check(all(torch.equal(bits(torch, g), bits(torch, w))
                      for a, o in zip(steady, outs)
                      for g, w in zip(o, limiter.limiter_optim_stage(*a))),
                  "K10's counting form: not bitwise equal to the form "
                  "without counting")
        del outs
    counters.work_reset()
    work, nrows = counted[False], sum(a[3].numel() for a in steady)
    check(work == counted[True] and work["limiter_rows"] == nrows
          and nrows <= work["limiter_passes"] <= 15 * nrows,
          f"K10's counts {work}, plain {counted[True]}, rows {nrows}")
    say(f"phase 8 K10 on the steady-state std NE30 f64 DCMIP 1-2 input (the "
        f"{len(steady)} launches of the third subcycle), stage and [N, 16] "
        f"operands bitwise equal to the plain version: {ms_s:.3f} ms for "
        f"the {len(steady)}, {ms_s / len(steady):.3f} ms a launch; "
        + k10v.describe(steady)
        + f"; counting form bitwise equal, the plain version's counts: "
        f"{work['limiter_passes'] / nrows:.4f} passes a row, "
        f"{work['limiter_capped'] / nrows:.4%} capped")
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
        counters.reset()
        o_p = make_subcycle_fn(m8, plain=True)(Q8, 0)[0]
        pc = {k: v for k, v in counters.snapshot().items() if v}
        a8, r8 = rel_err(torch, o_k, o_p)
        # K10 on each stage, the remap's K3 and health kernel once a
        # subcycle; the plain run the same counts under the plain names
        want8 = {"limiter_optim": K10_PER_STEP * n8, "remap_q_ppm_t": 1,
                 "remap_health_t": 1}
        check(all(kc[k] == n and kc[k + "_plain"] == 0
                  for k, n in want8.items()),
              f"NE8 std {mode}: launches {kc}, want {want8}")
        check(all(pc.get(k + "_plain") == n and not pc.get(k)
                  for k, n in want8.items()),
              f"NE8 std {mode}: plain run launches {pc}, want {want8} "
              "under the plain names")
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
            pub = dict(zip(NORM_KEYS,
                           mods["verify"].PUBLISHED[(test, ne, 72)]))
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
                  and launched.get("remap_q_ppm_t") == nsteps // 3
                  and launched.get("remap_health_t") == nsteps // 3
                  and not any(k.endswith("_plain") for k in launched),
                  f"CLI {test} NE{ne}: launches {launched}, want "
                  f"limiter_optim {K10_PER_STEP * nsteps}, remap_q_ppm_t "
                  f"and remap_health_t {nsteps // 3} (one a subcycle of "
                  "rsplit 3) and no plain")
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
    # the first subcycle hands its remap's inputs to the recorders: K3's
    # lanes (4 tracers x 72 levels) and both fields of widths
    seen = {}
    levels_t, lanes_t = core.remap_levels_t, core.remap_lanes_t

    def levels_rec(mm, proj, dt, plain=False):
        out = levels_t(mm, proj, dt, plain=plain)
        seen.update(dps=out[0], dpr=out[1], min_dp=out[3])
        return out

    def lanes_rec(mm, Qt, dps, dpr, plain=False):
        seen["Qt"] = Qt.clone()
        return lanes_t(mm, Qt, dps, dpr, plain=plain)
    core.remap_levels_t, core.remap_lanes_t = levels_rec, lanes_rec
    try:
        Qdp, _, nstep, _ = step(initial_qdp(m12), 0)
    finally:
        core.remap_levels_t, core.remap_lanes_t = levels_t, lanes_t
    torch.cuda.synchronize()
    # K3 and the health kernel on them against their plain versions, bit
    # for bit, each timed beside its bound
    Qt12, dps12, dpr12 = seen["Qt"], seen["dps"], seen["dpr"]
    alg12, es12 = m12.cfg.vert_remap_q_alg, Qt12.element_size()
    F12, lv12 = Qt12.numel(), dps12.numel()
    sh12 = remap.kernel_config(m12.cfg.qsize, m12.cfg.nlev, Qt12.dtype)
    std_k = {
        "K3": (lambda: remap.remap_q_ppm_t(Qt12, dps12, dpr12, alg=alg12),
               lambda: remap.remap_q_ppm_t_plain(Qt12, dps12, dpr12,
                                                 alg=alg12),
               (2 * F12 + 2 * lv12) * es12, F12 * OPS["ppm"]),
        "health": (lambda: remap.remap_health_t(dps12, dpr12),
                   lambda: remap.remap_health_t_plain(dps12, dpr12),
                   2 * lv12 * es12, lv12 * OPS["health"])}
    std_line = []
    for name, (kern, plain, nbytes, nops) in std_k.items():
        got, want = kern(), plain()
        check(torch.equal(bits(torch, got), bits(torch, want)),
              f"phase 12: {name} on the std NE30 f64 DCMIP 1-2 remap "
              "inputs is not bitwise equal to its plain version")
        t_k, t_p = timed(torch, kern), timed(torch, plain)
        b = bound(nbytes, nops, "f64")[0]
        std_line.append(f"{name} bitwise, {t_k:.4f} ms against its bound "
                        f"{b:.4f} ({b / t_k:.1%}), plain {t_p:.3f} ms")
        if name == "health":
            # in the cell window, and the subcycle's min_dp is this value
            check(float(got) > 0 and float(got) == float(seen["min_dp"]),
                  f"phase 12: health value {float(got)!r}, the subcycle's "
                  f"min_dp {float(seen['min_dp'])!r}")
            std_line[-1] += f", value {float(got):.9g}"
        del got, want
    del seen, Qt12, dps12, dpr12, std_k
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
        f"{wall / 3 * 1e3:.2f} ms/subcycle on {card}; the first subcycle's "
        f"remap inputs ({m12.cfg.qsize} tracers x {m12.cfg.nlev} levels, K3 "
        f"{sh12['form']}, {sh12['rows']} rows, {sh12['threads']} threads): "
        + "; ".join(std_line))
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
        x, _, _, _, divp, *_ = stage_inputs(m13)
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
          and c15["remap_q_ppm_t"] == c15["remap_health_t"] == 8
          and c15["dss_band"] == 0
          and not any(v for k, v in c15.items() if k.endswith("_plain")),
          f"std sharded launches {c15}")
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

    # ---- 17. the NE42 proxy subcycle, then the port's benchmark ----------
    cfg42 = perf_config(PROXY_NE, dtype="f32", use_pallas=True)
    m42 = build_model(cfg42, dev)
    E42, nq, nk = m42.lon.shape[0], cfg42.qsize, cfg42.nlev
    Q42 = initial_qdp(m42)
    sp42 = m42.spheremp.double()
    mass0 = torch.einsum("eqkij,eij->q", Q42.double(), sp42)
    Qt42 = _tp(Q42, E42, nq * nk)
    del Q42
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    out42, _, _, md42 = make_subcycle_fn(m42, io_layout="t")(Qt42, 0)
    torch.cuda.synchronize()
    c42 = counters.snapshot()
    for k, n in FACE_SUBCYCLE_COUNTS.items():
        check(c42[k] == n and c42[k + "_plain"] == 0, f"NE42 subcycle: {k} "
              f"{c42[k]} (plain {c42[k + '_plain']}), want {n}")
    out42p = make_subcycle_fn(m42, io_layout="t", plain=True)(Qt42, 0)[0]
    torch.cuda.synchronize()
    a42, r42 = rel_err(torch, out42, out42p)
    check(r42 <= TOL["f32"], f"NE42 subcycle kernels vs plain rel {r42:.3e}")
    check(bool(torch.isfinite(out42).all()) and float(md42) > 0,
          f"NE42 subcycle: non-finite state or min_dp {float(md42)}")
    mass1 = torch.einsum("epqk,ep->q",
                         out42.double().reshape(E42, 16, nq, nk),
                         sp42.reshape(E42, 16))
    dmass = ((mass1 - mass0).abs() / mass0.abs()).max().item()
    check(dmass < MASS_TOL, f"NE42 subcycle: mass change {dmass:.3e}")
    say(f"phase 17 NE{PROXY_NE} f32 face subcycle (E={E42}, tstep "
        f"{cfg42.tstep:g}, nu_q {cfg42.nu_q:g}, limiter cap "
        f"{cfg42.limiter_iter_cap}) kernels vs plain: max abs {a42:.3e}, max "
        f"rel {r42:.3e} (tol {TOL['f32']:.0e}); launches "
        + ", ".join(f"{k} {c42[k]}" for k in FACE_SUBCYCLE_COUNTS)
        + f"; min_dp {float(md42):.6g}; max relative tracer-mass change "
        f"{dmass:.3e}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del m42, Qt42, out42, out42p
    torch.cuda.empty_cache()

    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    bp = subprocess.run([sys.executable, "-m", "transport_se_tpu_torch.bench"],
                        cwd=ROOT, env=env, capture_output=True, text=True,
                        timeout=BENCH_TIMEOUT)
    bench_s = time.perf_counter() - t0
    for ln in bp.stderr.strip().splitlines():
        say(f"phase 17 bench stderr: {ln}")
    check(bp.returncode == 0, f"bench exited {bp.returncode}")
    out_lines = bp.stdout.strip().splitlines()
    check(len(out_lines) == 1, f"bench printed {len(out_lines)} lines")
    bres = json.loads(out_lines[0])
    check(set(bres) == BENCH_KEYS, f"bench keys {sorted(bres)}")
    check(all(bres[k] > 0 for k in ("value", "vs_baseline", "ne42_proxy_value",
                                    "ne42_proxy_vs_baseline")),
          f"bench: {bres}")
    rows = [ln for ln in bp.stderr.splitlines() if " row: " in ln]
    check(len(rows) == 2 and all("fused_advect_limit" in r and "_plain"
                                 not in r for r in rows),
          f"bench rows did not run the kernels: {rows}")
    say(f"phase 17 bench: {json.dumps(bres)}; NE{NE} {bres['value']:.4e} "
        f"({bres['vs_baseline']}x baseline), NE{PROXY_NE} proxy "
        f"{bres['ne42_proxy_value']:.4e} ({bres['ne42_proxy_vs_baseline']}x)"
        f" gridpoint-tracers/s on {card}; subprocess wall {bench_s:.1f} s")

    # ---- 18. the sharded gather T subcycle: the boundary-first split ------
    cfg18 = perf_config(NE, dtype="f32", dss_mode="gather", use_pallas=True)
    m18 = build_model(cfg18, dev)
    E, nq, nk = m18.lon.shape[0], cfg18.qsize, cfg18.nlev
    Q18 = initial_qdp(m18)
    sp = m18.spheremp.double()
    mass0 = torch.einsum("eqkij,eij->q", Q18.double(), sp)
    one = subcycles(make_subcycle_fn(m18, io_layout="t"), _tp(Q18, E, nq * nk),
                    lambda st: core._tp_back(st, Q18.shape),
                    n=GATHER_SUBCYCLES)
    say(f"phase 18 NE{NE} f32 single-device gather T subcycle: median "
        f"{statistics.median(one[3]):.2f} ms per subcycle (host wall "
        f"{one[4]:.2f} ms); min_dp {one[2]}")
    # the first subcycle through the kernels' plain versions on one device:
    # the reference of every sharded run's first subcycle
    plain18 = core._tp_back(make_subcycle_fn(m18, io_layout="t", plain=True)(
        _tp(Q18, E, nq * nk), 0)[0], Q18.shape)
    outs = {}
    for overlap in (True, False):
        counters.reset()
        runner = sharded.make_sharded_subcycle(
            m18, comm_mod.ThreadComm(SHARDED_S), overlap=overlap)
        first, out, mds, ms, host = subcycles(
            runner.step, runner.shard_qdp(Q18), runner.gather,
            n=GATHER_SUBCYCLES)
        counts = counters.snapshot()
        nb, eloc = runner.plan.nbound, runner.plan.eloc
        check((0 < nb < eloc) if overlap else nb == 0,
              f"gather S={SHARDED_S} overlap {overlap}: nbound {nb} of {eloc}")
        want = gather_shard_counts(SHARDED_S, GATHER_SUBCYCLES, overlap)
        for k, n in want.items():
            check(counts[k] == n and counts[k + "_plain"] == 0,
                  f"gather S={SHARDED_S} overlap {overlap}: {k} {counts[k]} "
                  f"(plain {counts[k + '_plain']}), want {n}")
        check(bool(torch.isfinite(out).all()) and min(mds) > 0,
              f"gather S={SHARDED_S}: non-finite state or min_dp {mds}")
        mass1 = torch.einsum("eqkij,eij->q", out.double(), sp)
        dmass = ((mass1 - mass0).abs() / mass0.abs()).max().item()
        check(dmass < MASS_TOL, f"gather S={SHARDED_S}: mass {dmass:.3e}")
        d1, r1 = rel_err(torch, out, one[1])
        check(r1 <= TOL["f32"], f"gather S={SHARDED_S} overlap {overlap}: "
              f"{r1:.3e} from one device")
        dp, rp = rel_err(torch, first, plain18)
        check(rp <= TOL["f32"], f"gather S={SHARDED_S} overlap {overlap}: "
              f"first subcycle {rp:.3e} from the plain versions")
        outs[overlap] = out
        say(f"phase 18 NE{NE} f32 sharded gather T subcycle, S={SHARDED_S} "
            f"threads, overlap {overlap} (nbound {nb} of eloc {eloc}): "
            + ("bitwise equal to" if torch.equal(out, one[1]) else
               f"max abs {d1:.3e} (rel {r1:.3e}) from")
            + f" one device after {GATHER_SUBCYCLES} subcycles; first "
            f"subcycle against the plain versions on one device: max abs "
            f"{dp:.3e}, rel {rp:.3e} (tol {TOL['f32']:.0e}); launches per "
            "shard a subcycle " + ", ".join(
                f"{k} {counts[k] / SHARDED_S / GATHER_SUBCYCLES:g}"
                for k in want if want[k])
            + f"; min_dp {mds}; max relative tracer-mass change {dmass:.3e}; "
            f"median {statistics.median(ms):.2f} ms per subcycle (min "
            f"{min(ms):.2f}, max {max(ms):.2f}; host wall {host:.2f} ms)")
        del runner, out, first
    d, r = rel_err(torch, outs[True], outs[False])
    check(r <= TOL["f32"], f"gather split vs no overlap rel {r:.3e}")
    say("phase 18 split (overlap on) against overlap off: "
        + ("bitwise equal" if torch.equal(outs[True], outs[False]) else
           f"max abs {d:.3e}, rel {r:.3e} (tol {TOL['f32']:.0e})"))
    del m18, Q18, one, outs, plain18
    torch.cuda.empty_cache()

    # ---- 19. the dry run and the one-device entry ------------------------
    dryrun = mods["dryrun"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dr = dryrun.dryrun_multichip(SHARDED_S, dev)
    for case, extra in (("face", "dss_band"), ("gather", "laplace_wk_t")):
        la = dr[case]["launches"]
        check(la.get("fused_advect_limit") == 2 * 9 * SHARDED_S
              and la.get(extra, 0) > 0
              and not any(k.endswith("_plain") for k in la),
              f"dry run {case}: launches {la}")
        # the sharded state against one device through the plain versions
        cfg = dr[case]["cfg"]
        mc = build_model(cfg, dev)
        want = make_subcycle_fn(mc, plain=True)(initial_qdp(mc), 0)[0]
        da, ra = rel_err(torch, dr[case]["state"], want)
        check(ra <= TOL[cfg.dtype], f"dry run {case}: {ra:.3e} from the "
              f"plain versions on one device (tol {TOL[cfg.dtype]:.0e})")
        say(f"phase 19 dry run {case} ({cfg.dtype}, {cfg.dss_mode}) against "
            f"one device through the plain versions: max abs {da:.3e}, rel "
            f"{ra:.3e} (tol {TOL[cfg.dtype]:.0e})")
    step, (q, n) = dryrun.entry(dev)
    counters.reset()
    q1, _, n1, md = step(q, n)
    torch.cuda.synchronize()
    ce = {k: v for k, v in counters.snapshot().items() if v}
    check(n1 == 3 and float(md) > 0 and bool(torch.isfinite(q1).all())
          and ce == {"limiter_optim": 3 * K10_PER_STEP, "remap_q_ppm_t": 1,
                     "remap_health_t": 1},
          f"entry step: nstep {n1}, min_dp {float(md)}, launches {ce}")
    say(f"phase 19 {buf.getvalue().strip()}; launches face "
        + ", ".join(f"{k} {v}" for k, v in dr["face"]["launches"].items())
        + " | gather " + ", ".join(
            f"{k} {v}" for k, v in dr["gather"]["launches"].items())
        + f"; entry() NE8 DCMIP 1-1 f32 step: min_dp {float(md):.6g}, "
        "launches " + ", ".join(f"{k} {v}" for k, v in ce.items())
        + f"; chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    del q, q1, step

    # ---- 20. NE120 at full size on one card -----------------------------
    phase_ne120(torch, mods, dev, t_start)

    # ---- 21. NE120 x 35 tracers in f64: the group plan -------------------
    phase_ne120_f64(torch, mods, dev, t_start)

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
