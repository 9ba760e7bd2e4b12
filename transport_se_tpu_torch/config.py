"""Run configuration.

The port's own copy of `transport_se_tpu/config.py` (numpy only), kept
bit-identical to it (tests/test_torch_host.py), except that it takes
limiter_iter_cap = 15 (LIMITER_PASSES, the reference's own count) in f64
as the same as 0, where the JAX package refuses it.

Single dataclass replacing the reference's two-tier compile-time/namelist
system (reference: control_mod.F90 globals, namelist_mod.F90:143 `readnl`,
configure.sh compile-time dims).  All dimensions are runtime arguments;
shapes specialize at jit time.

Only the options exercised by the graded configs are implemented; the
constructor rejects unsupported settings loudly rather than silently
ignoring them (tstep_type=1 RK + vertically-Lagrangian rsplit>0 +
prescribed winds is the entire shipped behavior of the reference mini-app).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# the reference's limiter passes, np*np-1 (prim_advection_mod.F90:1009): a
# limiter_iter_cap of 0 or of this count is its full iteration, in any dtype
LIMITER_PASSES = 15


@dataclasses.dataclass(frozen=True)
class Config:
    # resolution
    ne: int = 8                   # elements per cube edge  (namelist `ne`)
    nlev: int = 72                # vertical levels         (PLEV)
    qsize: int = 4                # number of tracers       (namelist `qsize`)

    # timestepping (namelist: tstep, qsplit, rsplit, ndays/nmax)
    tstep: float = 400.0          # dynamics timestep, seconds
    qsplit: int = 1               # tracer:dynamics step ratio
    rsplit: int = 3               # tracer steps per vertical remap
    ndays: float = 0.0            # simulation length in days (0 -> use nmax)
    nmax: int = 0                 # number of steps if ndays == 0

    # physics options
    test_case: str = "dcmip1-1"   # dcmip1-1 | dcmip1-2
    prescribed_wind: bool = True
    limiter_option: int = 8       # 8 (optimization limiter) | 0 (none)
    nu_q: float = 0.0             # tracer hyperviscosity coefficient
    hypervis_order: int = 2
    hypervis_subcycle_q: int = 1
    vert_remap_q_alg: int = 0     # 0: mirror-ghost PPM (reference default)
    ppm_search: str = "fast"      # fast: bounded +-2-cell interface search
                                  # (TPU shift-select; the run ABORTS via
                                  # the ppm_fast_margin health check if the
                                  # Lagrangian grid deforms past the
                                  # window) | general: unbounded counting
                                  # search matching the reference's walking
                                  # loop (prim_advection_mod.F90:159-173) —
                                  # handles any deformation at a measured
                                  # cost (XLA path, no Pallas kernel); the
                                  # margin guard is then advisory only

    # vertical coordinate (namelist vfile_mid/vfile_int)
    vcoord: str = "acme72"        # acme72 | dcmip64 | path prefix

    # numerics
    dtype: str = "f64"            # f64 (verification) | f32 (TPU perf)
    use_pallas: bool = False      # the T-layout kernel pipeline (the JAX
                                  # package's Pallas path; csrc/ here)
    pallas_eb: int = 8            # elements per fused-kernel invocation
                                  # (multiples of 8: Mosaic 2D-block rule)
    limiter_chunks: int = 0       # XLA-limiter convergence groups (0 =
                                  # auto: decoupled per-tracer-batch loops
                                  # on the f64 verification path; see
                                  # ops/limiter.py)
    rhs_bf16: bool = False        # advection-divergence matmuls at bf16
                                  # (1-pass MXU) with f32 limiter state —
                                  # perf knob, audited by
                                  # scripts/audit_bf16.py; v3 kernel only
    limiter_iter_cap: int = 0     # fused-kernel limiter iteration cap
                                  # (0 = the reference's np*np-1 = 15,
                                  # prim_advection_mod.F90:1009).  A cap
                                  # is mass-preserving (every loop exit
                                  # redistributes the clip residual); the
                                  # cost is a roundoff-scale bound
                                  # overshoot on columns that have not
                                  # yet converged — audited by
                                  # scripts/audit_limcap.py.  f32 Pallas
                                  # path only; the f64 verification
                                  # limiter always iterates to
                                  # convergence (in f64 the port also
                                  # takes 15, the reference's count
                                  # written out, as 0).
    dss_mode: str = "gather"      # gather (BFB partner order) | segsum
                                  # (scatter-add, roundoff reassociation) |
                                  # face (shifted-slice assembly, fastest;
                                  #  requires elem_order="raster")
    elem_order: str = "gilbert"   # element storage order (see build_grid)

    # diagnostics
    statefreq: int = 20
    disable_diagnostics: bool = False

    def __post_init__(self):
        if self.qsplit < 1:
            raise ValueError("qsplit must be >= 1")
        if self.rsplit < 1:
            raise NotImplementedError("rsplit=0 (Eulerian) not supported")
        if self.limiter_option not in (0, 4, 8):
            raise NotImplementedError("limiter_option must be 0, 4, or 8")
        if not self.prescribed_wind:
            raise NotImplementedError("only prescribed-wind transport")
        if self.hypervis_subcycle_q < 1:
            raise ValueError("hypervis_subcycle_q must be >= 1")
        if self.limiter_option == 8 and self.hypervis_subcycle_q != 1:
            # the reference aborts on this combination
            # (namelist_mod.F90:689-690)
            raise ValueError(
                "limiter 8 requires hypervis_subcycle_q=1")
        if self.dss_mode == "face" and self.elem_order != "raster":
            raise ValueError("dss_mode='face' requires elem_order='raster'")
        if self.limiter_iter_cap < 0 or (
                self.limiter_iter_cap not in (0, LIMITER_PASSES)
                and self.dtype != "f32"):
            raise ValueError(
                "limiter_iter_cap is an f32 perf knob (>= 1, or 0 or "
                f"{LIMITER_PASSES} for the reference's full iteration)")
        if self.ppm_search not in ("fast", "general"):
            raise ValueError("ppm_search must be 'fast' or 'general'")
        if self.vert_remap_q_alg not in (0, 1, 2):
            raise NotImplementedError(
                "vert_remap_q_alg must be 0/1 (mirrored-ghost PPM; in this "
                "mini-app 0 and 1 are the same remap_Q_ppm path) or 2 "
                "(no-bc PPM, piecewise-constant boundary cells)")

    @property
    def np_dtype(self):
        return np.float64 if self.dtype == "f64" else np.float32

    @property
    def dt_tracer(self) -> float:
        return self.tstep * self.qsplit

    @property
    def dt_remap(self) -> float:
        return self.tstep * self.qsplit * self.rsplit

    @property
    def nsteps(self) -> int:
        """Total tracer steps (namelist_mod.F90:348 nmax=ndays*86400/tstep)."""
        if self.ndays > 0:
            return int(self.ndays * 86400.0 / self.tstep)
        return self.nmax


# the shipped verification configurations (test/run_ne*_tests.sh)
def dcmip11_ne8(**kw) -> Config:
    return Config(ne=8, test_case="dcmip1-1", tstep=400.0, ndays=12,
                  qsize=4, nu_q=6e16, **kw)


def dcmip12_ne8(**kw) -> Config:
    return Config(ne=8, test_case="dcmip1-2", tstep=400.0, ndays=1,
                  qsize=4, nu_q=6e16, **kw)


def dcmip11_ne30(**kw) -> Config:
    return Config(ne=30, test_case="dcmip1-1", tstep=300.0, ndays=12,
                  qsize=4, nu_q=1e15, **kw)


def dcmip12_ne30(**kw) -> Config:
    return Config(ne=30, test_case="dcmip1-2", tstep=300.0, ndays=1,
                  qsize=4, nu_q=1e15, **kw)


def perf_config(ne: int, **kw) -> Config:
    """35-tracer throughput configs (test/run_ne*_perf.sh, README:160-192).

    ne=42 is the NE120-per-chip proxy: 6*42^2 = 10584 elements — one
    8-chip shard of the NE120 production grid (86400/8 = 10800) — run
    with the NE120 perf parameters (tstep=75, nu=1e13), so a single-chip
    benchmark is apples-to-apples with the reference's per-node NE120
    throughput (reference README:160-192, test/run_ne120_perf.sh)."""
    tstep = {8: 1200.0, 30: 300.0, 42: 75.0, 120: 75.0}[ne]
    nu = {8: 6e16, 30: 1e15, 42: 1e13, 120: 1e13}[ne]
    kw.setdefault("dss_mode", "face")
    kw.setdefault("elem_order", "raster")
    if kw.get("dtype") == "f32":
        # audited f32 perf default (scripts/audit_limcap.py): caps 4-6
        # leave tracer extrema and mass drift unchanged and move the NE8
        # norms only in the 4th digit (within the f32 path's own distance
        # from the published f64 digits); cap 3 and below widen q_min —
        # rejected.  Mass is preserved at any cap by construction.
        kw.setdefault("limiter_iter_cap", 4)
    return Config(ne=ne, test_case="dcmip1-1", tstep=tstep, qsize=35,
                  nu_q=nu, disable_diagnostics=True, **kw)
