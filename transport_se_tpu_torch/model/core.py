"""The tracer-transport core on T-layout state: RK-SSP advection + limiter +
hyperviscosity + vertically-Lagrangian PPM remap.

Port of the T-layout pipeline of `transport_se_tpu/model/core.py`
(`euler_step_t`, `advect_rk2_t_parts`, `vertical_remap_t`,
`make_subcycle_fn(io_layout="t")`; reference prim_advection_mod.F90:579
`Prim_Advec_Tracers_remap_rk2`, :667 `euler_step`, :645 `qdp_time_avg`,
:1242 `vertical_remap`).  The state is [E, 16, q*k] for the whole
subcycle: point axis second, lane = tracer*nlev + level.  The semantics
the published norms depend on are those of the JAX module's docstring:
three forward-Euler stages with dt/2 and rhs_multiplier 0, 1, 2 then the
(Qdp + 2 Qdp3)/3 average; stage-dependent limiter bounds; hyperviscosity on
stage 2 only; the one-step wind lag; the remap with the last step's
divdp_proj.

Both DSS modes of the T-layout pipeline are ported.  In face mode (the
production configuration, `perf_config`) every stage's DSS is the face
kernel K4 with its fused epilogues: stage 0 and 1 also emit the next
stage's bound prep, stage 1 also the first biharmonic Laplacian (so no
weak-Laplacian launch), stage 2 fuses the time average and, except on the
last step of the subcycle, the next step's stage-0 bounds; the bound prep
and the neighbor min/max run K5 and K6.  In gather mode the DSS, bound
prep and neighbor min/max are plain PyTorch gathers and stage 2 runs the
weak-Laplacian kernel K2.  Only limiter 8 is ported; the standard-layout
pipeline, diagnostics and the unbounded PPM search raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from transport_se_tpu.config import Config
from transport_se_tpu.constants import P0
from transport_se_tpu.grid.cubesphere import build_grid
from transport_se_tpu.grid.vcoord import (HVCoord, hvcoord_acme72,
                                          hvcoord_dcmip, hvcoord_from_files)

from ..ops.dss import DssTables
from ..ops.euler import (MAX_ITER, fused_advect_limit,
                         fused_advect_limit_plain, laplace_wk_t,
                         laplace_wk_t_plain)
from ..ops.ppm import ppm_fast_margin
from ..ops.remap import remap_q_ppm_t, remap_q_ppm_t_plain
from . import dcmip


@dataclasses.dataclass(frozen=True)
class Model:
    """Static problem definition and the model's constant tensors, all on
    one device in the model dtype (tables in int64/bool)."""
    cfg: Config
    hv: HVCoord              # host-side vertical coordinate (numpy f64)
    tables: DssTables
    lon: torch.Tensor        # [E, 4, 4]
    lat: torch.Tensor
    deriv: torch.Tensor      # [4, 4]  deriv[l, i] = ell_i'(x_l)
    D: torch.Tensor          # [E, 4, 4, 2, 2]
    Dinv: torch.Tensor
    metdet: torch.Tensor     # [E, 4, 4]
    rmetdet: torch.Tensor
    spheremp: torch.Tensor
    rspheremp: torch.Tensor
    etam: torch.Tensor       # [K]
    etai: torch.Tensor       # [K+1]
    hyai: torch.Tensor
    hybi: torch.Tensor
    dp0col: torch.Tensor     # [K] analytic p0*(etai[k+1]-etai[k])
    dp0ref: torch.Tensor     # [K] hyperviscosity dp0 (hvcoord.dp0)
    met: torch.Tensor        # [E, 10, 16] kernel metric pack (ops.euler)

    @property
    def device(self) -> torch.device:
        return self.lon.device

    @property
    def dtype(self) -> torch.dtype:
        return self.lon.dtype


def hvcoord(cfg: Config) -> HVCoord:
    if cfg.vcoord == "acme72":
        hv = hvcoord_acme72()
    elif cfg.vcoord.startswith("dcmip"):
        hv = hvcoord_dcmip(int(cfg.vcoord[len("dcmip"):]))
    elif cfg.vcoord.startswith("files:"):
        hv = hvcoord_from_files(*cfg.vcoord.split(":")[1:])
    else:
        raise ValueError(cfg.vcoord)
    if hv.nlev != cfg.nlev:
        raise ValueError(f"vcoord nlev {hv.nlev} != cfg.nlev {cfg.nlev}")
    return hv


def build_model(cfg: Config, device) -> Model:
    """The model of cfg on `device`, from the JAX package's host-side grid
    and vertical-coordinate functions (bit-identical tables)."""
    from ..convert import model_from_numpy
    grid = build_grid(cfg.ne, order=cfg.elem_order)
    hv = hvcoord(cfg)
    arrays = dict(
        lon=grid.lon, lat=grid.lat, deriv=grid.deriv, D=grid.D,
        Dinv=grid.Dinv, metdet=grid.metdet, rmetdet=grid.rmetdet,
        spheremp=grid.spheremp, rspheremp=grid.rspheremp,
        etam=hv.etam, etai=hv.etai, hyai=hv.hyai, hybi=hv.hybi,
        dp0col=P0 * (hv.etai[1:] - hv.etai[:-1]), dp0ref=hv.dp0,
        part_idx=grid.part_idx, part_mask=grid.part_mask, nbr=grid.nbr)
    return model_from_numpy(cfg, arrays, device)


def initial_qdp(m: Model):
    """Qdp(0) = q * dp3d on the analytic levels: [E, q, k, 4, 4]."""
    q = dcmip.initial_tracers(m.cfg.test_case, m.lon, m.lat, m.etam,
                              m.cfg.qsize)
    return q * m.dp0col[None, None, :, None, None]


def _tp(x, E, inner):
    """[E, ..., 4, 4] with `inner` batch -> [E, 16, inner] (contiguous)."""
    return x.reshape(E, inner, 16).transpose(1, 2).contiguous()


def _tp_back(x_t, shape):
    """[E, 16, inner] -> the original [E, ..., 4, 4] shape."""
    return x_t.transpose(1, 2).reshape(shape)


def _kernels(plain: bool):
    if plain:
        return fused_advect_limit_plain, laplace_wk_t_plain, \
            remap_q_ppm_t_plain
    return fused_advect_limit, laplace_wk_t, remap_q_ppm_t


# ---------------------------------------------------------------------------
# one forward-Euler stage
# ---------------------------------------------------------------------------

def euler_step_t(m: Model, Qt, qmin, qmax, divdp_t, divdp_proj_t, uv_t, dt,
                 rhs_multiplier: int, pre_minmax=None, next_dp=None,
                 next_lap=False, pre_lap=None, avg_t=None, plain=False):
    """One stage: Qt' = DSS[limited(Qt - dt*div(Vstar Qt) + hypervis)].

    Qt [E,16,L]; divdp/uv [E,16,k]; qmin/qmax [E,L].  pre_minmax: this
    stage's per-element bound prep if the previous stage produced it;
    next_dp [E,16,k]: produce the NEXT stage's bound prep from this stage's
    output, and with next_lap also the first biharmonic Laplacian of
    output/next_dp (face mode only; the gather mode gives None).  pre_lap:
    that Laplacian, for stage 2.  avg_t: fuse qdp_time_avg into the
    output.  plain: run the kernels' plain PyTorch versions (test-only).
    Returns (Qt', qmin', qmax', ((next_qmin, next_qmax), next_lap) or
    None)."""
    cfg = m.cfg
    tb = m.tables
    E, _, L = Qt.shape
    nq, nk = cfg.qsize, cfg.nlev
    advect, laplace, _ = _kernels(plain)
    dp_t = m.dp0col[None, None, :] - rhs_multiplier * dt * divdp_proj_t
    rsp16 = m.rspheremp.reshape(E, 16)

    if pre_minmax is None:
        qmin_l, qmax_l = tb.minmax_prep(Qt, dp_t, nq, plain=plain)
    else:
        qmin_l, qmax_l = pre_minmax

    bih, nu_coef = None, 0.0
    if rhs_multiplier == 0:
        qmin, qmax = tb.neighbor_minmax(qmin_l, qmax_l, plain=plain)
    elif rhs_multiplier == 1:
        qmin = torch.minimum(qmin, qmin_l)
        qmax = torch.maximum(qmax, qmax_l)
    else:
        rhs_viss = 3
        qmin, qmax = tb.neighbor_minmax(qmin_l, qmax_l, plain=plain)
        if cfg.nu_q > 0:
            # biharmonic: laplace -> DSS -> rspheremp here; the second
            # Laplacian and the tendency run inside the fused kernel.  The
            # face mode's stage-1 DSS already produced the first Laplacian.
            nu_coef = float(-rhs_viss * dt * cfg.nu_q)
            if pre_lap is None:
                Q_t = (Qt.reshape(E, 16, nq, nk)
                       / dp_t[:, :, None, :]).reshape(E, 16, L)
                pre_lap = laplace(Q_t, m.met, m.deriv)
            bih = tb.dss_scale_t(pre_lap, rsp16, plain=plain)

    out_t, qmin, qmax = advect(
        Qt, uv_t, dp_t, divdp_t, qmin, qmax, m.met, m.deriv, float(dt),
        bih=bih, nu_coef=nu_coef, dp0=m.dp0ref,
        max_iter=cfg.limiter_iter_cap or MAX_ITER)
    if next_dp is not None:
        Qt_new, nmn, nmx, lap = tb.dss_scale_minmax_t(
            out_t, rsp16, next_dp, nq, avg=avg_t, lap=next_lap, plain=plain)
        return Qt_new, qmin, qmax, ((nmn, nmx), lap)
    Qt_new = tb.dss_scale_t(out_t, rsp16, avg=avg_t, plain=plain)
    return Qt_new, qmin, qmax, None


def advect_rk2_t_parts(m: Model, Qt, uv_t, divdp_t, divdp_proj_t, dt_q,
                       pre_minmax0=None, next_step_dp=None, plain=False):
    """T-layout RK2 advection (one tracer step) from precomputed wind parts
    (uv_t = the mean-flux (u*dp, v*dp) pair, each [E,16,k]).

    Each stage's DSS also produces the NEXT stage's bound prep; stage 1's
    also the first biharmonic Laplacian (face mode); the third stage fuses
    qdp_time_avg and, given next_step_dp, the next tracer step's stage-0
    prep.  Returns (Qt', divdp_proj_t, next_minmax-or-None)."""
    E = Qt.shape[0]
    dt2 = dt_q / 2.0
    dp0_t = m.dp0col[None, None, :].expand(E, 16, m.cfg.nlev)
    dp1_t = dp0_t - 1.0 * dt2 * divdp_proj_t
    dp2_t = dp0_t - 2.0 * dt2 * divdp_proj_t
    zmin = Qt.new_zeros((E, Qt.shape[2]))
    Qt1, qmin, qmax, nb1 = euler_step_t(
        m, Qt, zmin, zmin, divdp_t, divdp_proj_t, uv_t, dt2, 0,
        pre_minmax=pre_minmax0, next_dp=dp1_t, plain=plain)
    Qt2, qmin, qmax, nb2 = euler_step_t(
        m, Qt1, qmin, qmax, divdp_t, divdp_proj_t, uv_t, dt2, 1,
        pre_minmax=nb1[0], next_dp=dp2_t, next_lap=m.cfg.nu_q > 0,
        plain=plain)
    Qt3, qmin, qmax, nb3 = euler_step_t(
        m, Qt2, qmin, qmax, divdp_t, divdp_proj_t, uv_t, dt2, 2,
        pre_minmax=nb2[0], pre_lap=nb2[1], avg_t=Qt, next_dp=next_step_dp,
        plain=plain)
    return Qt3, divdp_proj_t, None if nb3 is None else nb3[0]


def vertical_remap_t(m: Model, Qt, divdp_proj_t, dt_remap, plain=False):
    """Remap Qt from the Lagrangian levels to the reference hybrid levels
    (prim_advection_mod.F90:1242-1330).

    Returns (Qt', ps_v [E,4,4], min_dp): min_dp < 0 signals a negative
    layer thickness (reference abort :1323) or a displacement outside the
    remap's -2..+2 cell window (ppm_fast_margin)."""
    cfg = m.cfg
    E = Qt.shape[0]
    dp_star = m.dp0col[None, None, :] - dt_remap * divdp_proj_t
    ps_v = m.hyai[0] * P0 + dp_star.sum(dim=2)
    dp_ref = ((m.hyai[1:] - m.hyai[:-1])[None, None, :] * P0
              + (m.hybi[1:] - m.hybi[:-1])[None, None, :] * ps_v[..., None])
    health = torch.minimum(dp_star.min(), ppm_fast_margin(dp_star, dp_ref))
    min_dp = m.tables.global_min(health)
    remap = _kernels(plain)[2]
    Qnew = remap(Qt, dp_star, dp_ref, alg=cfg.vert_remap_q_alg)
    return Qnew, ps_v.reshape(E, 4, 4), min_dp


# ---------------------------------------------------------------------------
# the remap-interval step (prim_run_subcycle)
# ---------------------------------------------------------------------------

def check_ported(cfg: Config, diagnostics: bool = False,
                 io_layout: str = "t") -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    if diagnostics:
        raise NotImplementedError("diagnostics=True (the eta_dot/omega "
                                  "piggyback) is not ported yet")
    if io_layout != "t":
        raise NotImplementedError(f"io_layout={io_layout!r}: only the "
                                  "T layout [E,16,q*k] is ported")
    if cfg.limiter_option != 8:
        raise NotImplementedError(f"limiter_option={cfg.limiter_option}: "
                                  "only limiter 8 is ported")
    if cfg.ppm_search != "fast":
        raise NotImplementedError("ppm_search='general' is not ported")
    if cfg.rhs_bf16:
        raise NotImplementedError("rhs_bf16 is not ported")


def make_subcycle_fn(m: Model, diagnostics: bool = False,
                     io_layout: str = "t", plain: bool = False):
    """Returns fn(Qt, nstep) -> (Qt', ps_v, nstep', min_dp).

    One call advances cfg.rsplit tracer steps and performs one vertical
    remap (prim_driver_mod.F90:788-796) on T-layout state [E,16,q*k];
    nstep counts tracer steps.  plain=True runs the plain PyTorch versions
    of every kernel (K1-K3 and, in face mode, the DSS, bound prep and
    neighbor min/max) on any device: a test-only switch for holding the
    kernels against them on the card."""
    check_ported(m.cfg, diagnostics, io_layout)
    from .wind_basis import build_wind_basis
    cfg = m.cfg
    dt = float(cfg.tstep)
    dt_q = float(cfg.dt_tracer)
    dt_remap = float(cfg.dt_remap)
    # mean-flux weights for RK+LF per qsplit stage (ur_weights,
    # prim_advance_mod.F90:53-67); qsplit=1 gives w = [1]
    urw = np.zeros(cfg.qsplit)
    if cfg.qsplit % 2:
        urw[0] = 1.0 / cfg.qsplit
        urw[2::2] = 2.0 / cfg.qsplit
    else:
        urw[1::2] = 2.0 / cfg.qsplit
    ur_w = torch.as_tensor(urw, dtype=m.dtype, device=m.device)
    wb = build_wind_basis(m, plain=plain)

    def subcycle_t(Qt, nstep: int):
        E = Qt.shape[0]
        # contiguous: the next step's stage-0 dp of the bound-prep kernels
        dp0_t = m.dp0col[None, None, :].expand(E, 16, cfg.nlev).contiguous()
        divdp_proj_t = None
        mm0 = None
        for i in range(cfg.rsplit):
            # prescribed wind with the reference's one-step evaluation lag
            # (a device fill, not a host copy: no stream synchronisation)
            t_wind = torch.full((), float(max(nstep - 1, 0)), dtype=m.dtype,
                                device=m.device) * dt
            _, _, un0_t, vn0_t, divdp_t, divdp_proj_t = wb.eval(t_wind)
            if cfg.qsplit != 1:
                w = ur_w[nstep % cfg.qsplit]
                un0_t, vn0_t = un0_t * w, vn0_t * w
                divdp_t, divdp_proj_t = divdp_t * w, divdp_proj_t * w
            # step i's stage-3 output bounds over dp0 are step i+1's
            # stage-0 prep (stage-0 dp is the static dp0)
            nd = dp0_t if i < cfg.rsplit - 1 else None
            Qt, divdp_proj_t, mm0 = advect_rk2_t_parts(
                m, Qt, (un0_t, vn0_t), divdp_t, divdp_proj_t, dt_q,
                pre_minmax0=mm0, next_step_dp=nd, plain=plain)
            nstep = nstep + 1
        Qt, ps_v, min_dp = vertical_remap_t(m, Qt, divdp_proj_t, dt_remap,
                                            plain=plain)
        return Qt, ps_v, nstep, min_dp

    return subcycle_t
