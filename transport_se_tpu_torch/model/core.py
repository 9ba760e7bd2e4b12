"""The tracer-transport core: RK-SSP advection + limiter + hyperviscosity
+ vertically-Lagrangian PPM remap, in the std and the T layout.

Port of `transport_se_tpu/model/core.py` (reference:
prim_advection_mod.F90:579 `Prim_Advec_Tracers_remap_rk2`, :667
`euler_step`, :645 `qdp_time_avg`, :1242 `vertical_remap`).  The semantics
the published norms depend on are those of the JAX module's docstring:
three forward-Euler stages with dt/2 and rhs_multiplier 0, 1, 2 then the
(Qdp + 2 Qdp3)/3 average; stage-dependent limiter bounds; hyperviscosity on
stage 2 only; the one-step wind lag; the remap with the last step's
divdp_proj.

Two pipelines, chosen as the JAX package chooses them
(`make_subcycle_fn`):

* std layout (`euler_step`, `advect_rk2`, `vertical_remap`): the state is
  Qdp [E, q, k, 4, 4]; the operators are plain PyTorch tensor code, the
  winds are evaluated directly, limiter 8 runs the row limiter K10
  (`ops/limiter.py`), and the remap is the T layout's (K3 and its health
  kernel) on a T-layout copy of Qdp.  This is the f64 verification path
  of the `Config` defaults (use_pallas=False), with any DSS mode, limiter
  0/4/8, diagnostics (the eta_dot/omega piggyback DSS) and either PPM
  search.
* T layout (`euler_step_t`, `advect_rk2_t_parts`, `remap_levels_t`,
  `remap_lanes_t`),
  for use_pallas=True with limiter 8 and no diagnostics: the state is
  [E, 16, q*k] for the whole subcycle (point axis second, lane =
  tracer*nlev + level) and runs the fused stage K1, the remap K3 with
  its health kernel (the fast search's window check) and, in
  face mode (the production configuration, `perf_config`), the face DSS
  K4 with its fused epilogues, the bound prep K5 and the neighbor min/max
  K6; in gather or segsum mode the DSS, bound prep and neighbor min/max
  are plain PyTorch and stage 2 runs the weak-Laplacian kernel K2.

Both run per shard unchanged (parallel/sharded.py): a shard's Model holds
its slice of the element arrays (`shard_model`) and a ShardedDssTables.
With overlap, the face path runs each stage once more on the boundary
group to give the halo payload, and the gather path (elements in
boundary-first order) runs each stage as two launches, boundary group then
interior (`euler_step_t`).

rhs_bf16 (a TPU matmul-precision knob) is not ported and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..config import Config
from ..constants import P0
from ..grid.cubesphere import build_grid
from ..grid.vcoord import (HVCoord, hvcoord_acme72, hvcoord_dcmip,
                           hvcoord_from_files)

from ..ops import sphere_ops as so
from ..ops.dss import DssTables, dss_scale
from ..ops.euler import (MAX_ITER, fused_advect_limit,
                         fused_advect_limit_plain, laplace_wk_t,
                         laplace_wk_t_plain)
from ..ops.lanes import lane_gather, lane_scatter
from ..ops.limiter import limiter_optim_stage
from ..ops.ppm import remap_q_ppm_general
from ..ops.remap import (remap_health_t, remap_health_t_plain, remap_q_ppm_t,
                         remap_q_ppm_t_plain)
from ..timing import span
from . import dcmip


@dataclasses.dataclass(frozen=True)
class Model:
    """Static problem definition and the model's constant tensors, all on
    one device in the model dtype (tables in int64/bool)."""
    cfg: Config
    grid: Any                # host-side grid (grid.cubesphere.Grid, numpy)
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
    """The model of cfg on `device`, from the port's host-side grid and
    vertical-coordinate modules (bit-identical to the JAX package's)."""
    from ..convert import model_from_numpy
    check_config(cfg)
    grid = build_grid(cfg.ne, order=cfg.elem_order)
    hv = hvcoord(cfg)
    arrays = dict(
        lon=grid.lon, lat=grid.lat, deriv=grid.deriv, D=grid.D,
        Dinv=grid.Dinv, metdet=grid.metdet, rmetdet=grid.rmetdet,
        spheremp=grid.spheremp, rspheremp=grid.rspheremp,
        etam=hv.etam, etai=hv.etai, hyai=hv.hyai, hybi=hv.hybi,
        dp0col=P0 * (hv.etai[1:] - hv.etai[:-1]), dp0ref=hv.dp0,
        part_idx=grid.part_idx, part_mask=grid.part_mask, nbr=grid.nbr)
    return model_from_numpy(cfg, arrays, device, grid=grid)


def initial_qdp(m: Model):
    """Qdp(0) = q * dp3d on the analytic levels: [E, q, k, 4, 4]."""
    q = dcmip.initial_tracers(m.cfg.test_case, m.lon, m.lat, m.etam,
                              m.cfg.qsize)
    return q * m.dp0col[None, None, :, None, None]


def initial_qdp_t(m: Model):
    """initial_qdp in the T layout [E, 16, q*k], bitwise _tp(initial_qdp(m),
    E, q*k), written a tracer at a time into the one state buffer: the
    build holds one state and a few [E, k, 4, 4] fields, where initial_qdp
    and _tp hold two states at once."""
    cfg = m.cfg
    E, nq, nk = m.lon.shape[0], cfg.qsize, cfg.nlev
    out = m.lon.new_empty((E, 16, nq, nk))
    for i, q in enumerate(dcmip.initial_tracer_fields(
            cfg.test_case, m.lon, m.lat, m.etam, nq)):
        out[:, :, i] = (q * m.dp0col[None, :, None, None]) \
            .reshape(E, nk, 16).transpose(1, 2)
    return out.reshape(E, 16, nq * nk)


def _tp(x, E, inner):
    """[E, ..., 4, 4] with `inner` batch -> [E, 16, inner] (contiguous)."""
    return x.reshape(E, inner, 16).transpose(1, 2).contiguous()


def _take(x):
    """The state a pipeline function is handed: x itself (the caller keeps
    it alive), or the one tensor of the list x, which is set to None so
    that the callee drops the last reference at the tensor's last use, as
    XLA frees a donated buffer."""
    if isinstance(x, list):
        t, x[0] = x[0], None
        return t
    return x


def _tp_back(x_t, shape):
    """[E, 16, inner] -> the original [E, ..., 4, 4] shape."""
    return x_t.transpose(1, 2).reshape(shape)


def _kernels(plain: bool):
    if plain:
        return fused_advect_limit_plain, laplace_wk_t_plain, \
            remap_q_ppm_t_plain
    return fused_advect_limit, laplace_wk_t, remap_q_ppm_t


# ---------------------------------------------------------------------------
# std layout: one forward-Euler stage, the RK2 step and the remap
# ---------------------------------------------------------------------------

def _dss_scale(m: Model, x, plain=False):
    """rspheremp * DSS(spheremp * x) with metric dims broadcast."""
    return dss_scale(x, m.spheremp, m.rspheremp, m.tables, plain=plain)


def euler_stage_tens(m: Model, Qdp_n0, qmin, qmax, divdp, divdp_proj, vn0,
                     dt, rhs_multiplier: int, plain=False):
    """A stage up to its limiter: the stage's bounds and its tendency.

    Qdp_n0 [E,q,k,n,n]; qmin/qmax [E,q,k]; divdp/divdp_proj [E,k,n,n];
    vn0 [E,k,2,n,n] the mean flux.  rhs_multiplier (0, 1 or 2) selects the
    stage's dp offset and bound bookkeeping.  Returns (Qtens, qmin', qmax',
    dp_star): Qtens = Qdp - dt*div(Vstar Qdp) (+ hyperviscosity on stage
    2) and dp_star [E,k,n,n], the limiter's thickness with the
    UN-projected divdp.  Its parts open the spans `stage.bounds`,
    `stage.hypervis` (stage 2) and `stage.advect`."""
    cfg = m.cfg
    tb = m.tables
    with span("stage.bounds"):
        dp = m.dp0col[None, :, None, None] - rhs_multiplier * dt * divdp_proj
        Q = Qdp_n0 / dp[:, None]                      # [E,q,k,n,n]
        qmin_l = Q.amin(dim=(-2, -1))                 # [E,q,k]
        qmax_l = Q.amax(dim=(-2, -1))
        if rhs_multiplier == 1:
            qmin = torch.minimum(qmin, qmin_l)
            qmax = torch.maximum(qmax, qmax_l)
        else:  # stages 0 and 2: fresh neighbor min/max
            qmin, qmax = tb.neighbor_minmax(qmin_l, qmax_l, plain=plain)

    Qtens_bih = None
    if rhs_multiplier == 2 and cfg.nu_q > 0:  # biharmonic
        rhs_viss = 3
        with span("stage.hypervis"):
            lap1 = so.laplace_sphere_wk(Q, m.deriv, m.Dinv, m.spheremp)
            lap1 = tb.dss_sum(lap1, plain=plain) \
                * m.rspheremp[:, None, None, :, :]
            lap2 = so.laplace_sphere_wk(lap1, m.deriv, m.Dinv, m.spheremp)
            Qtens_bih = (-rhs_viss * dt * cfg.nu_q
                         * m.dp0ref[None, None, :, None, None] * lap2
                         / m.spheremp[:, None, None, :, :])

    with span("stage.advect"):
        # advection velocity from the mean flux (euler_step :845-852)
        Vstar = vn0 / dp[:, :, None]                  # [E,k,2,n,n]
        gradQ = Vstar[:, None] * Qdp_n0[:, :, :, None]  # [E,q,k,2,n,n]
        Qtens = Qdp_n0 - dt * so.divergence_sphere(
            gradQ, m.deriv, m.Dinv, m.metdet, m.rmetdet)
        if Qtens_bih is not None:
            Qtens = Qtens + Qtens_bih
        return Qtens, qmin, qmax, dp - dt * divdp


def limiter_args(m: Model, Qtens, dp_star):
    """limiter_optim_stage's row views of a stage: (ptens [E,q,k,16],
    spheremp [E,16], dp_star [E,k,16]), contiguous."""
    E, q, k = Qtens.shape[:3]
    return (Qtens.reshape(E, q, k, -1).contiguous(),
            m.spheremp.reshape(E, -1).contiguous(),
            dp_star.reshape(E, k, -1).contiguous())


def euler_step(m: Model, Qdp_n0, qmin, qmax, divdp, divdp_proj, vn0,
               dssvar, dt, rhs_multiplier: int, plain=False):
    """One stage: Qdp' = DSS[limited(Qdp - dt*div(Vstar Qdp) + hypervis)]
    (see euler_stage_tens for the arguments).  dssvar: a field DSSed
    along (divdp_proj on stage 0, the eta_dot/omega diagnostics), or None.
    plain: the limiter and the face-mode DSS run their plain versions.
    The stage opens the span `stage`, and in it `stage.limiter` and
    `stage.dss` beside euler_stage_tens' spans.
    Returns (Qdp', qmin', qmax', dssvar')."""
    with span("stage"):
        Qtens, qmin, qmax, dp_star = euler_stage_tens(
            m, Qdp_n0, qmin, qmax, divdp, divdp_proj, vn0, dt,
            rhs_multiplier, plain=plain)
        if m.cfg.limiter_option == 8:
            with span("stage.limiter"):
                ptens, sp_rows, dp_rows = limiter_args(m, Qtens, dp_star)
                out, qmin, qmax = limiter_optim_stage(
                    ptens, sp_rows, dp_rows, qmin, qmax, plain=plain)
                Qtens = out.reshape(Qtens.shape)
        # limiter_option 0 and 4: the reference's euler_step applies no
        # limiter (only option 8 dispatches there, prim_advection_mod.F90:858)

        with span("stage.dss"):
            Qdp_np1 = _dss_scale(m, Qtens, plain)
            dssvar_out = (_dss_scale(m, dssvar, plain) if dssvar is not None
                          else None)
        return Qdp_np1, qmin, qmax, dssvar_out


def advect_rk2(m: Model, Qdp, vn0, dt_q, eta_dot=None, omega=None,
               plain=False):
    """Prim_Advec_Tracers_remap_rk2 (:579-640) in the std layout.

    Returns (Qdp', divdp_proj, eta_dot', omega'): eta_dot/omega are the
    optional diagnostics DSSed along stages 1 and 2 (None skips them)."""
    divdp = so.divergence_sphere(vn0, m.deriv, m.Dinv, m.metdet, m.rmetdet)
    divdp_proj = divdp
    dt2 = dt_q / 2.0
    zero_minmax = Qdp.new_zeros(Qdp.shape[:3])

    Qdp1, qmin, qmax, divdp_proj = euler_step(
        m, Qdp, zero_minmax, zero_minmax, divdp, divdp_proj, vn0,
        divdp_proj, dt2, 0, plain=plain)
    Qdp2, qmin, qmax, eta_out = euler_step(
        m, Qdp1, qmin, qmax, divdp, divdp_proj, vn0, eta_dot, dt2, 1,
        plain=plain)
    Qdp3, qmin, qmax, omega_out = euler_step(
        m, Qdp2, qmin, qmax, divdp, divdp_proj, vn0, omega, dt2, 2,
        plain=plain)
    # qdp_time_avg (:645-662): u(t)/3 + 2/3 u(t+2)
    return (Qdp + 2.0 * Qdp3) / 3.0, divdp_proj, eta_out, omega_out


def vertical_remap(m: Model, Qdp, divdp_proj, dt_remap, plain=False):
    """Remap Qdp [E,q,k,n,n] from the Lagrangian levels to the reference
    hybrid levels (prim_advection_mod.F90:1242-1330), through the T
    layout's remap: remap_levels_t (the health kernel) and remap_lanes_t
    (K3, or the general search), each handed a contiguous [E,16,...] copy
    of its std-layout input.  Qdp may be handed over as a one-element list
    (_take), freed once copied.  plain: the kernels' plain versions.

    Returns (Qdp', ps_v [E,n,n], min_dp): min_dp < 0 signals a negative
    layer thickness (reference abort :1323) or, with ppm_search="fast", a
    displacement outside the remap's -2..+2 cell window.  The layout
    copies open spans of the T remap's names, so that every operator lies
    in `remap.levels`, `remap.health` or `remap.ppm`: `remap.levels`
    before remap_levels_t's own, and `remap.ppm` around remap_lanes_t's."""
    Qdp = _take(Qdp)
    shape = Qdp.shape
    E, nq, nk = shape[:3]
    with span("remap.levels"):
        proj_t = _tp(divdp_proj, E, nk)
    dp_star, dp_ref, ps_v, min_dp = remap_levels_t(m, proj_t, dt_remap,
                                                   plain=plain)
    del proj_t
    with span("remap.ppm"):
        Qt = _tp(Qdp, E, nq * nk)
        Qdp = None
        Qt = remap_lanes_t(m, Qt, dp_star, dp_ref, plain=plain)
        return _tp_back(Qt, shape).contiguous(), ps_v, min_dp


# ---------------------------------------------------------------------------
# T layout: one forward-Euler stage
# ---------------------------------------------------------------------------

def euler_step_t(m: Model, Qt, qmin, qmax, divdp_t, dp_t, uv_t, dt,
                 rhs_multiplier: int, pre_minmax=None, next_dp=None,
                 next_lap=False, pre_lap=None, avg_t=None, plain=False):
    """One stage: Qt' = DSS[limited(Qt - dt*div(Vstar Qt) + hypervis)].

    Qt [E,16,L]; divdp/uv [E,16,k]; qmin/qmax [E,L]; dp_t [E,16,k]: the
    stage's thickness (stage_dps).  pre_minmax: this stage's per-element
    bound prep if the previous stage produced it; next_dp [E,16,k]:
    produce the NEXT stage's bound prep from this stage's output, and with
    next_lap also the first biharmonic Laplacian of output/next_dp (face
    mode only; the gather mode gives None).  pre_lap: that Laplacian, for
    stage 2.  avg_t: fuse qdp_time_avg into the output.  plain: run the
    kernels' plain PyTorch versions (test-only).
    Qt, qmin, qmax, pre_minmax and pre_lap may each be handed over as a
    one-element list (_take): the stage then drops its bounds and bound
    prep once its own bounds are made, the first Laplacian once the
    hyperviscosity input is made, and its input and that input after K1,
    so that a subcycle holds at most four state-sized buffers and four
    [E, L] bound arrays at any kernel launch.
    On a shard in boundary-first order (tables.nbound between 0 and E)
    K1 runs on the boundary group and on the interior apart, the DSS takes
    its halo from the boundary group's output alone (its exchange started
    before the interior's launch), and the next stage's bound prep is left
    to that stage.
    Returns (Qt', qmin', qmax', ((next_qmin, next_qmax), next_lap) or
    None)."""
    with span("stage"):
        cfg = m.cfg
        tb = m.tables
        Qt, qmin, qmax, pre_minmax, pre_lap = map(
            _take, (Qt, qmin, qmax, pre_minmax, pre_lap))
        E, _, L = Qt.shape
        nq, nk = cfg.qsize, cfg.nlev
        advect, laplace, _ = _kernels(plain)
        rsp16 = m.rspheremp.reshape(E, 16)

        with span("stage.bounds"):
            if pre_minmax is None:
                qmin_l, qmax_l = tb.minmax_prep(Qt, dp_t, nq, plain=plain)
            else:
                qmin_l, qmax_l = pre_minmax
            pre_minmax = None
            if rhs_multiplier == 1:
                qmin = torch.minimum(qmin, qmin_l)
                qmax = torch.maximum(qmax, qmax_l)
            else:
                # stages 0 and 2 take fresh neighbour bounds: the inputs
                # are dead
                qmin = qmax = None
                qmin, qmax = tb.neighbor_minmax(qmin_l, qmax_l, plain=plain)
            del qmin_l, qmax_l

        bih, nu_coef = None, 0.0
        if rhs_multiplier == 2:
            rhs_viss = 3
            if cfg.nu_q > 0:
                # biharmonic: laplace -> DSS -> rspheremp here; the second
                # Laplacian and the tendency run inside the fused kernel.
                # The face mode's stage-1 DSS already produced the first
                # Laplacian.
                nu_coef = float(-rhs_viss * dt * cfg.nu_q)
                with span("stage.hypervis"):
                    if pre_lap is None:
                        Q_t = (Qt.reshape(E, 16, nq, nk)
                               / dp_t[:, :, None, :]).reshape(E, 16, L)
                        pre_lap = laplace(Q_t, m.met, m.deriv)
                        del Q_t
                    bih = tb.dss_scale_t(pre_lap, rsp16, plain=plain)
        pre_lap = None

        kw = dict(nu_coef=nu_coef, dp0=m.dp0ref,
                  max_iter=cfg.limiter_iter_cap or MAX_ITER)

        def advect_on(pick):
            """K1 on the elements pick(a) selects of every per-element
            operand."""
            def cut(a):
                return None if a is None else pick(a)
            with span("stage.advect"):
                return advect(cut(Qt), (cut(uv_t[0]), cut(uv_t[1])),
                              cut(dp_t), cut(divdp_t), cut(qmin), cut(qmax),
                              cut(m.met), m.deriv, float(dt), bih=cut(bih),
                              **kw)

        nb = getattr(tb, "nbound", 0)
        if 0 < nb < E:
            # boundary/interior split (boundary-first element order; JAX
            # core.py:322-350): K1 on the boundary group, whose output
            # alone feeds the halo rounds; the exchange is started before
            # K1 runs on the interior, so a communicator that exchanges
            # beside the device (DistComm) carries it while the interior
            # computes.  Leading-dimension slices stay contiguous, and K1's
            # per-column results do not depend on which elements share its
            # launch, so the split changes no bit.
            out_b, qmin_b, qmax_b = advect_on(lambda a: a[:nb])
            with span("stage.dss"):
                pending = tb.halo_start(out_b)
            out_i, qmin_i, qmax_i = advect_on(lambda a: a[nb:])
            Qt = bih = None
            with span("stage.dss"):
                res = (tb.dss_sum_t_split(out_b, out_i, pending)
                       * rsp16[:, :, None])
                if avg_t is not None:
                    res = (avg_t + 2.0 * res) / 3.0
                # the next stage's bound prep stays unfused: it runs
                # minmax_prep
                return (res, torch.cat([qmin_b, qmin_i]),
                        torch.cat([qmax_b, qmax_i]), None)
        out_t, qmin_o, qmax_o = advect_on(lambda a: a)
        dss_kw = {}
        if tb.overlap_face:
            # face+overlap composition (JAX core.py:358-380): the stage
            # once more on the boundary group alone (the elements some
            # peer needs) gives the halo payload xb.  K1's per-column
            # results do not depend on which elements share its launch, so
            # xb is bitwise out_t[bidx] and the assembly is unchanged; the
            # payload depends only on the small launch.
            dss_kw["xb"] = advect_on(lambda a: a.index_select(0, tb.bidx))[0]
        # the stage's input and hyperviscosity input are dead after K1
        Qt = bih = None
        qmin, qmax = qmin_o, qmax_o
        with span("stage.dss"):
            if next_dp is not None:
                Qt_new, nmn, nmx, lap = tb.dss_scale_minmax_t(
                    out_t, rsp16, next_dp, nq, avg=avg_t, lap=next_lap,
                    plain=plain, **dss_kw)
                return Qt_new, qmin, qmax, ((nmn, nmx), lap)
            Qt_new = tb.dss_scale_t(out_t, rsp16, avg=avg_t, plain=plain,
                                    **dss_kw)
            return Qt_new, qmin, qmax, None


def advect_rk2_t_parts(m: Model, Qt, uv_t, divdp_t, dps, dt_q,
                       pre_minmax0=None, next_step_dp=None, plain=False):
    """T-layout RK2 advection (one tracer step) from precomputed wind parts
    (uv_t = the mean-flux (u*dp, v*dp) pair, each [E,16,k]) and the three
    stages' thicknesses dps (stage_dps).

    Each stage's DSS also produces the NEXT stage's bound prep; stage 1's
    also the first biharmonic Laplacian (face mode); the third stage fuses
    qdp_time_avg and, given next_step_dp, the next tracer step's stage-0
    prep.  Qt and pre_minmax0 may be handed over as one-element lists
    (_take); the stages hand their outputs and bounds on the same way, so
    each is freed at its last use.
    Returns (Qt', next_minmax-or-None)."""
    Qt = _take(Qt)           # the input, kept for the time average
    dt2 = dt_q / 2.0
    dp0_t, dp1_t, dp2_t = dps
    # each stage's output, bounds and bound prep, handed to the next stage;
    # stage 0 takes fresh neighbour bounds and starts from none
    box, mn, mx, pre = [None], [None], [None], [None]
    box[0], mn[0], mx[0], nb = euler_step_t(
        m, Qt, mn, mx, divdp_t, dp0_t, uv_t, dt2, 0,
        pre_minmax=pre_minmax0, next_dp=dp1_t, plain=plain)
    pre[0], nb = nb and nb[0], None
    box[0], mn[0], mx[0], nb = euler_step_t(
        m, box, mn, mx, divdp_t, dp1_t, uv_t, dt2, 1,
        pre_minmax=pre, next_dp=dp2_t, next_lap=m.cfg.nu_q > 0,
        plain=plain)
    pre[0], lap = (None, [None]) if nb is None else (nb[0], [nb[1]])
    nb = None
    Qt3, _, _, nb = euler_step_t(
        m, box, mn, mx, divdp_t, dp2_t, uv_t, dt2, 2,
        pre_minmax=pre, pre_lap=lap, avg_t=Qt, next_dp=next_step_dp,
        plain=plain)
    return Qt3, None if nb is None else nb[0]


def stage_dps(m: Model, dp0_t, divdp_proj_t, dt_q):
    """The three stages' thicknesses of a tracer step, dp0 - rhs_multiplier
    * dt_q/2 * divdp_proj: (dp0_t itself, dp1, dp2) [E,16,k].  dp1 and dp2
    broadcast dp0 from its column (k values read, not dp0_t's E*16*k)."""
    dt2 = dt_q / 2.0
    dp0 = m.dp0col[None, None, :]
    return (dp0_t, dp0 - 1.0 * dt2 * divdp_proj_t,
            dp0 - 2.0 * dt2 * divdp_proj_t)


def remap_levels_t(m: Model, divdp_proj_t, dt_remap, plain=False):
    """The remap's tracer-independent part: (dp_star, dp_ref [E,16,k],
    ps_v [E,4,4], min_dp), the Lagrangian and the reference widths, the
    surface pressure and the health check (prim_advection_mod.F90:1242-1330):
    min_dp < 0 signals a negative layer thickness (reference abort :1323)
    or, with ppm_search="fast", a displacement outside the remap's -2..+2
    cell window (the health kernel, remap_health_t)."""
    E = divdp_proj_t.shape[0]
    with span("remap.levels"):
        dp_star = m.dp0col[None, None, :] - dt_remap * divdp_proj_t
        ps_v = m.hyai[0] * P0 + dp_star.sum(dim=2)
        dp_ref = ((m.hyai[1:] - m.hyai[:-1])[None, None, :] * P0
                  + (m.hybi[1:] - m.hybi[:-1])[None, None, :]
                  * ps_v[..., None])
    with span("remap.health"):
        if m.cfg.ppm_search == "general":
            # the unbounded search: the window guard is advisory, only the
            # thickness counts
            min_dp = m.tables.global_min(dp_star.min())
        else:
            health = remap_health_t_plain if plain else remap_health_t
            min_dp = m.tables.global_min(health(dp_star, dp_ref))
    return dp_star, dp_ref, ps_v.reshape(E, 4, 4), min_dp


def remap_lanes_t(m: Model, Qt, dp_star, dp_ref, plain=False):
    """The remap of the lanes of Qt [E,16,q*k] (q = m.cfg.qsize) from
    dp_star to dp_ref (remap_levels_t) -> Qt'."""
    cfg = m.cfg
    with span("remap.ppm"):
        if cfg.ppm_search == "general":
            # the unbounded search (plain PyTorch, as the JAX package's XLA
            # path)
            E = Qt.shape[0]
            Qcol = Qt.reshape(E, 16, cfg.qsize, cfg.nlev)
            # element chunks bound the search's [.., k, k+2] working set
            nc = next((c for c in (8, 4, 2) if E % c == 0), 1)
            ec = E // nc
            return torch.cat([
                remap_q_ppm_general(Qcol[i:i + ec], dp_star[i:i + ec],
                                    dp_ref[i:i + ec],
                                    alg=cfg.vert_remap_q_alg)
                for i in range(0, E, ec)]).reshape(Qt.shape)
        remap = _kernels(plain)[2]
        return remap(Qt, dp_star, dp_ref, alg=cfg.vert_remap_q_alg)


# ---------------------------------------------------------------------------
# the remap-interval step (prim_run_subcycle)
# ---------------------------------------------------------------------------

# the Model's element-indexed arrays, which a shard holds its slice of
ELEM_FIELDS = ("lon", "lat", "D", "Dinv", "metdet", "rmetdet", "spheremp",
               "rspheremp", "met")


def shard_model(m: Model, elems: torch.Tensor, tables) -> Model:
    """The model of one shard: the element-indexed arrays at `elems`
    (int64 element ids on the model's device, in the shard's order) and
    the shard's DSS tables (parallel/halo.py ShardedDssTables)."""
    return dataclasses.replace(
        m, tables=tables,
        **{k: getattr(m, k).index_select(0, elems) for k in ELEM_FIELDS})


def check_config(cfg) -> None:
    """Raise TypeError unless cfg is the port's own Config."""
    if not isinstance(cfg, Config):
        raise TypeError(f"expected transport_se_tpu_torch.config.Config, got "
                        f"{type(cfg).__module__}.{type(cfg).__qualname__}")


def check_ported(cfg: Config) -> None:
    """Raise NotImplementedError for what the port does not run."""
    check_config(cfg)
    if cfg.rhs_bf16:
        raise NotImplementedError("rhs_bf16 (bf16 advection matmuls, a TPU "
                                  "perf knob) is not ported")


def uses_t_layout(cfg: Config, diagnostics: bool = False) -> bool:
    """Whether make_subcycle_fn runs the T-layout pipeline (JAX
    core.py:613, driver.py:80): use_pallas with limiter 8 and no
    diagnostics piggyback."""
    return cfg.use_pallas and cfg.limiter_option == 8 and not diagnostics


# The T subcycle's memory plans.  One group: the state handed over, a
# subcycle holds at most STATES state-sized buffers and BOUNDS [E, q*k]
# limiter-bound arrays at any kernel launch (tests/test_torch_memory.py).
# Groups of tracers (where that does not fit the device): the state, and
# for the group in flight STATES group-sized buffers and BOUNDS group-sized
# bound arrays.  Beside them a plan holds level-width fields [E, 16, k]
# (winds, thicknesses, the remap's widths): at most LEVEL_FIELDS of them
# at a launch, as counted in tests/test_torch_memory.py, with a margin.
STATES = 4
BOUNDS = 4
LEVEL_FIELDS = {"one": 10, "groups": 22}
# the share of the device's total memory a subcycle's modelled peak may take
MEMORY_SHARE = 0.9


def subcycle_bytes(E, qsize, nlev, itemsize, widths, held=0):
    """The modelled peak bytes of a T subcycle of qsize tracers on E
    elements run in groups of `widths` tracers ([qsize]: one group), the
    state handed over; held: the bytes the model and the wind basis hold
    (held_bytes)."""
    tracer = E * 16 * nlev * itemsize      # one tracer's lanes, = one level
    bound = E * nlev * itemsize            # field; one tracer's bound array
    g = max(widths)
    if len(widths) == 1:
        return held + (STATES * tracer + BOUNDS * bound) * qsize \
            + LEVEL_FIELDS["one"] * tracer
    return held + tracer * qsize + (STATES * tracer + BOUNDS * bound) * g \
        + LEVEL_FIELDS["groups"] * tracer


def plan_groups(E, qsize, nlev, itemsize, total, held=0):
    """The group widths of a T subcycle on a device of `total` bytes: one
    group where its modelled peak (subcycle_bytes) fits MEMORY_SHARE of
    the total, else the fewest groups that fit, as even as they split."""
    budget = MEMORY_SHARE * total
    for n in range(1, qsize + 1):
        widths = [qsize // n + (i < qsize % n) for i in range(n)]
        if subcycle_bytes(E, qsize, nlev, itemsize, widths, held) <= budget:
            return widths
    raise ValueError(
        f"no group plan of {qsize} tracers on {E} elements x {nlev} levels "
        f"fits {budget / 2**30:.2f} GiB")


def held_bytes(*objs) -> int:
    """The bytes of the distinct tensor storages that objs hold in their
    fields, three levels down (a Model, its DSS tables and their face
    tables; a wind basis)."""
    seen = {}

    def walk(o, depth):
        if isinstance(o, torch.Tensor):
            st = o.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        elif depth and hasattr(o, "__dict__"):
            for v in vars(o).values():
                walk(v, depth - 1)
    for o in objs:
        walk(o, 3)
    return sum(seen.values())


def make_subcycle_fn(m: Model, diagnostics: bool = False,
                     io_layout: str = "std", plain: bool = False,
                     groups=None):
    """Returns fn(Qdp, nstep) -> (Qdp', ps_v, nstep', min_dp).  Qdp may be
    handed over as a one-element list, which fn empties (_take): its
    stages then free every state-sized buffer at its last use, so that a
    face T subcycle holds at most four of them at any kernel launch
    (tests/test_torch_memory.py); a tensor stays alive in its caller.

    On the T-layout pipeline the subcycle advances its tracers in groups:
    plan_groups chooses the widths once, here, from the device's total
    memory, one group wherever four states fit (always on the CPU).
    groups: widths that sum to qsize, to force a plan (any device; tests).
    One group runs on the state itself.  A plan of several gathers each
    group's lanes into a group buffer (`ops/lanes.py`), runs the tracer
    steps and the remap on it and scatters the result back: into the
    handed-over state, in place, or into a new state where the caller
    keeps its tensor.  The winds, the stages' thicknesses and the remap's
    widths and health check are made once a subcycle, before the groups.

    One call advances cfg.rsplit tracer steps and performs one vertical
    remap (prim_driver_mod.F90:788-796); nstep counts tracer steps.  The
    pipeline is chosen as the JAX package chooses it: the T layout for
    use_pallas with limiter 8 and diagnostics off, else the std layout.
    io_layout="std" passes the state as Qdp [E,q,k,n,n]; io_layout="t"
    passes it as [E,16,q*k] and needs the T-layout pipeline (ValueError
    otherwise).  diagnostics=True DSSes eta_dot and omega along the stages
    (the reference's piggyback diagnostics).  plain=True runs the plain
    PyTorch versions of every kernel on any device: a test-only switch for
    holding the kernels against them on the card."""
    check_ported(m.cfg)
    if io_layout not in ("std", "t"):
        raise ValueError(f"io_layout {io_layout!r} not in ('std', 't')")
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

    def t_wind_of(nstep):
        # prescribed wind with the reference's one-step evaluation lag (a
        # device fill, not a host copy: no stream synchronisation)
        return torch.full((), float(max(nstep - 1, 0)), dtype=m.dtype,
                          device=m.device) * dt

    if not uses_t_layout(cfg, diagnostics):
        if io_layout == "t":
            raise ValueError(
                "io_layout='t' needs the T-layout pipeline (use_pallas=True, "
                "limiter_option=8, diagnostics off)")

        def step(Qdp, nstep: int):
            # the T subcycle's spans: `subcycle` > 3 `tracer_step` >
            # (`wind`, 3 `stage`, and outside both the step's divergence
            # and time average), then `remap`
            Qdp = _take(Qdp)
            with span("subcycle"):
                divdp_proj = None
                for _ in range(cfg.rsplit):
                    with span("tracer_step"):
                        with span("wind"):
                            t_wind = t_wind_of(nstep)
                            v = dcmip.winds(cfg.test_case, m.lon, m.lat,
                                            m.etam, t_wind)
                            vn0 = v * m.dp0col[None, :, None, None, None]
                            if cfg.qsplit != 1:
                                vn0 = vn0 * ur_w[nstep % cfg.qsplit]
                            eta = omg = None
                            if diagnostics:
                                eta = dcmip.eta_dot_dpdn(
                                    cfg.test_case, m.lon, m.lat, m.etai,
                                    t_wind)[:, :cfg.nlev]
                                # omega_p = (-g rho w)/p at midpoints
                                # (dcmip_wrapper:253,197)
                                omg = dcmip.eta_dot_dpdn(
                                    cfg.test_case, m.lon, m.lat, m.etam,
                                    t_wind) / (P0 * m.etam[None, :, None,
                                                           None])
                        Qdp, divdp_proj, _, _ = advect_rk2(
                            m, Qdp, vn0, dt_q, eta, omg, plain=plain)
                    nstep = nstep + 1
                with span("remap"):
                    box, Qdp = [Qdp], None
                    Qdp, ps_v, min_dp = vertical_remap(
                        m, box, divdp_proj, dt_remap, plain=plain)
                return Qdp, ps_v, nstep, min_dp

        return step

    from .wind_basis import build_wind_basis
    wb = build_wind_basis(m, plain=plain)
    E = m.lon.shape[0]
    nk = cfg.nlev
    if groups is None:
        groups = [cfg.qsize]
        if m.device.type == "cuda":
            total = torch.cuda.get_device_properties(m.device).total_memory
            groups = plan_groups(E, cfg.qsize, nk, m.lon.element_size(),
                                 total, held=held_bytes(m, wb))
    groups = [int(g) for g in groups]
    if sum(groups) != cfg.qsize or min(groups) < 1:
        raise ValueError(f"groups {groups} do not split the "
                         f"{cfg.qsize} tracers")
    # each width's model: the stages read the tracer count from cfg
    models = {g: dataclasses.replace(
        m, cfg=dataclasses.replace(cfg, qsize=g)) for g in set(groups)}
    one = len(groups) == 1

    def run_t(Qt, nstep: int):
        # a one-element list hands the state over; a tensor stays the
        # caller's, unchanged
        handed = isinstance(Qt, list)
        X = _take(Qt)
        del Qt
        with span("subcycle"):
            out = None if one else X if handed else torch.empty_like(X)
            # contiguous: stage 0's thickness, and the next step's stage-0
            # dp of the bound-prep kernels
            dp0_t = m.dp0col[None, None, :].expand(E, 16, nk).contiguous()

            def tracer_independent():
                """Each step's winds ((un0, vn0), divdp) [E,16,k] and stage
                thicknesses, then the remap's (dp_star, dp_ref, ps_v,
                min_dp)."""
                for n in range(nstep, nstep + cfg.rsplit):
                    with span("wind"):
                        un0_t, vn0_t, divdp_t, proj_t = wb.eval(t_wind_of(n))
                        if cfg.qsplit != 1:
                            w = ur_w[n % cfg.qsplit]
                            un0_t, vn0_t = un0_t * w, vn0_t * w
                            divdp_t, proj_t = divdp_t * w, proj_t * w
                    yield (un0_t, vn0_t), divdp_t, stage_dps(m, dp0_t, proj_t,
                                                             dt_q)
                    del un0_t, vn0_t, divdp_t
                levels = remap_levels_t(m, proj_t, dt_remap, plain=plain)
                del proj_t
                yield levels

            work = tracer_independent()
            if not one:
                # several groups keep this work for all of them, so it is
                # made before the first group's buffers: made between them,
                # its fields take pieces of the group-sized blocks the
                # caching allocator hands from stage to stage (5.8 GiB more
                # reserved at NE120 f64).  One group makes each part where
                # it is used.
                steps = [next(work) for _ in range(cfg.rsplit)]
                with span("remap"):
                    levels = next(work)
            lo = 0
            for g in groups:
                mg = models[g]
                if one:
                    box, X = [X], None
                else:
                    with span("lanes.gather"):
                        box = [lane_gather(X, lo * nk, g * nk)]
                # a step's stage-0 bound prep, from the step before
                mm0 = [None]
                for i in range(cfg.rsplit):
                    with span("tracer_step"):
                        uv_t, divdp_t, dps = next(work) if one else steps[i]
                        # step i's stage-3 output bounds over dp0 are step
                        # i+1's stage-0 prep
                        nd = dp0_t if i < cfg.rsplit - 1 else None
                        box[0], mm0[0] = advect_rk2_t_parts(
                            mg, box, uv_t, divdp_t, dps, dt_q,
                            pre_minmax0=mm0, next_step_dp=nd, plain=plain)
                        del uv_t, divdp_t, dps
                with span("remap"):
                    if one:
                        levels = next(work)
                    dp_star, dp_ref, ps_v, min_dp = levels
                    Qg = remap_lanes_t(mg, _take(box), dp_star, dp_ref,
                                       plain=plain)
                if one:
                    return Qg, ps_v, nstep + cfg.rsplit, min_dp
                with span("lanes.scatter"):
                    lane_scatter(Qg, out, lo * nk)
                del Qg
                lo += g
            return out, ps_v, nstep + cfg.rsplit, min_dp

    # the plan's group widths, for its callers to report
    run_t.groups = groups
    if io_layout == "t":
        return run_t

    def step_t(Qdp, nstep: int):
        Qdp = _take(Qdp)
        shape = Qdp.shape
        box = [_tp(Qdp, shape[0], cfg.qsize * cfg.nlev)]
        del Qdp
        Qt, ps_v, nstep, min_dp = run_t(box, nstep)
        return _tp_back(Qt, shape), ps_v, nstep, min_dp

    step_t.groups = run_t.groups
    return step_t
