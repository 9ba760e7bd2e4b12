"""Every CUDA kernel of the port launched once in every variant, each launch
followed by a synchronize, so that a memory checker (or a fault) names the
launch that went wrong.

    python -m transport_se_tpu_torch.kernel_check [--only K3] [--builds N]

from the repo root, on a CUDA device; under a checker, e.g.

    compute-sanitizer --tool memcheck python -m transport_se_tpu_torch.kernel_check
    compute-sanitizer --tool racecheck python -m transport_se_tpu_torch.kernel_check --only K3

It builds an NE8 face model in f32 and in f64 (perf_config), and launches
on each: K1 at its three stage kinds (without and with counting), K2, K3
at alg 0 and 2 (without and with counting, then at 9 and 8 tracers) with
the health kernel, K4 in its seven launch cases, K5,
K6, the wind kernel in its vector form (72 levels) and its scalar form (71
levels, one element), then one face subcycle; K7 in its four variants on
every shard of an S = 2 band shard set; K10 on the NE8 std path's stage
0; then one face subcycle of NE120's full production configuration
(perf_config(120, f32), 35 tracers x 72 levels: E*16*L = 3.48e9 values,
every offset of K1, K3, K4, K5 past 2^31; K6's tiles divide the face
evenly).  --only K3 launches K3
and the health kernel alone (both NE8 models).  --builds N first builds
the NE30 f32 face model, its wind basis (K4) and winds (the wind kernel),
its limiter bounds (K5, K6) and the remap's health check on its widths
(the health kernel) N times, each followed by a synchronize (run it with
CUDA_LAUNCH_BLOCKING=1 to stop at the launch that faults).  Prints one line
per launch group and "kernel_check: ok" at the end.
"""

from __future__ import annotations

import argparse

import torch

from . import counters
from .config import dcmip11_ne8, perf_config
from .k1_variants import stage_args
from .k3_variants import remap_args, tracers
from .k7_variants import halo_rows, shard
from .model import core
from .model.wind_basis import build_wind_basis
from .ops import band, dss_face, euler, limiter, remap, wind


def sync(what):
    torch.cuda.synchronize()
    print(f"  {what}: ok", flush=True)


def check_k3(dtype, dev, ne=8):
    args = remap_args(dtype, dev, ne=ne)
    for alg in (0, 2):
        remap.remap_q_ppm_t(*args, alg=alg)
        sync(f"{dtype} K3 alg {alg}")
        # the counting form, which K3 launches inside counters.counting()
        with counters.counting():
            remap.remap_q_ppm_t(*args, alg=alg)
        sync(f"{dtype} K3 alg {alg}, counting")
    # the f64 cell's tracer groups (9 and 8 tracers): other tiles
    for nq in (9, 8):
        remap.remap_q_ppm_t(*tracers(args, nq))
        sync(f"{dtype} K3 {nq} tracers")
    check_health(*args[1:], f"{dtype} NE{ne}")


def check_health(dps, dpr, what):
    """The health kernel on the widths, and on their first 5 elements (80
    columns: a full block of columns and a partial one)."""
    remap.remap_health_t(dps, dpr)
    remap.remap_health_t(dps[:5].contiguous(), dpr[:5].contiguous())
    sync(f"{what} health kernel, {dps.shape[0] * 16} and 80 columns")


def check_face(dtype, dev, ne=8):
    """K1-K6 and one face subcycle on the NE ne face model."""
    stages = stage_args(dtype, dev, ne=ne)
    for s, (args, kw) in enumerate(stages):
        out = euler.fused_advect_limit(*args, **kw)
        sync(f"{dtype} K1 stage {s}")
        # the counting form, which K1 launches inside counters.counting()
        with counters.counting():
            euler.fused_advect_limit(*args, **kw)
        sync(f"{dtype} K1 stage {s}, counting")
    x = out[0]
    cfg = perf_config(ne, dtype=dtype, use_pallas=True)
    m = core.build_model(cfg, dev)
    tb, E, nq, nk = m.tables, m.lon.shape[0], cfg.qsize, cfg.nlev
    rsp16 = m.rspheremp.reshape(E, 16)
    Q = (x.reshape(E, 16, nq, nk)
         / m.dp0col[None, None, None, :]).reshape(x.shape)
    euler.laplace_wk_t(Q, m.met, m.deriv)
    sync(f"{dtype} K2")
    check_k3(dtype, dev, ne)
    dp = stages[1][0][2]
    for name in dss_face.FACE_CASES:
        dss_face.dss_face(x, tb.face, **dss_face.face_case(
            name, rsp16, x, dp, m.met, m.deriv))
    sync(f"{dtype} K4 " + ", ".join(dss_face.FACE_CASES))
    mn, mx = tb.minmax_prep(x, dp, nq)
    sync(f"{dtype} K5")
    tb.neighbor_minmax(mn, mx)
    sync(f"{dtype} K6")
    wb = build_wind_basis(m)
    s_w = wb.time_values(torch.tensor(cfg.tstep, dtype=m.dtype, device=dev))
    for e_w, k_w in ((E, nk), (1, nk - 1)):
        bases = [a[:, :e_w].contiguous()
                 for a in (wb.u2d, wb.v2d, wb.g2d, wb.gp2d)]
        wind.wind_eval_t(*bases, s_w, wb.fk[:, :k_w].contiguous(),
                         wb.prof[:, :k_w].contiguous(),
                         wb.dp0[:k_w].contiguous())
    sync(f"{dtype} wind kernel, {E} elements x {nk} levels and 1 x {nk - 1}")
    Qt = core._tp(core.initial_qdp(m), E, nq * nk)
    counters.reset()
    core.make_subcycle_fn(m, io_layout="t")(Qt, 0)
    sync(f"{dtype} face subcycle, launches " + ", ".join(
        f"{k} {v}" for k, v in counters.snapshot().items() if v))
    return m, x, dp


def check_band(m, x, dp, S=2):
    """K7 in its four variants on every shard of S."""
    E, nq = m.lon.shape[0], m.cfg.qsize
    rsp16 = m.rspheremp.reshape(E, 16)
    for r in range(S):
        sl, hg, t = shard(m, S, r)
        ext = torch.cat([x[sl], halo_rows(x, hg)])
        for kw in ({}, dict(rsp=rsp16[sl]), dict(rsp=rsp16[sl], dp=dp[sl]),
                   dict(rsp=rsp16[sl], dp=dp[sl], lap=True)):
            band.dss_band(x[sl], ext, t, nq=nq, **kw)
        sync(f"{m.cfg.dtype} K7 shard {r} of {S}: raw, scale, +min/max, "
             "+min/max+lap")


def check_k10(dev):
    """K10 on the NE8 std path's stage 0 (DCMIP 1-1 winds at t = 0)."""
    m = core.build_model(dcmip11_ne8(), dev)
    c = m.cfg
    Qdp = core.initial_qdp(m)
    vn0 = core.dcmip.winds(c.test_case, m.lon, m.lat, m.etam, 0.0) \
        * m.dp0col[None, :, None, None, None]
    divdp = core.so.divergence_sphere(vn0, m.deriv, m.Dinv, m.metdet,
                                      m.rmetdet)
    zero = Qdp.new_zeros(Qdp.shape[:3])
    Qtens, qmn, qmx, dp_star = core.euler_stage_tens(
        m, Qdp, zero, zero, divdp, divdp, vn0, c.dt_tracer / 2.0, 0)
    limiter.limiter_optim_stage(*core.limiter_args(m, Qtens, dp_star), qmn,
                                qmx)
    sync(f"{c.dtype} K10 stage 0")


def check_ne120(dev):
    """One face subcycle of perf_config(120, f32), the state handed over
    (at most four states alive, ~60 GiB)."""
    cfg = perf_config(120, dtype="f32", use_pallas=True)
    m = core.build_model(cfg, dev)
    step = core.make_subcycle_fn(m, io_layout="t")
    box = [core.initial_qdp_t(m)]
    counters.reset()
    box[0], _, _, md = step(box, 0)
    sync(f"NE120 f32 face subcycle, {cfg.qsize} x {cfg.nlev} lanes, E*16*L "
         f"{box[0].numel()}, min_dp {float(md):.6g}, launches "
         + ", ".join(f"{k} {v}" for k, v in counters.snapshot().items()
                     if v))


def check_builds(n, dev, ne=30):
    """The NE ne f32 face model, its wind basis (K4) and winds (the wind
    kernel), its limiter bounds (K5, K6) and the remap's widths and health
    check (the health kernel), built n times."""
    for i in range(n):
        m = core.build_model(perf_config(ne, dtype="f32", use_pallas=True),
                             dev)
        E, nq, nk = m.lon.shape[0], m.cfg.qsize, m.cfg.nlev
        *_, divp = build_wind_basis(m).eval(
            torch.tensor(m.cfg.tstep, dtype=m.dtype, device=dev))
        Qt = core._tp(core.initial_qdp(m), E, nq * nk)
        dp0 = m.dp0col[None, None, :].expand(E, 16, nk).contiguous()
        m.tables.neighbor_minmax(*m.tables.minmax_prep(Qt, dp0, nq))
        core.remap_levels_t(m, divp, m.cfg.dt_remap)
        sync(f"NE{ne} f32 model build {i + 1} of {n}")
        del m, Qt, dp0, divp


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("K3",),
                    help="launch this kernel (and the health kernel) alone")
    ap.add_argument("--builds", type=int, default=0,
                    help="first build the NE30 f32 model this many times")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    check_builds(args.builds, dev)
    for dtype in ("f32", "f64"):
        if args.only == "K3":
            check_k3(dtype, dev)
            continue
        m, x, dp = check_face(dtype, dev)
        check_band(m, x, dp)
        del m, x, dp
    if args.only is None:
        check_k10(dev)
        check_ne120(dev)
    print("kernel_check: ok", flush=True)


if __name__ == "__main__":
    main()
