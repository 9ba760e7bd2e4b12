#!/usr/bin/env python3
"""Smoke run of transport_se_tpu_torch on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints one line or two; any failure exits non-zero before
the result lines):
  1. the card: name and power limit; TF32 off for matmuls and cuDNN
  2. build the CUDA kernels from csrc/ (one nvcc call, sm_90a)
  3. each kernel against its plain PyTorch version at NE30 shapes
     (E=5400, 35 tracers x 72 levels), f32 and f64, with times: K1-K3 and
     the face trio K4 (in the five variants the face path takes), K5, K6
  4. the main path, run_simulation(perf_config(30, f32)) in the production
     face DSS mode for 6 steps, then the same in gather mode (the path
     that runs K2): launch counts, min_dp, finiteness and tracer mass
  5. one NE30 face subcycle through the plain versions against the kernels
  6. one NE8 f64 subcycle in gather and one in face mode, kernels against
     plain versions
  7. five steady-state NE30 f32 subcycles timed with CUDA events, face
     mode, then gather mode for comparison
Then one JSON line of per-kernel results (the launches of K2 from the
gather run of phase 4, all others from the face run), the card line, and
as the last line {"ok": true, "device": {...}}.
"""

import json
import re
import statistics
import subprocess
import sys
import time

NE = 30
N_TIMED = 5          # timed repetitions (median) per kernel and for phase 7
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
}
KEY = {"fused_advect_limit": "K1", "laplace_wk_t": "K2",
       "remap_q_ppm_t": "K3", "dss_face": "K4", "minmax_prep": "K5",
       "neighbor_minmax": "K6"}
# 6 steps = 2 subcycles.  The face path runs 4 face DSS per step (stage 0
# and 1 with the next stage's bounds, stage 1 also with the first
# Laplacian, stage 2's hyperviscosity input, stage 2's output with the
# time average) plus one per DCMIP 1-1 wind term (6) when the subcycle
# function builds its wind basis; one bound prep per subcycle; neighbor
# min/max on stages 0 and 2; no weak-Laplacian launch.
FACE_COUNTS = {"fused_advect_limit": 18, "laplace_wk_t": 0,
               "remap_q_ppm_t": 2, "dss_face": 4 * 6 + 6, "minmax_prep": 2,
               "neighbor_minmax": 12}
GATHER_COUNTS = {"fused_advect_limit": 18, "laplace_wk_t": 6,
                 "remap_q_ppm_t": 2, "dss_face": 0, "minmax_prep": 0,
                 "neighbor_minmax": 0}


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
              "dss_face_kernel": ("avg", "minmax", "lap")}


def ptxas_usage(log_path):
    """'kernel<type> N regs, S B spill' per kernel from nvcc's -Xptxas -v."""
    if not log_path.exists():
        return ["no build log (library was cached)"]
    out, name = [], None
    for ln in log_path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"([a-z_]+_kernel)I([fd])((?:Lb[01]E)*)",
                          m.group(1))
            if k:
                on = [f for f, b in zip(FLAG_NAMES.get(k.group(1), ()),
                                        re.findall(r"Lb([01])", k.group(3)))
                      if b == "1"]
                name = (f"{k.group(1)}<"
                        + ",".join(["f32" if k.group(2) == "f" else "f64"]
                                   + on) + ">")
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


def rel_err(torch, got, want):
    """(max abs error, max abs error / max |want|), in f64."""
    d = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item()
    return d, d / scale if scale > 0 else d


def main():
    try:
        import torch
    except ImportError as e:
        fail(f"PyTorch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    try:
        from transport_se_tpu_torch import _build, counters
        from transport_se_tpu_torch.config import perf_config
        from transport_se_tpu_torch.model.core import (
            _tp, build_model, initial_qdp, make_subcycle_fn)
        from transport_se_tpu_torch.model.driver import run_simulation
        from transport_se_tpu_torch.model.wind_basis import build_wind_basis
        from transport_se_tpu_torch.ops import euler, remap
    except ImportError as e:
        fail(f"transport_se_tpu_torch is not importable ({e}): run this "
             "from the repository root")
    check("jax" not in sys.modules, "the port imported jax")
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
        cfg = perf_config(NE, dtype=dtype)
        m = build_model(cfg, dev)
        tb = m.tables
        E, nk, nq = m.lon.shape[0], cfg.nlev, cfg.qsize
        Qt, u, v, divdp, divp, mn, mx = stage_inputs(m)
        dt2 = cfg.dt_tracer / 2.0
        max_iter = cfg.limiter_iter_cap or euler.MAX_ITER
        rsp16 = m.rspheremp.reshape(E, 16)
        line = []
        errs = {}
        times = {k: ([], []) for k in KERNELS}

        def hold(name, kernel, plain, key):
            """Run kernel and plain on the same inputs, record the errors
            of every output and both times."""
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            if isinstance(want, torch.Tensor):
                got, want = (got,), (want,)
            errs[name] = [rel_err(torch, g, w) for g, w in zip(got, want)]
            del got, want
            times[key][0].append(timed(torch, kernel))
            times[key][1].append(timed(torch, plain))

        # K1, the three stage kinds: dp of stage s = dp0 - s*dt2*divdp_proj;
        # stage 2 adds the hyperviscosity of the DSS'd first Laplacian
        out0 = None
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
                 "fused_advect_limit")
            if s == 0:
                out0 = euler.fused_advect_limit(*args, **kw)[0]
        Q_t = (Qt.reshape(E, 16, nq, nk)
               / m.dp0col[None, None, None, :]).reshape(Qt.shape)
        hold("K2", lambda: euler.laplace_wk_t(Q_t, m.met, m.deriv),
             lambda: euler.laplace_wk_t_plain(Q_t, m.met, m.deriv),
             "laplace_wk_t")
        del Q_t
        dps = (m.dp0col[None, None, :] - cfg.dt_remap * divp).contiguous()
        ps = m.hyai[0] * 1e5 + dps.sum(dim=2)
        dpr = ((m.hyai[1:] - m.hyai[:-1])[None, None, :] * 1e5
               + (m.hybi[1:] - m.hybi[:-1])[None, None, :] * ps[..., None])
        for alg in (0, 2):
            hold(f"K3 alg{alg}",
                 lambda: remap.remap_q_ppm_t(Qt, dps, dpr, alg=alg),
                 lambda: remap.remap_q_ppm_t_plain(Qt, dps, dpr, alg=alg),
                 "remap_q_ppm_t")
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
                 "dss_face")
        hold("K5", lambda: tb.minmax_prep(out0, dp1, nq),
             lambda: tb.minmax_prep(out0, dp1, nq, plain=True),
             "minmax_prep")
        bmn, bmx = tb.minmax_prep(out0, dp1, nq)
        hold("K6", lambda: tb.neighbor_minmax(bmn, bmx),
             lambda: tb.neighbor_minmax(bmn, bmx, plain=True),
             "neighbor_minmax")
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
            if dtype == "f32":
                results[k] = dict(
                    max_abs_err=max(a for n, e in errs.items()
                                    if n.split()[0] == KEY[k] for a, _ in e),
                    ms=statistics.mean(tk), plain_ms=statistics.mean(tp))
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

    cfg = perf_config(NE, dtype="f32", nmax=6)
    check(cfg.dss_mode == "face" and cfg.elem_order == "raster",
          f"perf_config gives {cfg.dss_mode}/{cfg.elem_order}")
    E, nq, nk = m.lon.shape[0], cfg.qsize, cfg.nlev
    face_counts = main_path(m, cfg, FACE_COUNTS)
    cfg_g = perf_config(NE, dtype="f32", dss_mode="gather", nmax=6)
    m_g = build_model(cfg_g, dev)
    gather_counts = main_path(m_g, cfg_g, GATHER_COUNTS)
    launches = {k: (gather_counts if k == "laplace_wk_t" else face_counts)[k]
                for k in KERNELS}

    # ---- 5. one face subcycle through the plain versions -----------------
    Qt0 = _tp(initial_qdp(m), E, nq * nk)
    out_k = make_subcycle_fn(m)(Qt0, 0)[0]
    counters.reset()
    out_p = make_subcycle_fn(m, plain=True)(Qt0, 0)[0]
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
        cfg8 = perf_config(8, dtype="f64", dss_mode=mode)
        m8 = build_model(cfg8, dev)
        Q8 = _tp(initial_qdp(m8), m8.lon.shape[0], cfg8.qsize * cfg8.nlev)
        counters.reset()
        o_k, _, _, md_k = make_subcycle_fn(m8)(Q8, 0)
        kc = counters.snapshot()
        o_p, _, _, md_p = make_subcycle_fn(m8, plain=True)(Q8, 0)
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
        step = make_subcycle_fn(model)
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

    for mode, model in (("face", m), ("gather", m_g)):
        sub_ms, wall = steady(model)
        rate = N_TIMED * cfg.rsplit * E * 16 * nk * nq / wall
        say(f"phase 7 NE{NE} f32 {mode} steady state: {N_TIMED} subcycles, "
            f"per subcycle (CUDA events) median "
            f"{statistics.median(sub_ms):.2f} ms, min {min(sub_ms):.2f}, max "
            f"{max(sub_ms):.2f}; host wall {wall / N_TIMED * 1e3:.2f} "
            f"ms/subcycle; {rate:.4e} gridpoint-tracers/s "
            f"(steps*E*16*nlev*qsize/wall, information only) on {card}")

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
