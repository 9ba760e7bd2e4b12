"""End-to-end verification: run a DCMIP configuration through
`model/driver.py run_simulation` and compare its error norms with the
published reference numbers.

The port's counterpart of `scripts/verify.py`, with the same flags and the
same `Config`.  Unlike the CLI (`python -m transport_se_tpu_torch.main`,
whose namelist has no key for them) it runs the T-layout kernel pipeline
with --pallas: face DSS on raster order by default, and with limiter 8 the
fused stage K1, the PPM remap K3 and the face trio K4-K6 (the `launches:`
line says which kernels ran).

Usage:
    python -m transport_se_tpu_torch.verify --test dcmip1-1 --ne 8
        [--dtype f64|f32] [--days N] [--qsize N] [--tstep S] [--nu_q X]
        [--pallas] [--nlev N] [--dss gather|segsum|face] [--limcap N]
        [--device cuda|cpu]

--device defaults to cuda and fails where there is no CUDA device; the
run goes to the CPU only when --device cpu is given.  The published
norms printed beside a run's are PUBLISHED's.
"""

from __future__ import annotations

import argparse
import time

from .main import pick_device

# the published norms of the 72-level runs (72L, rsplit=3; reference
# README:94-96, 127-129; BASELINE.md), (test, ne) -> (L1, L2, Linf, q_max,
# q_min)
PUBLISHED = {
    ("dcmip1-1", 8): (0.578151, 0.865526, 0.883168, 0.187204,
                      -3.207090e-13),
    ("dcmip1-2", 8): (0.307665, 0.622099, 0.839133, 0.813105,
                      -9.385639e-06),
    ("dcmip1-1", 30): (0.490013, 0.789052, 0.918454, 0.445141,
                       -3.559994e-11),
    ("dcmip1-2", 30): (0.121783, 0.361005, 1.092784, 0.836177,
                       -3.671997e-05),
}


def parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--test", default="dcmip1-1",
                   choices=["dcmip1-1", "dcmip1-2"])
    p.add_argument("--ne", type=int, default=8)
    p.add_argument("--dtype", default="f64", choices=["f64", "f32"])
    p.add_argument("--days", type=float, default=None)
    p.add_argument("--qsize", type=int, default=4)
    p.add_argument("--tstep", type=float, default=None)
    p.add_argument("--nu_q", type=float, default=None)
    p.add_argument("--pallas", action="store_true",
                   help="run the T-layout kernel pipeline")
    p.add_argument("--nlev", type=int, default=72,
                   help="72 (acme72 vcoord) or a DCMIP uniform-z level "
                        "count (e.g. 64 for the README's 64L rows)")
    p.add_argument("--dss", default=None,
                   choices=["gather", "segsum", "face"],
                   help="DSS mode (default: face when --pallas, "
                        "else gather)")
    p.add_argument("--limcap", type=int, default=0,
                   help="limiter_iter_cap (f32 kernel-path perf knob; 0 = "
                        "the reference's full np*np-1 iteration)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def build_config(args):
    """The Config of the parsed flags, as scripts/verify.py builds it."""
    from .config import Config
    tstep = args.tstep or {8: 400.0, 30: 300.0, 120: 75.0}[args.ne]
    nu = args.nu_q if args.nu_q is not None else \
        {8: 6e16, 30: 1e15, 120: 1e13}[args.ne]
    days = args.days if args.days is not None else \
        (12.0 if args.test == "dcmip1-1" else 1.0)
    dss = args.dss or ("face" if args.pallas else "gather")
    vcoord = "acme72" if args.nlev == 72 else f"dcmip{args.nlev}"
    return Config(ne=args.ne, test_case=args.test, tstep=tstep, ndays=days,
                  qsize=args.qsize, nu_q=nu, dtype=args.dtype,
                  nlev=args.nlev, vcoord=vcoord, use_pallas=args.pallas,
                  dss_mode=dss,
                  elem_order="raster" if dss == "face" else "gilbert",
                  limiter_iter_cap=args.limcap,
                  statefreq=int(12 * 3600 / tstep) * 3)


def main(argv=None) -> dict:
    """Run and print; returns the run's figures: config, steps, subcycles,
    wall (s of stepping), drift (max relative tracer-mass drift), norms
    (norms.ErrorNorms), published (L1, L2, Linf, q_max, q_min, or None),
    launches ({counter: n}), min_dp (per subcycle) and device (its name).
    Exits with code 2 when --device cuda has no CUDA device."""
    args = parser().parse_args(argv)

    picked = pick_device(args.device)
    if picked is None:
        raise SystemExit(2)
    device, name = picked

    import numpy as np

    from . import counters
    from .constants import SCALE_HEIGHT
    from .diagnostics import to_numpy
    from .model.driver import run_simulation
    from .norms import dcmip_error_norms, grade_tracer, unique_columns
    from .timing import timers

    cfg = build_config(args)
    print(f"config: {cfg}")
    print(f"device: {device} ({name})")
    print(f"steps: {cfg.nsteps}  subcycles: {cfg.nsteps // cfg.rsplit}")

    counters.reset()
    t0 = time.time()
    res = run_simulation(cfg, device, verbose=True)
    launches = {k: n for k, n in counters.snapshot().items() if n}
    print(f"\nwall: {res.wall_seconds:.2f}s (total {time.time()-t0:.2f}s)")
    print(timers.report())
    print("launches: " + (", ".join(f"{k} {n}" for k, n in launches.items())
                          or "none"))
    drift = res.log.max_relative_mass_drift()
    print(f"max relative mass drift: {drift:.3e}")

    g = res.model.grid
    tr = grade_tracer(args.test)
    qi = unique_columns(g, to_numpy(res.q_init), tr)
    qf = unique_columns(g, to_numpy(res.q_final), tr)
    lat_col = g.lat.reshape(-1)[g.uniq_src]
    zm = SCALE_HEIGHT * np.log(1.0 / to_numpy(res.model.etam))
    norms = dcmip_error_norms(qi, qf, lat_col, zm, ne=args.ne)
    print(f"\nDCMIP {args.test} NE{args.ne}: {norms}")
    pub = PUBLISHED.get((args.test, args.ne)) if args.nlev == 72 else None
    if pub is not None:
        got = (norms.l1, norms.l2, norms.linf, norms.q_max)
        print("published: L1={:8.6f} L2={:8.6f} Linf={:8.6f} q_max={:8.6f} "
              "q_min={:14.6e}; relative difference L1/L2/Linf/q_max "
              .format(*pub) + "/".join(f"{(a - b) / b:+.2e}"
                                       for a, b in zip(got, pub)))
    return dict(config=cfg, steps=cfg.nsteps,
                subcycles=cfg.nsteps // cfg.rsplit, wall=res.wall_seconds,
                drift=drift, norms=norms, published=pub, launches=launches,
                min_dp=res.min_dp, device=name)


if __name__ == "__main__":
    main()
