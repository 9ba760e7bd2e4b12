"""Conservation gate of the f32 production path.

The port's counterpart of `scripts/audit_drift.py`: runs the perf
configuration `perf_config(ne, dtype="f32", use_pallas=True)` (35 tracers,
72 levels, face DSS, the limiter capped at 4 iterations) over the DCMIP 1-1
horizon through the T-layout subcycle and holds the per-tracer relative
mass drift, the spheremp-weighted sum of each tracer's mass, to 2e-4 (the
f32 path's assembly-order roundoff level; reference check: the "Q, Q diss"
conservation column, README:38-44).

Usage:
    python -m transport_se_tpu_torch.audit_drift [--ne 8] [--days 12]
        [--device cuda|cpu]

A size that perf_config has no settings for (below NE8) takes NE8's tstep
and nu_q.  Exits 0 when the gate passes, 1 when it fails, 2 when --device
cuda (the default) has no CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from .main import pick_device

GATE = 2e-4
PERF_NE = (8, 30, 42, 120)      # the sizes perf_config has settings for


def run_config(ne, days):
    """(Config, subcycles) of a run of `days` at `ne`, as
    scripts/audit_drift.py sets them."""
    from .config import perf_config
    cfg = perf_config(ne if ne in PERF_NE else 8, dtype="f32",
                      use_pallas=True)
    if cfg.ne != ne:
        cfg = dataclasses.replace(cfg, ne=ne)
    return cfg, int(days * 86400.0 / cfg.tstep) // cfg.rsplit


def main(argv=None) -> dict:
    """Run and print; returns config, ne, subcycles, cap (limiter_iter_cap),
    mass0 and mass1 (the masses of each tracer and level before and after
    the run, [qsize, nlev] numpy), drift (per-tracer relative mass drift),
    max, median, wall (s), min_dp (the least over the subcycles), ok and
    device."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ne", type=int, default=8)
    p.add_argument("--days", type=float, default=12.0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    picked = pick_device(args.device)
    if picked is None:
        raise SystemExit(2)
    device, name = picked

    import numpy as np
    import torch

    from .model.core import _tp, build_model, initial_qdp, make_subcycle_fn

    cfg, nsub = run_config(args.ne, args.days)
    m = build_model(cfg, device)
    E = m.lon.shape[0]
    qk = cfg.qsize * cfg.nlev
    step = make_subcycle_fn(m, diagnostics=False, io_layout="t")
    Qdp = _tp(initial_qdp(m), E, qk)
    sp = m.spheremp.reshape(E, 16, 1)

    def mass(Q):
        # summed in the state's f32, as scripts/audit_drift.py sums it
        return (Q * sp).sum(dim=(0, 1)).double().cpu().numpy() \
            .reshape(cfg.qsize, cfg.nlev)

    step(Qdp, 0)                          # builds the kernels
    mass0 = mass(Qdp)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    Q, nstep, worst = Qdp, 0, None
    for _ in range(nsub):
        Q, _, nstep, mindp = step(Q, nstep)
        worst = mindp if worst is None else torch.minimum(worst, mindp)
    mass1 = mass(Q)
    wall = time.perf_counter() - t0
    min_dp = float(worst) if worst is not None else float("inf")
    if min_dp < 0.0:
        raise RuntimeError("health check tripped (negative dp / window)")
    m0, m1 = mass0.sum(axis=1), mass1.sum(axis=1)
    drift = np.abs(m1 - m0) / np.abs(m0)
    print(f"default f32 path: ne={cfg.ne} days={nsub * cfg.dt_remap / 86400:g}"
          f" subcycles={nsub} (limiter_iter_cap={cfg.limiter_iter_cap}) on "
          f"{name}")
    print(f"per-tracer relative mass drift: max {drift.max():.3e} "
          f"median {np.median(drift):.3e}   wall {wall:.1f}s")
    ok = bool(drift.max() < GATE)
    print(f"DRIFT GATE ({GATE:.0e})", "PASS" if ok else "FAIL")
    return dict(config=cfg, ne=cfg.ne, subcycles=nsub, cap=cfg.limiter_iter_cap,
                mass0=mass0, mass1=mass1, drift=drift, max=float(drift.max()),
                median=float(np.median(drift)), wall=wall, min_dp=min_dp,
                ok=ok, device=name)


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
