"""Entry points of the repository's `__graft_entry__.py`, for the port: a
one-device step and a multi-shard dry run.

* `entry(device)`: one remap-interval step of the flagship configuration
  (NE8 DCMIP 1-1, 4 tracers, 72 levels, limiter 8, hyperviscosity, f32)
  and its example arguments.
* `dryrun_multichip(n_shards, device)`: the sharded subcycle over
  `ThreadComm(n_shards)` (the shards as threads on one device) on a small
  grid, twice:
  1. the production pipeline, the T layout with the face DSS (K1, K3, K5,
     K7) and the face+overlap composition forced on (each stage's producer
     runs once more on the boundary group, whose output is the halo
     payload), in f64, mass drift below 1e-12, every shard's boundary group
     neither empty nor the whole shard;
  2. the gather pipeline with overlap forced on (the automatic choice
     leaves it off): the boundary-first element order with 0 < nbound <
     eloc, each stage as K1 on the boundary group and K1 on the interior
     (twice the launches of one device), in f32, mass drift below 1e-5.
  Any failed check raises AssertionError.  The grid is the smallest ne >= 6
  whose 6 ne^2 elements split evenly into shards of at least 2 ne elements
  (ne 6 at 8 shards), with 16 levels and 3 tracers.

Usage:
    python -m transport_se_tpu_torch.dryrun [--shards 8] [--device cuda|cpu]

--device defaults to cuda and exits 2 where there is no CUDA device; the
CPU runs only when asked for.  Prints one summary line.
"""

from __future__ import annotations

import argparse
import sys

from .main import pick_device

DRIFT_TOL = {"f64": 1e-12, "f32": 1e-5}


def entry(device):
    """(step, (Qdp, nstep)): step(Qdp, nstep) -> (Qdp', ps_v, nstep',
    min_dp) advances one remap interval of NE8 DCMIP 1-1 (4 tracers, 72
    levels, limiter 8, nu_q 6e16, f32) from Qdp [E, 4, 72, 4, 4]."""
    from .config import Config
    from .model.core import build_model, initial_qdp, make_subcycle_fn
    cfg = Config(ne=8, nlev=72, qsize=4, tstep=400.0, test_case="dcmip1-1",
                 nu_q=6e16, nmax=3, dtype="f32")
    m = build_model(cfg, device)
    return make_subcycle_fn(m), (initial_qdp(m), 0)


def dryrun_ne(n_shards: int) -> int:
    """The smallest ne >= 6 with 6 ne^2 % n_shards == 0 and at least 2 ne
    elements a shard (ne >= 6 gives every shard interior elements in the
    boundary-first order)."""
    ne = 6
    while (6 * ne * ne) % n_shards or (6 * ne * ne) // n_shards < 2 * ne:
        ne += 1
    return ne


def _run(cfg, n_shards, device, overlap):
    """One sharded subcycle from initial_qdp -> (runner, the gathered
    std-layout Qdp, max relative tracer-mass drift, min_dp, launches
    {counter: n} of the kernels and plain versions)."""
    import torch

    from . import counters
    from .model.core import build_model, initial_qdp
    from .parallel.comm import ThreadComm
    from .parallel.sharded import make_sharded_subcycle
    m = build_model(cfg, device)
    runner = make_sharded_subcycle(m, ThreadComm(n_shards), overlap=overlap)
    Q0 = initial_qdp(m)
    sp = m.spheremp.double()[:, None, None]

    def mass(Q):
        return (Q.double() * sp).sum(dim=(0, 2, 3, 4))
    counters.reset()
    states, _, nstep, min_dp = runner.step(runner.shard_qdp(Q0), 0)
    Q1 = runner.gather(states)
    launches = {k: n for k, n in counters.snapshot().items() if n}
    m0 = mass(Q0)
    drift = ((mass(Q1) - m0).abs() / m0.abs()).max().item()
    assert nstep == cfg.rsplit, f"nstep {nstep}"
    assert float(min_dp) > 0, "negative layer thickness in dry run"
    assert bool(torch.isfinite(Q1).all()), "non-finite state in dry run"
    assert drift < DRIFT_TOL[cfg.dtype], (
        f"mass drift {drift} (tol {DRIFT_TOL[cfg.dtype]})")
    return runner, Q1, drift, float(min_dp), launches


def _k1(launches):
    """K1's launches: the kernel's on a card, its plain version's on the
    CPU."""
    return launches.get("fused_advect_limit", 0) \
        + launches.get("fused_advect_limit_plain", 0)


def dryrun_multichip(n_shards: int, device) -> dict:
    """Both cases (module docstring); prints the summary line and returns
    its figures: ne, n_shards, nrounds, eloc, face (drift, group sizes per
    shard, min_dp, launches, cfg, state), gather (drift, nbound, min_dp,
    launches, cfg, state); launches are the case's {counter: n} (the
    `counters` module's), state the gathered std-layout Qdp after one
    subcycle from `initial_qdp` of cfg, for a one-device reference."""
    from .config import Config
    ne = dryrun_ne(n_shards)
    base = dict(ne=ne, nlev=16, qsize=3, tstep=1200.0, vcoord="dcmip16",
                test_case="dcmip1-1", nu_q=6e16, nmax=3, use_pallas=True)

    # 1. the production face-DSS pipeline, f64, the face+overlap
    # composition forced on (at this size the automatic choice would turn
    # it off: the group is over a quarter of the shard)
    r1, Q1, d1, md1, la1 = _run(Config(dtype="f64", dss_mode="face",
                                       elem_order="raster", **base),
                                n_shards, device, overlap=True)
    plan1 = r1.plan
    assert r1.overlap_face, "face+overlap composition is off"
    assert plan1.nbound == 0, "raster order was reordered"
    nbv = plan1.bmask.sum(axis=1)
    assert 0 < nbv.min() and nbv.max() < plan1.eloc, (
        f"degenerate face boundary group: {nbv} vs eloc={plan1.eloc}")
    stages = 3 * r1.model.cfg.rsplit     # K1's stages a subcycle
    assert _k1(la1) == 2 * stages * n_shards, f"face launches {la1}"

    # 2. the gather pipeline with overlap forced on (the automatic choice
    # leaves it off): a real boundary/interior split
    cfg2 = Config(dtype="f32", **base)
    r2, Q2, d2, md2, la2 = _run(cfg2, n_shards, device, overlap=True)
    nb, el = r2.plan.nbound, r2.plan.eloc
    assert 0 < nb < el, f"degenerate overlap split: nbound={nb}, eloc={el}"
    assert _k1(la2) == 2 * stages * n_shards, f"gather launches {la2}"

    print(f"dryrun_multichip OK: ne={ne}, {n_shards} shards, "
          f"{plan1.nrounds} halo rounds | face-DSS f64 pipeline drift "
          f"{d1:.2e} (overlap group {int(nbv.min())}-{int(nbv.max())} of "
          f"eloc={plan1.eloc}) | gather overlap nbound={nb} < eloc={el}, "
          f"f32 drift {d2:.2e}", flush=True)
    return dict(ne=ne, n_shards=n_shards, nrounds=plan1.nrounds,
                eloc=plan1.eloc,
                face=dict(drift=d1, group=[int(n) for n in nbv],
                          min_dp=md1, launches=la1, cfg=r1.model.cfg,
                          state=Q1),
                gather=dict(drift=d2, nbound=nb, min_dp=md2, launches=la2,
                            cfg=cfg2, state=Q2))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    picked = pick_device(args.device)
    if picked is None:
        return 2
    dryrun_multichip(args.shards, picked[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
