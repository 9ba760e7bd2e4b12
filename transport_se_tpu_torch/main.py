"""The main program: namelist -> run -> history/restart/timing output.

Port of `transport_se_tpu/main.py` (reference: src/prim_main.F90:5, the
main loop :142-175 with the movie and restart writes :163-174 and the
timer dump :188).  The namelist is the reference's (read by the port's copy
of the JAX package's `io/namelist.py`), and so are the history file
(`io/history.py`) and the restart file format.

Usage:
    python -m transport_se_tpu_torch.main namelist.nl [--device cuda|cpu]
        [--dtype f64|f32] [--quiet]
    python -m transport_se_tpu_torch.main < namelist.nl

--device defaults to cuda and fails where there is no CUDA device; the
run goes to the CPU only when --device cpu is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def pick_device(flag):
    """The device of a `--device cuda|cpu` flag, as (torch.device, name),
    for every entry point of the port: cuda is device 0 and needs a card;
    the CPU runs only when asked for.  Prints why and returns None where
    there is no CUDA device.  Turns TF32 off: float32 products in full
    precision, as the reference computes them."""
    import torch
    if flag == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda (the default) but "
              "torch.cuda.is_available() is false; pass --device cpu to run "
              "on the CPU", file=sys.stderr)
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if flag == "cuda":
        return torch.device("cuda", 0), torch.cuda.get_device_name(0)
    return torch.device("cpu"), "cpu"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("namelist", nargs="?", default=None,
                   help="namelist file (default: stdin)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--dtype", default="f64", choices=["f64", "f32"])
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    picked = pick_device(args.device)
    if picked is None:
        return 2
    device, name = picked

    from . import counters
    from .diagnostics import print_cfl, test_global_integral
    from .io import restart as restart_io
    from .io.history import HistoryWriter
    from .io.namelist import config_from_namelist
    from .model.core import build_model
    from .model.driver import run_simulation
    from .timing import timers

    if args.namelist:
        with open(args.namelist) as f:
            text = f.read()
        nl_dir = os.path.dirname(os.path.abspath(args.namelist))
    else:
        text = sys.stdin.read()
        nl_dir = os.getcwd()
    rs = config_from_namelist(text, nl_dir=nl_dir)
    cfg = dataclasses.replace(rs.cfg, dtype=args.dtype)
    print(f"transport_se_tpu_torch: ne={cfg.ne} nlev={cfg.nlev} "
          f"qsize={cfg.qsize} tstep={cfg.tstep} rsplit={cfg.rsplit} "
          f"test={cfg.test_case} nsteps={cfg.nsteps} device={device} "
          f"({name}) dtype={cfg.dtype}")

    m = build_model(cfg, device)

    # startup self-checks (prim_init2: test_global_integral :437, print_cfl
    # :673 — global_norms_mod.F90)
    area_err = test_global_integral(m)
    if area_err > 1e-10:
        raise RuntimeError(f"sphere area check failed: rel err {area_err:.2e}")
    print_cfl(m, cfg, verbose=not args.quiet)

    init_state = None
    if rs.runtype in (1, 2):
        state = restart_io.read_restart(rs.restartfile)
        Qdp, _, nstep0 = restart_io.resume(state, m, rs.runtype)
        init_state = (Qdp, nstep0)
        print(f"restart (runtype={rs.runtype}) from {rs.restartfile} "
              f"at nstep={nstep0}")

    history = None
    if rs.output_frequency > 0:
        os.makedirs(rs.output_dir, exist_ok=True)
        path = os.path.join(rs.output_dir, f"{cfg.test_case}1.nc")
        varnames = rs.output_varnames or ("ps", "Q", "u", "v", "geo")
        # tracer aliases: any 'Qn' request is covered by expanding 'Q'
        expanded = tuple(dict.fromkeys(
            "Q" if v.startswith("Q") else v for v in varnames))
        history = HistoryWriter(path, m, varnames=expanded,
                                output_frequency=rs.output_frequency,
                                output_timeunits=rs.output_timeunits)
        print(f"history output -> {path}")

    def restart_writer(model, nstep, Qdp, ps_v):
        restart_io.write_restart(rs.restartfile, model, Qdp, ps_v, nstep)
        print(f"wrote restart {rs.restartfile} at nstep={nstep}")

    counters.reset()
    result = run_simulation(
        cfg, device, model=m, verbose=not args.quiet, history=history,
        init_state=init_state, restartfreq=rs.restartfreq,
        restart_writer=restart_writer if rs.restartfreq > 0 else None)
    if history is not None:
        history.close()

    # timer dump (HommeTime_stats analog, prim_main.F90:188) and which
    # kernels (or plain versions) the run launched
    print(timers.report())
    print("launches: " + (", ".join(
        f"{k} {n}" for k, n in counters.snapshot().items() if n) or "none"))
    drift = result.log.max_relative_mass_drift() if result.log.masses else 0.0
    print(f"done: {result.nsteps} steps, wall {result.wall_seconds:.3f} s, "
          f"max relative tracer-mass drift {drift:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
