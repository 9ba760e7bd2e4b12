"""Simulation driver: the prim_main / prim_run_subcycle loop.

Port of `transport_se_tpu/model/driver.py:45-186` (reference:
src/prim_main.F90:142-175 main loop; prim_driver_mod.F90:701
`prim_run_subcycle`).  The subcycle pipeline is chosen as the JAX driver
chooses it: the T layout [E, 16, q*k] for use_pallas with limiter 8 (the
state stays in the kernels' layout between subcycles and is transposed
only at diagnostic and output points), else the std layout
Qdp [E, q, k, n, n].  Around the subcycles run the printstate diagnostics
(`StateLog`), the history writer and the restart writer, on the JAX
driver's schedule.

One deliberate difference: the port checks the remap's health value
min_dp after every subcycle and raises at the first negative one; the
JAX driver checks it only on diagnosed subcycles.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..constants import P0

from ..diagnostics import StateLog, flow_fields, to_numpy, tracer_diagnostics
from ..timing import timers
from .core import (Model, _tp, _tp_back, build_model, check_ported,
                   initial_qdp, make_subcycle_fn, uses_t_layout)


@dataclasses.dataclass
class RunResult:
    model: Model
    q_init: torch.Tensor     # [E, q, k, n, n] mixing ratio at t=0
    q_final: torch.Tensor    # [E, q, k, n, n] mixing ratio at the end
    ps_final: torch.Tensor   # [E, n, n]
    state: torch.Tensor      # final tracer mass in the pipeline's layout:
                             # [E, 16, q*k] (T) or [E, q, k, n, n] (std)
    nsteps: int
    log: StateLog            # printstate masses/variances (diagnostics on)
    min_dp: list             # health value of each subcycle (> 0 is ok)
    wall_seconds: float


def reference_dp(m: Model, ps_v):
    return ((m.hyai[1:] - m.hyai[:-1])[None, :, None, None] * P0
            + (m.hybi[1:] - m.hybi[:-1])[None, :, None, None]
            * ps_v[:, None])


def run_simulation(cfg: Config, device, model: Optional[Model] = None,
                   verbose: bool = True, history=None, init_state=None,
                   restartfreq: int = 0, restart_writer=None) -> RunResult:
    """Run cfg.nsteps tracer steps on `device`.

    history: an `io.history.HistoryWriter`, which receives
    (model, nstep, Q, ps_v) as numpy at each output interval and at the
    end.  init_state = (Qdp [E,q,k,n,n], nstep0) resumes from a restart; the
    run continues to cfg.nsteps in all.  restart_writer(model, nstep, Qdp,
    ps_v) (numpy) is called every `restartfreq` steps.  Raises
    RuntimeError at the first subcycle whose health value min_dp is
    negative (negative layer thickness, or with ppm_search="fast" a
    displacement outside the remap's window), as the reference aborts
    (prim_advection_mod.F90:1323).
    """
    check_ported(cfg)
    m = model if model is not None else build_model(cfg, device)
    nsteps = cfg.nsteps
    if nsteps % cfg.rsplit != 0:
        raise ValueError(f"nsteps={nsteps} not divisible by rsplit")

    with timers.time("prim_init"):
        if init_state is not None:
            Qdp, nstep0 = init_state
            Qdp = torch.as_tensor(Qdp, dtype=m.dtype, device=m.device)
        else:
            Qdp = initial_qdp(m)
            nstep0 = 0
        q_init = Qdp / m.dp0col[None, None, :, None, None]
        std_shape = Qdp.shape
        use_t = uses_t_layout(cfg)
        if use_t:
            state = _tp(Qdp, std_shape[0], cfg.qsize * cfg.nlev)

            def to_std(x):
                return _tp_back(x, std_shape)
        else:
            state = Qdp.contiguous()

            def to_std(x):
                return x
        step = make_subcycle_fn(m, io_layout="t" if use_t else "std")
    if (nsteps - nstep0) % cfg.rsplit != 0:
        raise ValueError("remaining steps not divisible by rsplit")
    n_subcycles = (nsteps - nstep0) // cfg.rsplit
    if n_subcycles <= 0:
        raise ValueError(
            f"nothing to run: restart nstep={nstep0} >= nmax={nsteps} "
            "(increase nmax/ndays to continue this run)")

    log = StateLog()
    if not cfg.disable_diagnostics:
        mass, var, qmn, qmx = tracer_diagnostics(m, Qdp, q_init)
        log.record(0, mass, var, qmn, qmx, cfg.tstep, verbose)
    if history is not None and init_state is None:
        # the initial record; a restarted run's t=0 record is in the
        # original run's history
        extras0 = flow_fields(m, 0) if history.needs_extras() else None
        history.write(m, 0, to_numpy(q_init),
                      np.full((std_shape[0], 4, 4), P0), extras=extras0)

    del Qdp
    nstep = nstep0
    min_dps = []
    ps_v = None
    t0 = _time.perf_counter()
    for isub in range(n_subcycles):
        check = (not cfg.disable_diagnostics
                 and ((nstep + cfg.rsplit) % cfg.statefreq < cfg.rsplit
                      or isub == n_subcycles - 1))
        if check:
            # prim_diag_scalars sample at the subcycle's start (the RK2
            # path's half-times 1,4 coincide at n0 and 2,3 at np1)
            dp0 = (reference_dp(m, ps_v) if ps_v is not None
                   else m.dp0col[None, :, None, None])
            Qdp0v = to_std(state)
            mass0, var0, _, _ = tracer_diagnostics(m, Qdp0v,
                                                   Qdp0v / dp0[:, None])
        with timers.time("prim_run", sync=state):
            state, ps_v, nstep, min_dp = step(state, nstep)
        min_dps.append(float(min_dp))
        if min_dps[-1] < 0:
            raise RuntimeError(
                "negative layer thickness or PPM fast-path interface "
                "displacement > 2 cells at nstep "
                f"{nstep}: timestep or remap time too large")
        due = history is not None and (history.due(nstep, cfg)
                                       or isub == n_subcycles - 1)
        restart_due = (restart_writer is not None and restartfreq > 0
                       and nstep % restartfreq < cfg.rsplit)
        Qdp = (to_std(state) if check or due or restart_due
               or isub == n_subcycles - 1 else None)
        if check:
            dp_ref = reference_dp(m, ps_v)
            mass, var, qmn, qmx = tracer_diagnostics(m, Qdp,
                                                     Qdp / dp_ref[:, None])
            # printstate divides the subcycle difference by one tracer
            # step dt = tstep*qsplit (prim_state_mod.F90:157,381)
            log.record(nstep, mass, var, qmn, qmx, cfg.dt_tracer, verbose,
                       prev=(mass0, var0))
        # the reference always writes at the run end (nextoutputstep is
        # capped at nEndStep, common_movie_mod.F90:173)
        if due:
            extras = flow_fields(m, nstep) if history.needs_extras() else None
            history.write(m, nstep,
                          to_numpy(Qdp / reference_dp(m, ps_v)[:, None]),
                          to_numpy(ps_v), extras=extras)
        if restart_due:
            restart_writer(m, nstep, to_numpy(Qdp), to_numpy(ps_v))
    if state.is_cuda:
        torch.cuda.synchronize(state.device)
    wall = _time.perf_counter() - t0

    Qdp = to_std(state)
    q_final = Qdp / reference_dp(m, ps_v)[:, None]
    return RunResult(model=m, q_init=q_init, q_final=q_final,
                     ps_final=ps_v, state=state, nsteps=nsteps, log=log,
                     min_dp=min_dps, wall_seconds=wall)
