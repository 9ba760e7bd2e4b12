"""Checkpoint / restart with the reference's runtype semantics.

The port's own copy of `transport_se_tpu/io/restart.py`: the same file
format, `VERSION`, `RestartState`, writer, reader and compatibility check
(numpy only), so that either package reads the other's restart files
(tests/test_torch_host.py), and `resume` on torch tensors.

Equivalent of the reference restart stack (reference:
src/restart_io_mod.F90:524 `WriteRestart`, :563 `ReadRestart`, versioned
header :330-523; src/prim_restart_mod.F90:38-109 registers the prognostic
state; driver dispatch prim_driver_mod.F90:512-534:
  runtype 0 = initial run,
  runtype 1 = EXACT restart — resuming must be bit-identical, nstep
              continues,
  runtype 2 = branch — reads the state but resets counters and rebuilds
              Qdp from Q on the reference levels :629-669).

The prognostic state of the tracer-transport problem is {Qdp, ps_v, nstep}
(the reference's v/T/dp3d are re-derived every step from the analytic winds
under prescribed_wind=1, and Q = Qdp/dp).  Arrays are stored as raw float64
via numpy's npz container — bit-exact round trip — with a versioned header;
arrays are gathered to host in canonical element order first, so a run
restarted on a different shard count resumes from identical bits.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..constants import P0

__all__ = ["VERSION", "RestartState", "check_compatible", "read_restart",
           "resume", "write_restart"]

VERSION = 1


@dataclasses.dataclass
class RestartState:
    Qdp: np.ndarray      # [E, qsize, nlev, np, np] float64/float32
    ps_v: np.ndarray     # [E, np, np]
    nstep: int
    header: dict


def write_restart(path: str, model, Qdp, ps_v, nstep: int) -> None:
    """WriteRestart analog: versioned header + prognostic arrays."""
    cfg = model.cfg
    header = dict(version=VERSION, ne=cfg.ne, nlev=cfg.nlev,
                  qsize=cfg.qsize, nstep=int(nstep), tstep=cfg.tstep,
                  test_case=cfg.test_case, dtype=cfg.dtype,
                  rsplit=cfg.rsplit, qsplit=cfg.qsplit)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    # np.savez appends .npz to names without it; write to a temp name and
    # atomically rename so a crash never leaves a torn restart file
    tmp = path + ".tmp.npz"
    np.savez(tmp,
             header=np.frombuffer(
                 json.dumps(header).encode(), dtype=np.uint8),
             Qdp=np.asarray(Qdp), ps_v=np.asarray(ps_v))
    os.replace(tmp, path)


def read_restart(path: str) -> RestartState:
    with np.load(path) as z:
        header = json.loads(bytes(z["header"].tobytes()).decode())
        if header["version"] != VERSION:
            raise ValueError(f"restart version {header['version']} != "
                             f"{VERSION} (restart_io versioned-header check)")
        return RestartState(Qdp=z["Qdp"], ps_v=z["ps_v"],
                            nstep=header["nstep"], header=header)


def check_compatible(state: RestartState, cfg, exact: bool) -> None:
    """Exact restart (runtype=1) requires identical problem dimensions."""
    h = state.header
    for key in ("ne", "nlev", "qsize"):
        if h[key] != getattr(cfg, key):
            raise ValueError(f"restart {key}={h[key]} != config "
                             f"{getattr(cfg, key)}")
    if exact and h["tstep"] != cfg.tstep:
        raise ValueError("exact restart (runtype=1) with changed tstep")


def resume(state: RestartState, model, runtype: int):
    """Returns (Qdp [E,q,k,n,n], ps_v [E,n,n], nstep) on the model's
    device, per the runtype semantics."""
    check_compatible(state, model.cfg, exact=(runtype == 1))

    def t(a):
        return torch.as_tensor(a, dtype=model.dtype, device=model.device)

    if runtype == 1:
        # exact: bits pass through untouched
        return t(state.Qdp), t(state.ps_v), state.nstep
    if runtype == 2:
        # branch: rebuild Qdp = Q * dp_ref from the saved mixing ratio and
        # reset the step counter (prim_driver_mod.F90:629-669)
        ps = t(state.ps_v)
        dp_ref = ((model.hyai[1:] - model.hyai[:-1])[None, :, None, None]
                  * P0
                  + (model.hybi[1:] - model.hybi[:-1])[None, :, None, None]
                  * ps[:, None])
        Q = t(state.Qdp) / dp_ref[:, None]
        return Q * dp_ref[:, None], ps, 0
    raise ValueError(f"runtype {runtype} not in (1, 2)")
