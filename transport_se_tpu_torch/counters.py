"""Launch counters of the kernels and of their plain PyTorch versions.

Each kernel wrapper adds one to its kernel's count where it launches the
kernel; each plain version adds one to its own count where it runs.  A run
resets the counts, drives the main path and reads them back to show which
implementation the path went through.  The counts are shared by every
thread of the process (the shards of a `parallel.comm.ThreadComm` run each
in a thread of their own), so `bump` adds under a lock.
"""

import threading

KERNELS = ("fused_advect_limit", "laplace_wk_t", "remap_q_ppm_t",
           "dss_face", "minmax_prep", "neighbor_minmax", "limiter_optim",
           "dss_band")

COUNTS = {name: 0 for k in KERNELS for name in (k, k + "_plain")}
_lock = threading.Lock()


def bump(name: str) -> None:
    with _lock:
        COUNTS[name] += 1


def reset() -> None:
    with _lock:
        for name in COUNTS:
            COUNTS[name] = 0


def snapshot() -> dict:
    with _lock:
        return dict(COUNTS)
