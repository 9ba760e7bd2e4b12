"""Launch counters of the kernels and of their plain PyTorch versions, and
the work counters of the limiter (K1 or K10) and of K3's walks.

Each kernel wrapper adds one to its kernel's count where it launches the
kernel; each plain version adds one to its own count where it runs.  A run
resets the counts, drives the main path and reads them back to show which
implementation the path went through.  The counts are shared by every
thread of the process (the shards of a `parallel.comm.ThreadComm` run each
in a thread of their own), so `bump` adds under a lock.

The work counters (WORK) are counted on the device, and only inside a
`counting()` scope, which no run opens by default: there `ops.euler`'s
fused_advect_limit launches K1's counting form, which adds, over its valid
tracer-level columns, the limiter's clip-and-spread passes, the columns
and the columns stopped at the cap unconverged into the device's buffer
(`work_buffer`, WORK_SLOTS rows that K1's blocks add to in turn);
`ops.limiter`'s row limiter launches K10's counting form, which adds the
same three numbers over its valid rows into the same buffer (a T subcycle
runs K1 and a std subcycle K10, so the names mean the same on both); and
`ops.remap`'s remap_q_ppm_t launches K3's counting form, which adds the
columns it walked and those it walked again with IEEE divisions into a
buffer of its own (`work_buffer(device, "remap")`); each plain version
adds the same numbers by the same rule.  Outside the scope, a profiled run
included, K1, K10 and K3 run their forms without counting.
`work_snapshot()` waits for the device and sums the rows; `work_reset()`
zeroes them.
"""

import contextlib
import threading

import torch

KERNELS = ("fused_advect_limit", "laplace_wk_t", "remap_q_ppm_t",
           "dss_face", "minmax_prep", "neighbor_minmax", "limiter_optim",
           "dss_band", "wind_eval_t", "lane_gather_t", "lane_scatter_t",
           "remap_health_t")

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


# the work counters of each counting kernel, in the order of its buffer's
# columns
WORK_GROUPS = {"limiter": ("limiter_passes", "limiter_rows",
                           "limiter_capped"),
               "remap": ("remap_columns", "remap_rewalked")}
WORK = tuple(name for g in WORK_GROUPS.values() for name in g)
WORK_SLOTS = 256
_work = {}     # (device, group) -> int64 [WORK_SLOTS, len(group)]
_counting = 0  # open counting() scopes


@contextlib.contextmanager
def counting():
    """Count the limiter's work (K1, K10) and K3's walks (WORK) in the
    scope."""
    global _counting
    with _lock:
        _counting += 1
    try:
        yield
    finally:
        with _lock:
            _counting -= 1


def counting_on() -> bool:
    """Whether a counting() scope is open."""
    return _counting > 0


def work_buffer(device, group: str = "limiter") -> torch.Tensor:
    """The work counters of `group` (WORK_GROUPS) on `device`, [WORK_SLOTS,
    len(WORK_GROUPS[group])] (made zero on first use)."""
    key = (torch.device(device), group)
    with _lock:
        buf = _work.get(key)
        if buf is None:
            buf = _work[key] = torch.zeros(
                (WORK_SLOTS, len(WORK_GROUPS[group])), dtype=torch.int64,
                device=key[0])
        return buf


def work_add(device, counts: torch.Tensor, group: str = "limiter") -> None:
    """Add counts [len(WORK_GROUPS[group])] (a tensor on `device`) to the
    group's first row."""
    work_buffer(device, group)[0].add_(counts)


def work_reset() -> None:
    with _lock:
        for buf in _work.values():
            buf.zero_()


def work_snapshot() -> dict:
    """{WORK name: count} summed over every device's rows."""
    with _lock:
        bufs = list(_work.items())
    total = dict.fromkeys(WORK, 0)
    for (_, group), buf in bufs:
        for name, v in zip(WORK_GROUPS[group], buf.sum(dim=0).tolist()):
            total[name] += int(v)
    return total
