"""Named spans and region timers: the GPTL analog, with the JAX package's
API.

`span(name)` marks a region of the host's work for torch.profiler: while a
profiler records, it is a `torch.profiler.record_function`, so the region
lands in the profiler's own trace (a `user_annotation` event of the host
thread, on the clock of the kernels and of the calls that launched them);
otherwise it is a shared null context that costs one check.  Spans nest on
the host thread, so a subcycle's spans are found inside its `subcycle`
span.

`timers.time(name, sync=x)` times a region and opens the same span.  When
`sync` is a CUDA tensor, CUDA events are recorded on the current stream
around the region, and the device time between them is read when the
report is made (`get`, `report`), so the region does not wait for the
device; otherwise the time is the host's `perf_counter`.  A region without
`sync` times only what the host did, which under PyTorch's asynchronous
launches may be less than the device's work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict

import torch

_OFF = contextlib.nullcontext()


def tracing() -> bool:
    """Whether torch.profiler records: then spans are on."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A profiler span named `name` while torch.profiler records, else a
    shared null context."""
    if tracing():
        return torch.profiler.record_function(name)
    return _OFF


@dataclasses.dataclass
class _Region:
    count: int = 0
    total: float = 0.0
    max: float = 0.0
    # (start, end) CUDA events of regions whose device time is not read yet
    pending: list = dataclasses.field(default_factory=list)

    def add(self, dt: float) -> None:
        self.count += 1
        self.total += dt
        self.max = max(self.max, dt)

    def resolve(self) -> None:
        for start, end in self.pending:
            end.synchronize()
            self.add(start.elapsed_time(end) / 1e3)
        self.pending.clear()


class Timers:
    def __init__(self):
        self._regions = defaultdict(_Region)

    @contextlib.contextmanager
    def time(self, name: str, sync=None):
        dev = sync.device if sync is not None and sync.is_cuda else None
        if dev is not None:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            r = self._regions[name]
            if dev is not None:
                end.record(torch.cuda.current_stream(dev))
                r.pending.append((start, end))
            else:
                r.add(time.perf_counter() - t0)

    def reset(self):
        self._regions.clear()

    def report(self) -> str:
        """HommeTime_stats-style summary (perf_mod.F90 `t_prf` analog)."""
        for r in self._regions.values():
            r.resolve()
        lines = [f"{'name':<36} {'calls':>8} {'walltotal':>12} "
                 f"{'wallmax':>10}"]
        for name, r in sorted(self._regions.items(),
                              key=lambda kv: -kv[1].total):
            lines.append(f"{name:<36} {r.count:>8d} {r.total:>12.3f} "
                         f"{r.max:>10.4f}")
        return "\n".join(lines)

    def get(self, name: str) -> _Region:
        r = self._regions[name]
        r.resolve()
        return r


timers = Timers()
