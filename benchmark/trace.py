"""The device trace of a traced run, reduced for the per-layer readers.

`Trace.from_chrome(path, ...)` reads the Chrome trace that torch.profiler
exports: the device operations (kernels, copies, fills) with their start,
length and the correlation id of the host call that launched them, the
host's runtime calls and operator spans.  What the readers need is then
plain data: every device operation by short name, the merged busy time,
the span from the first start to the last end, and each idle gap named by
the host operator that launched the operation after it.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import re
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
KERNELS = Path(__file__).resolve().parent / "kernels"


def short_name(name: str) -> str:
    """A kernel's name without return type, namespace, template and call
    arguments: `void tse::dss_face_kernel<float, true>(...)` ->
    `dss_face_kernel`."""
    s = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.split(r"[<(]", s)[0].split("::")[-1].strip()


def port_kernels() -> dict:
    """{short kernel name: kernel file name} over benchmark/kernels/*.json,
    one file a kernel of the port."""
    out = {}
    for f in sorted(KERNELS.glob("*.json")):
        for n in json.loads(f.read_text())["names"]:
            out[n] = f.stem
    return out


@dataclasses.dataclass
class Trace:
    ops: list            # [(short name, start s, length s)], by start
    busy_s: float        # merged device busy time
    span_s: float        # first start to last end
    gaps: list           # [(host operator, idle s)] between busy intervals
    subcycles: int       # whole subcycles inside the trace
    cfg: dict            # E, qsize, nlev, dtype, rsplit of the run
    kernels: dict        # port_kernels()

    def kernel_s(self, kernel: str) -> float:
        """Device seconds of the port's kernel `kernel` (a file name of
        benchmark/kernels)."""
        return sum(d for n, _, d in self.ops if self.kernels.get(n) == kernel)

    def other_s(self) -> float:
        """Device seconds of every operation that is none of the port's
        kernels."""
        return sum(d for n, _, d in self.ops if n not in self.kernels)

    @staticmethod
    def from_events(events, subcycles, cfg):
        """From Chrome-trace events (dicts with ph, cat, name, ts, dur in
        microseconds, args.correlation, tid)."""
        dev, launch, by_tid = [], {}, {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                dev.append((float(e["ts"]), float(e["dur"]), e["name"], corr))
            elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launch[corr] = (float(e["ts"]), e.get("tid"))
            elif cat == "cpu_op":
                by_tid.setdefault(e.get("tid"), []).append(
                    (float(e["ts"]), float(e["dur"]), e["name"]))
        if not dev:
            raise RuntimeError("the trace holds no device operation")
        dev.sort(key=lambda x: x[:2])
        host = {t: ([a[0] for a in v], v)
                for t, v in ((t, sorted(v)) for t, v in by_tid.items())}
        ops = [(short_name(n), ts / 1e6, d / 1e6) for ts, d, n, _ in dev]
        busy, gaps, end = 0.0, [], dev[0][0]
        for ts, d, name, corr in dev:
            if ts > end:
                gaps.append((_host_op(launch.get(corr), host, name),
                             (ts - end) / 1e6))
            busy += max(0.0, ts + d - max(ts, end))
            end = max(end, ts + d)
        return Trace(ops=ops, busy_s=busy / 1e6,
                     span_s=(end - dev[0][0]) / 1e6, gaps=gaps,
                     subcycles=subcycles, cfg=cfg, kernels=port_kernels())

    @staticmethod
    def from_chrome(path, subcycles, cfg):
        data = json.loads(Path(path).read_text())
        events = data["traceEvents"] if isinstance(data, dict) else data
        return Trace.from_events(events, subcycles, cfg)

    def breakdown(self, n=10):
        """{"device_ops": the n operations that took most device time,
        "idle_gaps": the n host operators whose launches the device waited
        longest for, summed over the gaps}, seconds."""
        by = {}
        for name, _, d in self.ops:
            by[name] = by.get(name, 0.0) + d
        idle = {}
        for name, g in self.gaps:
            idle[name] = idle.get(name, 0.0) + g
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        gap = sorted(idle.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gap]}


def _host_op(launch, host, device_name):
    """The innermost host operator around the launch of a device
    operation; the device operation's own name where none is found.
    host: {tid: (starts, [(start, length, name)])}, sorted by start."""
    if launch is not None and launch[1] in host:
        ts, tid = launch
        starts, spans = host[launch[1]]
        # nested spans: walking back from the last start at or before the
        # launch, the first span that still holds it is the innermost
        last = bisect.bisect_right(starts, ts) - 1
        for i in range(last, max(last - 64, -1), -1):
            s, d, name = spans[i]
            if s + d >= ts:
                return name
    return f"(launch of {short_name(device_name)})"
