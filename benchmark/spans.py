"""The program's spans in a Chrome trace exported on the card: device time
by call site, the host's enqueue and the idle gaps the host caused.

The port marks its layers with spans (`transport_se_tpu_torch.timing.span`:
`subcycle`, `tracer_step`, `wind`, `stage` and `stage.*`, `remap` and
`remap.*`).  While torch.profiler records, each span is a `user_annotation`
event of the host thread, on the clock of the device operations and of
the runtime calls that launched them (tied by their correlation ids).
`harness.py --trace 1` exports its traced block to
`benchmark/out/trace.<cell>.json`; then

    python3 benchmark/spans.py benchmark/out/trace.<cell>.json

prints one JSON object:

- `device_ms_per_subcycle`: device ms of the operations whose launch call
  lies inside each span on the launching thread (spans nest: `stage`
  holds what `stage.advect` holds), and `innermost_ms_per_subcycle` by the
  innermost span alone;
- `outside_pct_of_busy`: the share of busy time launched inside no span;
- `host_ms_per_subcycle_under_profiler`: the mean host length of the
  `subcycle` spans, the host's enqueue with the profiler's own cost of
  each operator and span in it;
- `host_bound`: the idle gaps (as `trace.Trace` finds them) whose next
  operation's launch call began after the gap began, so the device waited
  for the host.  The block starts from a drained device, so the gaps
  before the first `subcycle` span ends are the ramp (`ramp_ms`); those
  after it are the steady state (`steady_ms`, and `steady_pct` of the
  span from that end to the last operation's); `ms` is both, and the
  only reading of a trace without spans.  `by_span` names the innermost
  span the launching thread was in at each gap's start.

The subcycles are the trace's `subcycle` spans (whole subcycles, as the
harness traces them).
"""

from __future__ import annotations

import argparse
import bisect
import itertools
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark.trace import DEVICE_CATS, Trace  # noqa: E402

OUTSIDE = "(outside the program)"


class _Thread:
    """The spans of one host thread, sorted by start."""

    def __init__(self, spans):
        spans.sort()
        self.spans = spans                       # [(start, end, name)]
        self.starts = [s for s, _, _ in spans]
        self.reach = list(itertools.accumulate((e for _, e, _ in spans),
                                               max))

    def stack(self, t):
        """The names of the spans that hold time t, innermost first."""
        out = []
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.reach[i] >= t:
            s, e, name = self.spans[i]
            if e >= t:
                out.append(name)
            i -= 1
        return out


class Spans:
    def __init__(self, events):
        """From Chrome-trace events (dicts with ph, cat, name, ts, dur in
        microseconds, args.correlation, tid)."""
        dev, launch, by_tid = [], {}, {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                dev.append((float(e["ts"]), float(e["dur"]), corr))
            elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launch[corr] = (float(e["ts"]), e.get("tid"))
            elif cat == "user_annotation":
                ts = float(e["ts"])
                by_tid.setdefault(e.get("tid"), []).append(
                    (ts, ts + float(e["dur"]), e["name"]))
        dev.sort(key=lambda x: x[:2])
        self.threads = {t: _Thread(v) for t, v in by_tid.items()}
        self.spans = sorted(s for v in by_tid.values() for s in v)
        # device seconds by every span holding the launch, and by the
        # innermost; gaps as trace.Trace finds them, with the launch time
        self.inclusive, self.innermost = {}, {}
        self.gaps = []           # (gap start us, idle s, launch or None)
        end = dev[0][0] if dev else 0.0
        for ts, d, corr in dev:
            at = launch.get(corr)
            stack = self._stack(at)
            for n in set(stack):
                self.inclusive[n] = self.inclusive.get(n, 0.0) + d / 1e6
            key = stack[0] if stack else OUTSIDE
            self.innermost[key] = self.innermost.get(key, 0.0) + d / 1e6
            if ts > end:
                self.gaps.append((end, (ts - end) / 1e6, at))
            end = max(end, ts + d)
        self.end = end           # the last operation's end, us

    def _stack(self, at, t=None):
        """The spans around host time t (default: the launch's own time)
        on the launching thread of `at` = (launch time, thread)."""
        if at is None or at[1] not in self.threads:
            return []
        return self.threads[at[1]].stack(at[0] if t is None else t)

    def device_s(self, name: str) -> float:
        return self.inclusive.get(name, 0.0)

    def outside_s(self) -> float:
        return self.innermost.get(OUTSIDE, 0.0)

    def durations(self, name: str) -> list:
        """Host seconds of each span `name`, by start."""
        return [(e - s) / 1e6 for s, e, n in self.spans if n == name]

    def steady_from(self):
        """The end of the first `subcycle` span (us), or None."""
        return next((e for _, e, n in self.spans if n == "subcycle"), None)

    def host_bound_gaps(self) -> list:
        """[(gap start us, innermost span at the gap's start, idle s)] of
        the gaps whose next operation was launched after the gap began."""
        out = []
        for start, idle, at in self.gaps:
            if at is not None and at[0] > start:
                stack = self._stack(at, start)
                out.append((start, stack[0] if stack else OUTSIDE, idle))
        return out


def _events(path):
    data = json.loads(Path(path).read_text())
    return data["traceEvents"] if isinstance(data, dict) else data


def summary(events):
    """The report of the command line (module docstring)."""
    sp = Spans(events)
    subcycles = len(sp.durations("subcycle"))
    tr = Trace.from_events(events, subcycles, {})
    per = max(subcycles, 1)
    steady_at = sp.steady_from()
    total = steady = 0.0
    by = {}
    for start, name, idle in sp.host_bound_gaps():
        late = steady_at is not None and start >= steady_at
        total += idle
        steady += idle if late else 0.0
        b = by.setdefault(name, {"gaps": 0, "ms": 0.0, "steady_ms": 0.0})
        b["gaps"] += 1
        b["ms"] += idle * 1e3
        b["steady_ms"] += idle * 1e3 if late else 0.0
    ramp = total - steady
    steady_span = None if steady_at is None else (sp.end - steady_at) / 1e6
    hosts = sp.durations("subcycle")
    return {
        "subcycles": subcycles, "busy_ms": tr.busy_s * 1e3,
        "span_ms": tr.span_s * 1e3,
        "device_ms_per_subcycle": {
            k: v * 1e3 / per for k, v in sorted(sp.inclusive.items())},
        "innermost_ms_per_subcycle": {
            k: v * 1e3 / per for k, v in sorted(sp.innermost.items())},
        "outside_pct_of_busy": 100 * sp.outside_s() / tr.busy_s,
        "host_ms_per_subcycle_under_profiler": (
            1e3 * sum(hosts) / len(hosts) if hosts else None),
        "idle_ms": sum(g for _, g in tr.gaps) * 1e3,
        "host_bound": {
            "ms": total * 1e3,
            # split at the first subcycle's end, where the trace has one
            "ramp_ms": None if steady_span is None else ramp * 1e3,
            "steady_ms": None if steady_span is None else steady * 1e3,
            "steady_span_ms": (None if steady_span is None
                               else steady_span * 1e3),
            "steady_pct": (100 * steady / steady_span if steady_span
                           else None),
            "by_span": dict(sorted(by.items(), key=lambda kv: -kv[1]["ms"])),
        },
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("chrome_trace")
    a = p.parse_args(argv)
    print(json.dumps(summary(_events(a.chrome_trace)), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
