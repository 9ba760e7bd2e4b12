"""Run benchmark/run.py several times in turn, each in its own process,
and keep every result: the series of a cell's measured sets, its traced
runs and the readings its limits are set from.

    python3 benchmark/series.py --out benchmark/out/sets.jsonl \
        ne120_perf.q35:101:20:0 ne120_perf.q35:102:20:0 \
        ne120_perf.q35:103:0:0:--control=tf32

Each run is workload:seed:seconds:trace, then extra run.py arguments.  Each
line of --out holds the run's spec, exit code, seconds, result line and the
end of its standard error; standard error gets one summary line a run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--timeout", type=float, default=1200.0)
    p.add_argument("runs", nargs="+")
    a = p.parse_args(argv)
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    worst = 0
    for spec in a.runs:
        w, seed, sec, trace, *extra = spec.split(":")
        cmd = [sys.executable, str(RUN), "--workload", w, "--seed", seed,
               "--seconds", sec, "--trace", trace] + extra
        t0 = time.perf_counter()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=a.timeout, env=os.environ.copy())
            rc, so, se = r.returncode, r.stdout, r.stderr
        except subprocess.TimeoutExpired as e:
            rc, so, se = 124, e.stdout or "", e.stderr or ""
            so = so.decode() if isinstance(so, bytes) else so
            se = se.decode() if isinstance(se, bytes) else se
        took = time.perf_counter() - t0
        lines = so.strip().splitlines()
        try:
            res = json.loads(lines[-1]) if lines else None
        except ValueError:
            res = None
        with out.open("a") as f:
            f.write(json.dumps({"spec": spec, "rc": rc, "seconds": took,
                                "result": res, "stderr": se[-6000:]}) + "\n")
        worst = max(worst, rc)
        summary = "no result"
        if res:
            summary = (f"correct {res['correct']} "
                       + " ".join(f"{k} {v['value']:.6g}"
                                  for k, v in res["metrics"].items())
                       + " | " + " ".join(
                           f"{k} {v['value']:.3g}"
                           for k, v in res.get("check", {}).items()))
        print(f"{spec}: rc {rc}, {took:.1f} s, {summary}", file=sys.stderr,
              flush=True)
        if res is None:
            print(se[-3000:], file=sys.stderr, flush=True)
    return worst


if __name__ == "__main__":
    sys.exit(main())
