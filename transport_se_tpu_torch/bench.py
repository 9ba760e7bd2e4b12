"""The port's headline benchmark: the counterpart of the repository's
`bench.py`, on one CUDA card.

Rows, as bench.py has them:

* NE30: `perf_config(30, dtype="f32", use_pallas=True)`, 35 tracers, 72
  levels, face DSS on raster order, limiter 8 capped at 4 iterations,
  hyperviscosity, no diagnostics: the T-layout path through K1 and K3-K6;
* the NE42 proxy: `perf_config(42, ...)`, 6*42^2 = 10584 elements (about
  one 8-way shard of the NE120 grid) at NE120's tstep 75 and nu 1e13.

Metric (bench.py's): gridpoint-tracers advanced per second =
steps * E * 16 * nlev * qsize / wall, and vs_baseline against the
reference's NE120 perf run on 960 Edison cores, 3.53e9 /s (BASELINE.md).

Method: `model.core.make_subcycle_fn` is called directly (the driver's
`run_simulation` syncs the host every subcycle to check min_dp).  One
window's worth of subcycles (BENCH_SUBCYCLES, at least 2) warms up through
the chain: the first builds the kernels, and a face subcycle slows by
about 1 ms over the first ~25 of a run (PERF.md), so the timed windows
start past that rise.  Then WINDOWS windows of BENCH_SUBCYCLES subcycles
each run with no host sync inside; each window's wall is the host clock
ended by `torch.cuda.synchronize()`, with CUDA events beside it.  The
row's value is the median window's rate (not bench.py's best of two);
stderr also gives the pooled rate, all windows' work over all their wall.
After the windows
the run's min_dp must be positive and its state finite, or the bench exits
1 and prints no rate.

Environment, read as bench.py reads it: BENCH_NE (30), BENCH_QSIZE (35),
BENCH_SUBCYCLES (24), BENCH_PALLAS (1; 0 runs the std-layout f32 path
through the row limiter K10), BENCH_LIMCAP (0 keeps perf_config's cap) and
BENCH_PROXY (1; 0 skips the NE42 row, which BENCH_NE=42 also does).
BENCH_EB and BENCH_RHS_BF16 are TPU knobs (Pallas block size, bf16
matmuls) and are not read.

Usage:
    python -m transport_se_tpu_torch.bench [--device cuda|cpu]

--device defaults to cuda and exits 2 where there is no CUDA device; the
CPU runs only when asked for (its kernels are the plain versions).
Stdout is one JSON line with bench.py's keys (metric, value, unit,
vs_baseline, and with the proxy row ne42_proxy_value and
ne42_proxy_vs_baseline); stderr has the card's name and power limit, each
window's events and host milliseconds per subcycle and rate, each row's
median and spread, its work per window and its kernel launches.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

from .main import pick_device

BASELINE = 3.53e9    # gridpoint-tracers/s, reference NE120 perf, 960 cores
WARMUP_MIN = 2       # warm-up subcycles: one window's worth, at least this
WINDOWS = 3          # timed windows per row; the value is their median
PROXY_NE = 42


def settings(env=None) -> dict:
    """The BENCH_* variables, parsed as bench.py parses them."""
    env = os.environ if env is None else env

    def on(name):
        return env.get(name, "1") not in ("0", "", "off")
    return dict(ne=int(env.get("BENCH_NE", "30")),
                qsize=int(env.get("BENCH_QSIZE", "35")),
                subcycles=int(env.get("BENCH_SUBCYCLES", "24")),
                pallas=on("BENCH_PALLAS"),
                limcap=int(env.get("BENCH_LIMCAP", "0")),
                proxy=on("BENCH_PROXY"))


def bench_config(ne, qsize, pallas, limcap):
    """perf_config(ne, f32) with the bench's tracer count, path and cap."""
    from .config import perf_config
    cfg = perf_config(ne, dtype="f32", use_pallas=pallas)
    return dataclasses.replace(
        cfg, qsize=qsize, **({"limiter_iter_cap": limcap} if limcap else {}))


def card_line(device) -> str:
    """nvidia-smi's name and power limit of the card (or what torch knows
    when nvidia-smi does not answer)."""
    import torch
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(device)}, power limit not read"


def measure(cfg, subcycles, device, log):
    """Time one row -> dict(E, work (gridpoint-tracers a window), windows
    [(host s, events ms or None)], rates, value (median rate), pooled (all
    windows' work over all their wall), min_dp, finite, launches).
    log(str) takes the per-window lines."""
    import torch

    from . import counters
    from .model.core import (_tp, build_model, initial_qdp,
                             make_subcycle_fn, uses_t_layout)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    m = build_model(cfg, device)
    E = m.lon.shape[0]
    t_layout = uses_t_layout(cfg)
    step = make_subcycle_fn(m, io_layout="t" if t_layout else "std")
    Q = initial_qdp(m)
    if t_layout:
        Q = _tp(Q, E, cfg.qsize * cfg.nlev)
    nstep = 0
    for _ in range(max(WARMUP_MIN, subcycles)):
        Q, _, nstep, _ = step(Q, nstep)
    sync()
    work = subcycles * cfg.rsplit * E * 16 * cfg.nlev * cfg.qsize
    counters.reset()
    windows, mins = [], []
    for w in range(WINDOWS):
        # an event at every subcycle boundary: recording one does not wait
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(subcycles + 1)] if cuda else None
        t0 = time.perf_counter()
        if cuda:
            ev[0].record()
        for i in range(subcycles):
            Q, _, nstep, md = step(Q, nstep)
            mins.append(md)
            if cuda:
                ev[i + 1].record()
        sync()
        host = time.perf_counter() - t0
        ev_ms = ev[0].elapsed_time(ev[-1]) if cuda else None
        windows.append((host, ev_ms))
        each = ""
        if cuda:
            sub = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
            each = (f" (subcycles: first {sub[0]:.3f}, last {sub[-1]:.3f}, "
                    f"min {min(sub):.3f}, max {max(sub):.3f})")
        log(f"NE{cfg.ne} window {w}: events "
            + (f"{ev_ms / subcycles!r}" if cuda else "n/a")
            + f" ms/subcycle{each}, host {host * 1e3 / subcycles!r} "
            f"ms/subcycle, {work / host!r} gridpoint-tracers/s")
    launches = {k: n for k, n in counters.snapshot().items() if n}
    rates = [work / h for h, _ in windows]
    return dict(E=E, work=work, windows=windows, rates=rates,
                value=statistics.median(rates),
                pooled=work * len(windows) / sum(h for h, _ in windows),
                min_dp=float(torch.stack(mins).min()),
                finite=bool(torch.isfinite(Q).all()), launches=launches)


def main(argv=None) -> int:
    """Run the rows and print; returns the exit code: 0, 1 when a row's
    state is broken (min_dp <= 0 or not finite), 2 without the card."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    picked = pick_device(args.device)
    if picked is None:
        return 2
    device, _ = picked
    st = settings()

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    log(f"card: {card_line(device)}")
    rows = [("value", st["ne"])]
    if st["proxy"] and st["ne"] != PROXY_NE:
        rows.append(("ne42_proxy_value", PROXY_NE))
    out = {}
    for key, ne in rows:
        cfg = bench_config(ne, st["qsize"], st["pallas"], st["limcap"])
        r = measure(cfg, st["subcycles"], device, log)
        log(f"NE{ne} row: E {r['E']}, {st['subcycles']} subcycles x "
            f"{cfg.rsplit} steps a window, work {r['work']} "
            f"gridpoint-tracers a window; median {r['value']!r}, min "
            f"{min(r['rates'])!r}, max {max(r['rates'])!r}, pooled "
            f"{r['pooled']!r} gridpoint-tracers/s over {WINDOWS} windows "
            f"after {max(WARMUP_MIN, st['subcycles'])} warm-up subcycles; "
            f"min_dp "
            f"{r['min_dp']!r}; finite {r['finite']}; launches "
            + ", ".join(f"{k} {n}" for k, n in r["launches"].items()))
        if not (r["min_dp"] > 0 and r["finite"]):
            log(f"error: NE{ne}: min_dp {r['min_dp']!r}, finite "
                f"{r['finite']}: a broken state gives no rate")
            return 1
        vs = "vs_baseline" if key == "value" else "ne42_proxy_vs_baseline"
        if key == "value":
            out.update(metric=f"NE{ne} {st['qsize']}-tracer "
                       "gridpoint-tracers/s per chip",
                       value=round(r["value"] / 1e9, 4) * 1e9,
                       unit="gridpoint-tracers/s")
        else:
            out[key] = round(r["value"] / 1e9, 4) * 1e9
        out[vs] = round(r["value"] / BASELINE, 4)
        del r
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
