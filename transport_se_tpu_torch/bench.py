"""The port's headline benchmark: the counterpart of the repository's
`bench.py`, on one CUDA card.

Rows, as bench.py has them:

* NE30: `perf_config(30, dtype="f32", use_pallas=True)`, 35 tracers, 72
  levels, face DSS on raster order, limiter 8 capped at 4 iterations,
  hyperviscosity, no diagnostics: the T-layout path through K1 and K3-K6;
* the NE42 proxy: `perf_config(42, ...)`, 6*42^2 = 10584 elements (about
  one 8-way shard of the NE120 grid) at NE120's tstep 75 and nu 1e13.

BENCH_NE=120 BENCH_PROXY=0 runs the reference's headline configuration
itself (`test/run_ne120_perf.sh`: 86,400 elements x 16 x 72 levels x 35
tracers, tstep 75, nu_q 1e13) on one card: its state is 12.98 GiB in f32,
and a subcycle holds at most four states at once (`model.core`), so the
row needs about 60 GiB.  Each row's stderr also gives its build times,
the size of one state and the card's peak allocated memory
(`torch.cuda.max_memory_allocated`) over the row.

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
one subcycle more runs off the clock inside `counters.counting()`, so
that the limiter counts its passes (stderr: passes a column of K1 on the
T path, a row of K10 on the std path, and the share stopped at the cap)
and K3 the columns it walks again with IEEE divisions (stderr: their
share of the remap's columns).  Then the run's
min_dp must be positive and its state finite, or the bench exits 1 and
prints no rate.

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


def initial_state(m):
    """The row's initial state in its pipeline's layout: [E, 16, q*k]
    built in place on the T path (`initial_qdp_t`: one state's memory at
    NE120's 35 tracers, 13 GiB in f32), Qdp [E, q, k, 4, 4] on the std
    path."""
    from .model.core import initial_qdp, initial_qdp_t, uses_t_layout
    return initial_qdp_t(m) if uses_t_layout(m.cfg) else initial_qdp(m)


def measure(cfg, subcycles, device, log):
    """Time one row -> dict(E, work (gridpoint-tracers a window), windows
    [(host s, events ms or None)], rates, value (median rate), pooled (all
    windows' work over all their wall), min_dp, finite, launches,
    limiter (counters.WORK over one subcycle after the windows), build
    (s of the kernels' library on the card, the model, the subcycle
    function with its wind basis and the initial state), state_bytes (one
    state) and peak_bytes (the card's
    peak allocated memory over the row, None on the CPU)).
    log(str) takes the per-window lines.  The state is handed to each
    subcycle (a one-element list), which frees every state-sized buffer at
    its last use."""
    import torch

    from . import counters
    from .model.core import build_model, make_subcycle_fn, uses_t_layout
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    build = {}
    if cuda:
        from . import _build
        t0 = time.perf_counter()
        _build.library()     # nvcc on first use, cached after
        build["kernels"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    m = build_model(cfg, device)
    E = m.lon.shape[0]
    sync()
    build["model"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    step = make_subcycle_fn(m, io_layout="t" if uses_t_layout(cfg)
                            else "std")
    sync()
    build["subcycle_fn"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    box = [initial_state(m)]
    sync()
    build["state"] = time.perf_counter() - t0
    state_bytes = box[0].numel() * box[0].element_size()
    nstep = 0
    for _ in range(max(WARMUP_MIN, subcycles)):
        box[0], _, nstep, _ = step(box, nstep)
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
            box[0], _, nstep, md = step(box, nstep)
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
    # one subcycle more, off the clock, counting the limiter's work (K1 or
    # K10) and K3's walks
    counters.work_reset()
    with counters.counting():
        box[0], _, nstep, md = step(box, nstep)
    mins.append(md)
    limiter = counters.work_snapshot()
    counters.work_reset()
    rates = [work / h for h, _ in windows]
    return dict(E=E, work=work, windows=windows, rates=rates,
                value=statistics.median(rates),
                pooled=work * len(windows) / sum(h for h, _ in windows),
                min_dp=float(torch.stack(mins).min()),
                finite=bool(torch.isfinite(box[0]).all()), launches=launches,
                limiter=limiter,
                build=build, state_bytes=state_bytes,
                peak_bytes=(torch.cuda.max_memory_allocated(device) if cuda
                            else None))


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
        lim = r.get("limiter") or {}
        if lim.get("limiter_rows"):
            rows = lim["limiter_rows"]
            kernel, row = ("K1", "column") if cfg.use_pallas else ("K10",
                                                                   "row")
            log(f"NE{ne} limiter ({kernel}, one subcycle after the windows): "
                f"{lim['limiter_passes'] / rows!r} passes a {row}, "
                f"{100 * lim['limiter_capped'] / rows!r}% capped; "
                + ", ".join(f"{k} {v}" for k, v in lim.items()))
        if lim.get("remap_columns"):
            log(f"NE{ne} remap (K3, the same subcycle): "
                f"{lim['remap_rewalked']} of {lim['remap_columns']} columns "
                "walked again with IEEE divisions, "
                f"{100 * lim['remap_rewalked'] / lim['remap_columns']!r}%")
        if not (r["min_dp"] > 0 and r["finite"]):
            log(f"error: NE{ne}: min_dp {r['min_dp']!r}, finite "
                f"{r['finite']}: a broken state gives no rate")
            return 1
        peak = ("n/a" if r["peak_bytes"] is None else
                f"{r['peak_bytes']!r} B = {r['peak_bytes'] / 2**30:.2f} GiB "
                f"= {r['peak_bytes'] / r['state_bytes']:.3f} states")
        log(f"NE{ne} memory: state {r['state_bytes']!r} B = "
            f"{r['state_bytes'] / 2**30:.2f} GiB; peak allocated {peak}; "
            "build s: " + ", ".join(f"{k} {v:.2f}"
                                    for k, v in r["build"].items()))
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
