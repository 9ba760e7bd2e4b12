"""K3's launch shape measured on the card: the PPM remap kernel of
`csrc/ppm.cu` built beside the package's library with one choice changed,
each held bitwise against the plain version and timed.

    python -m transport_se_tpu_torch.k3_variants [--other CSRC]

from the repo root.  --other CSRC also builds the K3 of another tree's
csrc directory (its ppm.cu, e.g. an unpacked parent commit) and times it in
turns with this one (this, other, other, this).

Variants (the source is edited in memory, built into `_build/k3_variants/`
with the package's nvcc flags, all builds started together):
  as_built      the source as it is: whole-column tiles where they keep
                256 threads walking an SM, else chunks of 8 levels
                streamed through shared memory; 512 (f64) / 768 (f32)
                threads an SM by the register cap; a helper warp a
                streamed block for every 64 records a step, at most two;
                at least two streamed blocks an SM where they fit
  ieee_divide   IEEE divisions throughout (no inline divisions)
  regs_more     384 / 640 threads an SM: 170 / 102 registers a thread
  helpers_1     one helper warp a block
  helpers_3     a helper warp for every 48 records a step, at most three
  one_block     the plan takes the most walking threads an SM, in one
                block if that holds the most
  records_2     a helper thread's record loop unrolled twice
  ieee_records  the records made with IEEE divisions throughout
  streamed_all  streamed tiles at every shape
  whole_all     whole-column tiles at every shape
and, with --diag, timing-only builds that take a part of the work away
(their output is not held): diag_no_pass2 (no tile walked again),
diag_no_copies (no copies of the mass in or out), diag_no_records (the
helpers make no records).

Each build's registers and spills (ptxas), and its launch shape at 35, 9
and 8 tracers (the f32 cells, and the f64 cell's tracer groups 9+9+9+8):
rows a tile, threads, shared bytes a block, blocks an SM and walking
threads an SM.  Every build is held bitwise to the plain version at NE30
(E = 5400, 72 levels, perf_config's remap inputs as chip_smoke.py phase 3
makes them, the first nq tracers) at alg 0 and 2, then timed (CUDA-event
medians of 7 after a warm-up, alg 0) at NE120's element count (the NE30
input tiled 16 times) in f64 and f32 at 9, 8 and 35 tracers.  Last, on
the remap input of a steady-state NE30 f32 face subcycle (the second one):
the share of its columns that hold a mass below 2^-100, the share that
K3's counting form walks again with IEEE divisions, and as_built and
ieee_divide timed on it.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
from pathlib import Path

import torch

from . import _build, counters
from .config import perf_config
from .k1_variants import build_libs, timed
from .model import core
from .model.wind_basis import build_wind_basis
from .ops import euler, remap

OUT = _build.BUILD_DIR / "k3_variants"
FAST = "walk_tile<true>(walker,"
WHOLE_FAST = "!sok[r] || walk_column<true>("
SM_THREADS = "static constexpr int sm_threads = sizeof(T) == 4 ? 768 : 512;"
HELPERS = "static constexpr int helpers = 2;"
RECORDS = "static constexpr int records = 64;"
TWO = "for (int two = 1;"
WHOLE = "static constexpr int walkers = 256;"
RECORDS_FAST = ("if (record_values<true>(lv, k, nk, v)) record_values<false>"
                "(lv, k, nk, v);")
EDITS = {
    "as_built": (),
    "ieee_divide": ((FAST, FAST.replace("true", "false")),
                    (WHOLE_FAST, WHOLE_FAST.replace("!sok[r]", "true"))),
    "regs_more": ((SM_THREADS, SM_THREADS.replace("768 : 512", "640 : 384")),),
    "helpers_1": ((HELPERS, HELPERS.replace("2", "1")),),
    "helpers_3": ((HELPERS, HELPERS.replace("2", "3")),
                  (RECORDS, RECORDS.replace("64", "48"))),
    "one_block": ((TWO, "for (int two = 0;"),),
    "records_2": (("      for (int i = h; i < rows * C; i += nh) {",
                   "#pragma unroll 2\n      for (int i = h; i < rows * C; "
                   "i += nh) {"),),
    "ieee_records": ((RECORDS_FAST, "record_values<false>(lv, k, nk, v);"),),
    "streamed_all": ((WHOLE, WHOLE.replace("256", "1 << 30")),),
    "whole_all": ((WHOLE, WHOLE.replace("256", "0")),),
}
# timing only (--diag): each takes a part of the work away, so its output
# is not the remap's; none walks a tile again
PASS2 = "if (pass == 1 && !__syncthreads_or(again)) break;"
NO_PASS2 = (PASS2,
            "if (pass == 1 && (__syncthreads_or(again) || true)) break;")
DIAG = {
    "diag_no_pass2": (NO_PASS2,),
    "diag_no_copies": (NO_PASS2, ('static_assert(32 % C == 0, "a warp\'s '
                                  'access covers whole chunks");',
                                  "return;")),
    "diag_no_records": (NO_PASS2, ("make_record(RingLevels<T>{sd",
                                   "if (nk < 0) make_record(RingLevels<T>"
                                   "{sd")),
}
ALGS = (0, 2)
TRACERS = (35, 9, 8)


def ppm_usage(log):
    """'f32 80r/0B, f32+whole ...': registers and spill stores of
    ppm_kernel in each form (+whole: whole-column tiles, else streamed;
    +count: the counting form)."""
    out, cur, spill = [], None, "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"ppm_kernelI([fd])(?:Lb([01])E)?(?:Lb([01])E)?",
                          m.group(1))
            cur = None if k is None else (
                ("f32" if k.group(1) == "f" else "f64")
                + ("+whole" if k.group(3) == "1" else "")
                + ("+count" if k.group(2) == "1" else ""))
        elif cur and "bytes spill stores" in ln:
            spill = ln.split("bytes spill stores")[0].split(",")[-1].strip()
        elif cur and "Used" in ln and "registers" in ln:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            out.append(f"{cur} {regs}r/{spill}B")
            cur = None
    return ", ".join(sorted(out))


def shape(lib, nq, nk, dtype_name):
    """K3's launch shape in lib, or None where lib has no tse_ppm_config."""
    fn = getattr(lib, "tse_ppm_config_" + dtype_name, None)
    if fn is None:
        return None
    fn.argtypes = _build.ENTRIES["tse_ppm_config"]
    fn.restype = ctypes.c_int
    buf = (ctypes.c_int * 6)()
    _build.check(fn(nq, nk, buf), "ppm_config variant")
    walk = min(buf[5] or buf[1], buf[0] * nq)
    return (f"rows {buf[0]}, threads {buf[1]}, shared {buf[2]} B, "
            f"blocks/SM {buf[3]}, walkers/SM {buf[3] * walk}, "
            + (f"chunks of {buf[4]}" if buf[4] else "whole columns"))


def remap_args(dtype, dev, ne=30):
    """(Qt, dp_star, dp_ref) of K3 at perf_config(ne), as chip_smoke.py
    phase 3 makes them."""
    cfg = perf_config(ne, dtype=dtype, use_pallas=True)
    m = core.build_model(cfg, dev)
    E, nk, nq = m.lon.shape[0], cfg.nlev, cfg.qsize
    Qt = core._tp(core.initial_qdp(m), E, nq * nk)
    divp = build_wind_basis(m).eval(
        torch.tensor(cfg.tstep, dtype=m.dtype, device=dev))[3]
    dps = (m.dp0col[None, None, :] - cfg.dt_remap * divp).contiguous()
    ps = m.hyai[0] * 1e5 + dps.sum(dim=2)
    dpr = ((m.hyai[1:] - m.hyai[:-1])[None, None, :] * 1e5
           + (m.hybi[1:] - m.hybi[:-1])[None, None, :] * ps[..., None])
    return Qt, dps, dpr.contiguous()


def tracers(args, nq):
    """(Qt, dp_star, dp_ref) with the first nq tracers of Qt."""
    Qt, dps, dpr = args
    return Qt[..., :nq * dps.shape[-1]].contiguous(), dps, dpr


def tiled(args, times):
    """(Qt, dp_star, dp_ref) with the elements repeated `times` times."""
    return tuple(a.repeat(times, 1, 1) for a in args)


def subcycle_input(dev, ne=30):
    """(Qt, dp_star, dp_ref, alg) of K3's launch in the second face
    subcycle of perf_config(ne, f32)."""
    m = core.build_model(perf_config(ne, dtype="f32", use_pallas=True), dev)
    E, nq, nk = m.lon.shape[0], m.cfg.qsize, m.cfg.nlev
    seen = []
    kernel = core.remap_q_ppm_t

    def record(Qt, dps, dpr, alg=0):
        seen.append((Qt.clone(), dps.clone(), dpr.clone(), alg))
        return kernel(Qt, dps, dpr, alg=alg)

    core.remap_q_ppm_t = record
    try:
        step = core.make_subcycle_fn(m, io_layout="t")
        Qt, _, nstep, _ = step(core._tp(core.initial_qdp(m), E, nq * nk), 0)
        step(Qt, nstep)
    finally:
        core.remap_q_ppm_t = kernel
    return seen[-1]


def launch(lib, Qt, dps, dpr, alg):
    """ops.remap.remap_q_ppm_t's launch, through lib (without counting)."""
    E, _, qk = Qt.shape
    nk = dps.shape[-1]
    out = torch.empty_like(Qt)
    fn = getattr(lib, "tse_remap_q_ppm_t_" + euler._DTYPES[Qt.dtype])
    code = fn(Qt.data_ptr(), dps.data_ptr(), dpr.data_ptr(), out.data_ptr(),
              E, qk // nk, nk, alg, euler._stream(Qt.device), None,
              counters.WORK_SLOTS)
    _build.check(code, "remap_q_ppm_t variant")
    return out


def held(lib, args, alg):
    """K3 through lib == the plain version, bitwise."""
    got = launch(lib, *args, alg)
    if not torch.equal(got, remap.remap_q_ppm_t_plain(*args, alg=alg)):
        raise AssertionError("variant differs from the plain version")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="csrc directory of another tree's K3")
    ap.add_argument("--diag", action="store_true",
                    help="also the timing-only builds, each without a part "
                    "of the work")
    ap.add_argument("--only", help="comma-separated builds (as_built and "
                    "other always)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    edits = dict(EDITS, **(DIAG if args.diag else {}))
    if args.only:
        keep = {"as_built", *args.only.split(",")}
        edits = {k: v for k, v in edits.items() if k in keep}
    sources = {name: (_build.CSRC, e) for name, e in edits.items()}
    if args.other:
        sources["other"] = (Path(args.other), ())
    libs, logs = build_libs(OUT, "ppm.cu", sources, ("tse_remap_q_ppm_t",))
    for name, log in logs.items():
        print(f"{name} ptxas ppm_kernel: {ppm_usage(log)}", flush=True)
    order = ["as_built", "other", "other", "as_built"] if args.other else \
        ["as_built"]
    order += [n for n in edits if n != "as_built"] + ["as_built"]
    for dtype in ("f64", "f32"):
        a = remap_args(dtype, dev)
        nk = a[1].shape[-1]
        for nq in TRACERS:
            for name, lib in libs.items():
                print(f"{dtype} nq {nq} {name} shape: "
                      f"{shape(lib, nq, nk, dtype)}", flush=True)
            sub = tracers(a, nq)
            for name, lib in libs.items():
                if name.startswith("diag_"):
                    continue
                for alg in ALGS:
                    held(lib, sub, alg)
            counters.work_reset()
            with counters.counting():
                remap.remap_q_ppm_t(*sub)
            w = counters.work_snapshot()
            counters.work_reset()
            print(f"{dtype} nq {nq}: every build bitwise at NE30, alg "
                  + "/".join(map(str, ALGS)) + f"; K3 walks "
                  f"{w['remap_rewalked']} of {w['remap_columns']} columns "
                  "again", flush=True)
            del sub
        for nq in TRACERS:
            big = tiled(tracers(a, nq), 16)
            ms = {}
            for name in order:
                ms.setdefault(name, []).append(
                    timed(lambda: launch(libs[name], *big, 0)))
            print(f"{dtype} nq {nq} at E = {big[0].shape[0]}: " + ", ".join(
                f"{n} " + "/".join(f"{t:.3f}" for t in ts) + " ms"
                for n, ts in ms.items()), flush=True)
            del big
            torch.cuda.empty_cache()
        del a
        torch.cuda.empty_cache()
    Qt, dps, dpr, alg = subcycle_input(dev)
    nk = dps.shape[-1]
    mag = Qt.view(torch.int32) & 0x7fffffff
    tiny = ((mag != 0) & (mag < 0x0d800000)).reshape(-1, nk).any(-1)
    print(f"subcycle input: {tiny.double().mean().item():.4%} of the "
          "columns hold a mass below 2^-100", flush=True)
    counters.work_reset()
    with counters.counting():
        remap.remap_q_ppm_t(Qt, dps, dpr, alg=alg)
    w = counters.work_snapshot()
    counters.work_reset()
    print(f"subcycle input: K3 walks {w['remap_rewalked']} of "
          f"{w['remap_columns']} columns again "
          f"({w['remap_rewalked'] / max(w['remap_columns'], 1):.4%})",
          flush=True)
    names = ["as_built", "ieee_divide", "ieee_divide", "as_built"]
    names = [n for n in names if n in libs]
    if args.other:
        names += ["other", "other"]
    names += [n for n in libs if n.startswith("diag_")]
    for name in names:
        if not name.startswith("diag_"):
            held(libs[name], (Qt, dps, dpr), alg)
        print(f"f32 {name} on the subcycle input (alg {alg}): "
              f"{timed(lambda: launch(libs[name], Qt, dps, dpr, alg)):.4f} "
              "ms", flush=True)


if __name__ == "__main__":
    main()
