"""K1's design choices measured on the card: the fused stage kernel of
`csrc/euler.cu` built beside the package's library with one choice
changed, each held bitwise against the plain version and timed.

    python -m transport_se_tpu_torch.k1_variants [--other CSRC]

from the repo root.  --other CSRC also builds the K1 of another tree's
csrc directory (its euler.cu and headers, e.g. an unpacked parent commit)
and times it in turns with this one, with the limiter's iteration cap at
1, 2, 4 and 15.

Variants (the source is edited in memory, built into `_build/k1_variants/`
with the package's nvcc flags, all builds started together):
  as_built       the source as it is
  blocks_4_2     __launch_bounds__ asks 4 blocks of 256 threads in f32 (64
                 registers) and 2 in f64, instead of 3 and 2
  blocks_2_1     2 in f32 (128 registers) and 1 in f64 (255)
  no_opaque      the metric rows' base without opaque_zero (the compiler
                 may hoist their loads out of the lane loop)
  no_groups      one block per element always, never split into lane groups

Times are CUDA-event medians of 7 after a warm-up, at NE30 (E = 5400,
35 x 72 lanes, perf_config) per stage kind; no_groups against as_built also
on subsets of the elements, where the grouping applies (fewer than
blocks x SMs elements; the NE30 face+overlap boundary groups at S = 8 have
102-158).  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
from pathlib import Path

import torch

from . import _build
from .config import perf_config
from .model import core
from .model.wind_basis import build_wind_basis
from .ops import euler

OUT = _build.BUILD_DIR / "k1_variants"
BLOCKS = "static constexpr int value = sizeof(T) == 4 ? 3 : 2;"
OPAQUE = "const T* const m = sm + opaque_zero();"
GROUPS = ("  const int groups = E >= want ? 1 : "
          "std::min(passes, (want + E - 1) / E);")
EDITS = {
    "as_built": (),
    "blocks_4_2": ((BLOCKS, BLOCKS.replace("3 : 2", "4 : 2")),),
    "blocks_2_1": ((BLOCKS, BLOCKS.replace("3 : 2", "2 : 1")),),
    "no_opaque": ((OPAQUE, "const T* const m = sm;"),),
    "no_groups": ((GROUPS, "  const int groups = 1;"),),
}
SUBSETS = (24, 120, 158, 675)
CAPS = (1, 2, 4, 15)
N_TIMED = 7


def build_libs(out, source, sources, entries):
    """Build source (a file name of csrc) once per variant, all nvcc calls
    started together: sources {name: (csrc directory, ((old, new), ...))}
    -> ({name: ctypes library with entries' argtypes}, {name: nvcc log})."""
    nvcc = _build.find_nvcc()
    texts = {}
    for name, (csrc, edits) in sources.items():
        s = (Path(csrc) / source).read_text()
        for old, new in edits:
            if s.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {source} "
                                   "exactly once")
            s = s.replace(old, new)
        texts[name] = s
    procs = {}
    for name, (csrc, _) in sources.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / source).write_text(texts[name])
        for h in _build.HEADERS:
            shutil.copy(Path(csrc) / h, d / h)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, logs = {}, {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        (out / name / "build.log").write_text(log)
        logs[name] = log
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        for entry in entries:
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, entry + suffix)
                fn.argtypes = _build.ENTRIES[entry]
                fn.restype = ctypes.c_int
        libs[name] = lib
    return libs, logs


def build_variants(other=None):
    """{name: ctypes library}, and the ptxas lines of euler_kernel; with
    other (a csrc directory), also the variant "other" built from it."""
    sources = {name: (_build.CSRC, edits) for name, edits in EDITS.items()}
    if other is not None:
        sources["other"] = (Path(other), ())
    libs, logs = build_libs(OUT, "euler.cu", sources,
                            ("tse_fused_advect_limit",))
    for name, (csrc, _) in sources.items():
        if "void* counts" not in (Path(csrc) / "euler.cu").read_text():
            # a tree from before K1's counting form: its entry ends at the
            # stream
            for suffix in ("_f32", "_f64"):
                getattr(libs[name], "tse_fused_advect_limit" + suffix) \
                    .argtypes = _build.ENTRIES["tse_fused_advect_limit"][:-2]
            libs[name].counted = False
    return libs, {name: euler_usage(log) for name, log in logs.items()}


def euler_usage(log):
    """'f32 80r/20B, f32+bih ..., f32+count ...': registers and spill
    stores of K1 in each form (+count: the counting form)."""
    out, cur, spill = [], None, "?"
    for ln in log.splitlines():
        if "Compiling entry function" in ln and "euler_kernel" in ln:
            form = re.search(r"euler_kernelI([fd])Lb([01])E(?:Lb([01])E)?",
                             ln)
            cur = (("f32" if form[1] == "f" else "f64")
                   + ("+bih" if form[2] == "1" else "")
                   + ("+count" if form[3] == "1" else ""))
        elif cur and "bytes spill stores" in ln:
            spill = ln.split("bytes spill stores")[0].split(",")[-1].strip()
        elif cur and "Used" in ln and "registers" in ln:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            out.append(f"{cur} {regs}r/{spill}B")
            cur = None
    return ", ".join(sorted(out))


def launch(lib, Qt, uv, dp, divdp, qmin, qmax, met, deriv, dt, bih=None,
           nu_coef=0.0, dp0=None, max_iter=euler.MAX_ITER):
    """ops.euler.fused_advect_limit's launch, through lib."""
    E, _, L = Qt.shape
    u, v = uv
    out = torch.empty_like(Qt)
    mn, mx = torch.empty_like(qmin), torch.empty_like(qmax)
    fn = getattr(lib, "tse_fused_advect_limit_" + euler._DTYPES[Qt.dtype])
    code = fn(Qt.data_ptr(), u.data_ptr(), v.data_ptr(), dp.data_ptr(),
              divdp.data_ptr(), met.data_ptr(), qmin.data_ptr(),
              qmax.data_ptr(), deriv.data_ptr(),
              None if bih is None else dp0.data_ptr(),
              None if bih is None else bih.data_ptr(), out.data_ptr(),
              mn.data_ptr(), mx.data_ptr(), E, L, dp.shape[-1], float(dt),
              float(nu_coef), 0 if bih is None else 2, int(max_iter),
              euler.TOL_LIMITER, euler._stream(Qt.device),
              *((None, 0) if getattr(lib, "counted", True) else ()))
    _build.check(code, "fused_advect_limit variant")
    return out, mn, mx


def timed(fn):
    fn()
    ts = []
    for _ in range(N_TIMED):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def stage_args(dtype, dev, ne=30):
    """[(args, kwargs)] of K1's three stage kinds, as chip_smoke.py phase 3
    makes them at NE30."""
    cfg = perf_config(ne, dtype=dtype, use_pallas=True)
    m = core.build_model(cfg, dev)
    E, nk, nq = m.lon.shape[0], cfg.nlev, cfg.qsize
    Qt = core._tp(core.initial_qdp(m), E, nq * nk)
    u, v, divdp, divp = build_wind_basis(m).eval(
        torch.tensor(cfg.tstep, dtype=m.dtype, device=dev))
    dp0 = m.dp0col[None, None, :].expand(E, 16, nk).contiguous()
    mn, mx = m.tables.neighbor_minmax(*m.tables.minmax_prep(Qt, dp0, nq))
    dt2 = cfg.dt_tracer / 2.0
    out = []
    for s in (0, 1, 2):
        dp = (m.dp0col[None, None, :] - s * dt2 * divp).contiguous()
        kw = dict(max_iter=cfg.limiter_iter_cap or euler.MAX_ITER)
        if s == 2:
            Q_t = (Qt.reshape(E, 16, nq, nk)
                   / dp[:, :, None, :]).reshape(Qt.shape)
            kw.update(bih=m.tables.dss_scale_t(
                euler.laplace_wk_t(Q_t, m.met, m.deriv),
                m.rspheremp.reshape(E, 16)),
                nu_coef=-3 * dt2 * cfg.nu_q, dp0=m.dp0ref)
        out.append(((Qt, (u, v), dp, divdp, mn, mx, m.met, m.deriv, dt2), kw))
    return out


def subset(args, kw, n):
    """The stage's arguments on n elements spread over the sphere."""
    E = args[0].shape[0]
    idx = torch.arange(0, E, E // n, device=args[0].device)[:n]
    pick = lambda t: t.index_select(0, idx).contiguous()  # noqa: E731
    Qt, (u, v), dp, divdp, mn, mx, met, deriv, dt = args
    return ((pick(Qt), (pick(u), pick(v)), pick(dp), pick(divdp), pick(mn),
             pick(mx), pick(met), deriv, dt),
            {k: pick(t) if k == "bih" else t for k, t in kw.items()})


def held(lib, args, kw):
    """K1 through lib == the plain version, bitwise; its time."""
    got = launch(lib, *args, **kw)
    want = euler.fused_advect_limit_plain(*args, **kw)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("variant differs from the plain version")
    return timed(lambda: launch(lib, *args, **kw))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="csrc directory of another tree's K1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    libs, usage = build_variants(args.other)
    for name in libs:
        print(f"{name} ptxas: {usage[name]}", flush=True)
    for dtype in ("f32", "f64"):
        stages = stage_args(dtype, dev)
        if args.other:
            for name in ("as_built", "other", "other", "as_built"):
                ms = [[held(libs[name], a, dict(k, max_iter=it))
                       for it in CAPS] for a, k in stages]
                print(f"{dtype} {name} at limiter caps "
                      + "/".join(map(str, CAPS)) + ": " + "; ".join(
                          f"stage {s} " + "/".join(f"{t:.3f}" for t in row)
                          for s, row in enumerate(ms)), flush=True)
        for name in ("as_built", "blocks_4_2", "blocks_2_1", "no_opaque",
                     "as_built"):
            ms = [held(libs[name], a, k) for a, k in stages]
            print(f"{dtype} {name}: stages 0/1/2 "
                  + "/".join(f"{t:.3f}" for t in ms)
                  + f" ms, mean {statistics.mean(ms):.3f}", flush=True)
        a, k = stages[1]
        for n in SUBSETS:
            sa, sk = subset(a, k, n)
            ms = [held(libs[name], sa, sk) for name in
                  ("as_built", "no_groups", "no_groups", "as_built")]
            print(f"{dtype} stage 1 on {n} elements: as_built "
                  f"{ms[0]:.4f}/{ms[3]:.4f} ms, no_groups "
                  f"{ms[1]:.4f}/{ms[2]:.4f} ms", flush=True)
        del stages
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
