"""K10's design choices measured on the card: the row limiter of
`csrc/limiter.cu` built beside the package's library with one choice
changed, each held bit for bit to the plain version and timed.

    python -m transport_se_tpu_torch.k10_variants [--other CSRC] [--only A,B]

from the repo root.  --other CSRC also builds the K10 of another tree's
csrc directory (its limiter.cu and headers, e.g. an unpacked parent
commit) and times it in turns with this one (this, other, other, this);
--only builds and times the named variants alone (as_built always).

Variants (the source is edited in memory, built into
`_build/k10_variants/` with the package's nvcc flags, all builds started
together):
  as_built        the source as it is (its Shape table: f32 a thread a
                  row, f64 a quad of lanes a row, 128 threads a block)
  ieee_divide     x = ptens/dpmass by IEEE divisions throughout
  stream_stores   the output stored with the evict-first hint
  other_lanes     f32 a quad a row, f64 a thread a row
  threads_256     256 threads a block
  threads_512     512 threads a block
  more_blocks     __launch_bounds__ asks 4 blocks an SM in f32 (128
                  registers) and 12 in f64 (40)

Inputs, each NE30 (E = 5400, 4 tracers x 72 levels, 1,555,200 rows):
  stage 0         chip_smoke.py phase 8's: the DCMIP 1-1 stage 0 at t = 0
                  with its neighbour bounds, f64 and f32
  steady          the nine K10 launches of the third subcycle of a
                  steady-state std NE30 f64 DCMIP 1-2 run (chip_smoke.py
                  phase 12's configuration), timed together
For each input the share of rows the limiter changes, of rows with a
relaxed bound, and the histogram of the iteration's passes per row (0: a
row whose weights sum to <= 0).  Times are CUDA-event medians of 7 after a
warm-up; every build is checked bit for bit (-0 included) against the
plain version, through the std stage's operands and through [N, 16]
operands, before it is timed.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
from pathlib import Path

import torch

from . import _build
from .config import dcmip11_ne30, dcmip12_ne30
from .k1_variants import build_libs, timed
from .model import core
from .ops import euler, limiter

OUT = _build.BUILD_DIR / "k10_variants"
SRC = "limiter.cu"
F32 = ("struct Shape<float> {\n"
       "  static constexpr int lanes = 1, threads = 128, min_blocks = 1;")
F64 = ("struct Shape<double> {\n"
       "  static constexpr int lanes = 4, threads = 128, min_blocks = 1;")
EDITS = {
    "as_built": (),
    "ieee_divide": (("constexpr bool kIeeeDivide = false;",
                     "constexpr bool kIeeeDivide = true;"),),
    "stream_stores": (("constexpr bool kStreamStores = false;",
                       "constexpr bool kStreamStores = true;"),),
    "other_lanes": ((F32, F32.replace("lanes = 1", "lanes = 4")),
                    (F64, F64.replace("lanes = 4", "lanes = 1"))),
    "threads_256": ((F32, F32.replace("128", "256")),
                    (F64, F64.replace("128", "256"))),
    "threads_512": ((F32, F32.replace("128", "512")),
                    (F64, F64.replace("128", "512"))),
    "more_blocks": ((F32, F32.replace("min_blocks = 1", "min_blocks = 4")),
                    (F64, F64.replace("min_blocks = 1", "min_blocks = 12"))),
}


def limiter_usage(log):
    """'f32 40r/0B, f64 ...': registers and spill stores of limiter_kernel."""
    out, cur, spill = [], None, "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            # limiter_kernel<T> of older trees, or <T, COUNT>
            k = re.search(r"limiter_kernelI([fd])(?:Lb([01])E)?E",
                          m.group(1))
            cur = None if k is None else (
                ("f32" if k.group(1) == "f" else "f64")
                + ("+count" if k.group(2) == "1" else ""))
        elif cur and "bytes spill stores" in ln:
            spill = ln.split("bytes spill stores")[0].split(",")[-1].strip()
        elif cur and "Used" in ln and "registers" in ln:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            out.append(f"{cur} {regs}r/{spill}B")
            cur = None
    return ", ".join(sorted(out))


def launch(lib, ptens, sph, dp, minp, maxp, reps):
    """ops.limiter._launch through lib; reps = (sph_rep, sph_inner, dp_rep,
    dp_inner)."""
    out = torch.empty_like(ptens)
    mn, mx = torch.empty_like(minp), torch.empty_like(maxp)
    fn = getattr(lib, "tse_limiter_optim_" + euler._DTYPES[ptens.dtype])
    code = fn(ptens.data_ptr(), sph.data_ptr(), dp.data_ptr(),
              minp.data_ptr(), maxp.data_ptr(), out.data_ptr(),
              mn.data_ptr(), mx.data_ptr(), ptens.numel() // 16, *reps,
              euler.TOL_LIMITER, euler._stream(ptens.device))
    _build.check(code, f"limiter_optim of {Path(lib._name).parent.name} "
                 f"on {ptens.numel() // 16} rows, reps {reps}")
    return out, mn, mx


def stage_launch(lib, args):
    """limiter_optim_stage's launch of args = (ptens [E,q,k,16], spheremp
    [E,16], dp_star [E,k,16], minp, maxp) through lib."""
    ptens, sph, dp, mn, mx = args
    _, q, k, _ = ptens.shape
    return launch(lib, ptens, sph, dp, mn, mx, (q * k, 1, q, k))


def full_launch(lib, args):
    """The same rows through [N, 16] operands (limiter_optim_iter_full)."""
    ptens, sph, dp, mn, mx = args
    sph = sph[:, None, None].expand(ptens.shape).contiguous()
    dp = dp[:, None].expand(ptens.shape).contiguous()
    return launch(lib, ptens, sph, dp, mn, mx, (1, 1, 1, 1))


def bits(a):
    """a's bits as integers (so -0 and +0 differ)."""
    return a.view(torch.int32 if a.element_size() == 4 else torch.int64)


def same_bits(got, want):
    return all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want))


def stage0_input(model):
    """chip_smoke.py phase 8's limiter arguments: stage 0 of the model's
    initial state (DCMIP winds at t = 0, the neighbour bounds), as the std
    step makes them: (ptens, spheremp, dp_star, qmin, qmax)."""
    c = model.cfg
    Qdp = core.initial_qdp(model)
    vn0 = core.dcmip.winds(c.test_case, model.lon, model.lat, model.etam,
                           0.0) * model.dp0col[None, :, None, None, None]
    divdp = core.so.divergence_sphere(vn0, model.deriv, model.Dinv,
                                      model.metdet, model.rmetdet)
    zero = Qdp.new_zeros(Qdp.shape[:3])
    Qtens, qmn, qmx, dp_star = core.euler_stage_tens(
        model, Qdp, zero, zero, divdp, divdp, vn0, c.dt_tracer / 2.0, 0)
    return (*core.limiter_args(model, Qtens, dp_star), qmn, qmx)


def steady_inputs(model, subcycle=3):
    """The arguments of every K10 launch of the subcycle-th subcycle of the
    model's std run from its initial state: [(ptens, spheremp, dp_star,
    qmin, qmax)], copies."""
    seen = []
    kernel = core.limiter_optim_stage

    def record(*args, **kw):
        seen.append(tuple(a.clone() for a in args))
        return kernel(*args, **kw)
    step = core.make_subcycle_fn(model)
    Qdp, nstep = core.initial_qdp(model), 0
    for i in range(subcycle):
        if i == subcycle - 1:
            core.limiter_optim_stage = record
        try:
            Qdp, _, nstep, _ = step(Qdp, nstep)
        finally:
            core.limiter_optim_stage = kernel
    return seen


def passes(args):
    """Per row, the passes of the clip-and-redistribute iteration that the
    kernel runs (0 for a row whose weights sum to <= 0, 15 for a row that
    does not converge): limiter_iterate_plain's loop, counted."""
    ptens, sph, dp, minp, maxp = args
    sph, dp = sph[:, None, None], dp[:, None]
    x, c = ptens / dp, sph * dp
    one = c.new_full((), 1.0)
    sumc = euler._sum16(c)
    mass = euler._sum16(c * x)
    valid = sumc > 0
    safe = torch.where(valid, sumc, one)
    lo = torch.where(mass < minp * safe, mass / safe, minp)[..., None]
    hi = torch.where(mass > maxp * safe, mass / safe, maxp)[..., None]
    tol = euler.TOL_LIMITER * torch.abs(mass)
    n = torch.where(valid, euler.MAX_ITER, 0)
    done = ~valid
    for it in range(euler.MAX_ITER):
        xcl = torch.clamp(x, lo, hi)
        addmass = euler._sum16((x - xcl) * c)
        conv = torch.abs(addmass) <= tol
        n = torch.where(conv & ~done, it + 1, n)
        done = done | conv
        if bool(done.all()):
            break
        free = torch.where((addmass > 0)[..., None], xcl < hi, xcl > lo)
        wsum = euler._sum16(torch.where(free, c, 0.0))
        add = torch.where(wsum > 0,
                          addmass / torch.where(wsum > 0, wsum, one), 0.0)
        add = torch.where(conv, 0.0, add)[..., None]
        x = torch.where(free, xcl + add, xcl)
    return n


def describe(inputs):
    """'x% of rows limited, y% relaxed; passes 0:a 1:b ...' over inputs."""
    nrows = limited = relaxed = 0
    hist = torch.zeros(euler.MAX_ITER + 1, dtype=torch.int64)
    for args in inputs:
        ptens, _, _, mn, mx = args
        out, omn, omx = limiter.limiter_optim_stage(*args, plain=True)
        nrows += mn.numel()
        limited += int((out != ptens).any(-1).sum())
        relaxed += int(((omn != mn) | (omx != mx)).sum())
        hist += torch.bincount(passes(args).reshape(-1).cpu(),
                               minlength=euler.MAX_ITER + 1)
        del out, omn, omx
    return (f"{limited / nrows:.2%} of {nrows} rows limited, "
            f"{relaxed / nrows:.2%} relaxed; passes per row "
            + " ".join(f"{i}:{int(v)}" for i, v in enumerate(hist) if v))


def config(lib, dtype):
    buf = (ctypes.c_int * 3)()
    fn = getattr(lib, "tse_limiter_config_" + euler._DTYPES[dtype])
    fn.argtypes = _build.ENTRIES["tse_limiter_config"]
    fn.restype = ctypes.c_int
    _build.check(fn(buf), "limiter_config")
    return "/".join(map(str, buf))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="csrc directory of another tree's K10")
    ap.add_argument("--only", help="comma-separated variants to build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    variants = dict(EDITS)
    if args.only:
        keep = {"as_built", *args.only.split(",")}
        variants = {k: v for k, v in variants.items() if k in keep}
    sources = {name: (_build.CSRC, e) for name, e in variants.items()}
    if args.other:
        sources["other"] = (Path(args.other), ())
    libs, logs = build_libs(OUT, SRC, sources, ("tse_limiter_optim",))
    for name, log in logs.items():
        shape = ""
        if name != "other":
            shape = ("; launch shape (lanes a row/threads/blocks an SM) f32 "
                     + config(libs[name], torch.float32) + ", f64 "
                     + config(libs[name], torch.float64))
        print(f"{name} ptxas limiter_kernel: {limiter_usage(log)}{shape}",
              flush=True)
    order = list(variants) + ["as_built"]
    if args.other:
        order = ["as_built", "other", "other", "as_built"] + order[1:]

    def hold(name, inputs, what):
        """Bit for bit against the plain version, through both operand
        forms; then the time of the stage launches of inputs together."""
        lib = libs[name]
        for a in inputs:
            want = limiter.limiter_optim_stage(*a, plain=True)
            for form in (stage_launch, full_launch):
                if not same_bits(form(lib, a), want):
                    raise AssertionError(f"{name} {what}: {form.__name__} "
                                         "differs from the plain version")
            del want
        return timed(lambda: [stage_launch(lib, a) for a in inputs])

    cases = []
    for dtype in ("f64", "f32"):
        m = core.build_model(dcmip11_ne30(dtype=dtype), dev)
        cases.append((f"{dtype} stage 0", [stage0_input(m)]))
        del m
    m = core.build_model(dcmip12_ne30(), dev)
    cases.append(("f64 steady (9 launches)", steady_inputs(m)))
    del m
    for what, inputs in cases:
        print(f"{what}: {describe(inputs)}", flush=True)
        ms = {}
        for name in order:
            ms.setdefault(name, []).append(hold(name, inputs, what))
        print(f"{what} ms: " + ", ".join(
            f"{n} " + "/".join(f"{t:.4f}" for t in v)
            for n, v in ms.items()), flush=True)
        del inputs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
