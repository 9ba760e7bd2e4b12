"""K5's design choices measured on the card: the limiter-bound prep of
`csrc/dss.cu` (minmax_kernel) built beside the package's library with one
choice changed, each held bit for bit to the plain version and timed.

    python -m transport_se_tpu_torch.k5_variants [--other CSRC] [--only A,B]

from the repo root.  --other CSRC also builds the K5 of another tree's
csrc directory (its dss.cu and headers, e.g. an unpacked parent commit)
and times it in turns with this one (this, other, other, this); --only
builds and times the named variants alone (as_built always).

Variants (the source is edited in memory, built into `_build/k5_variants/`
with the package's nvcc flags, all builds started together):
  as_built       the source as it is (2 lanes a thread, 128 threads, 4
                 lane passes a block)
  ieee_divide    q = x/dp by IEEE divisions throughout
  cached_stores  the bounds stored without the evict-first hint
  one_lane       one lane a thread (no vector accesses)
  lanes_4        4 lanes a thread
  threads_256    256 threads a block
  passes_1       one lane pass a block (a dp prologue each)
  passes_2       two
  passes_8       eight

Inputs: chip_smoke.py phase 3's (x the fused stage 0's output, dp the
layer thickness after stage 1, at NE30: E = 5400, 35 x 72 lanes,
perf_config) in f32 and f64, on the whole sphere and on shard 0 of S = 8
(675 elements; every shard is checked).  Times are CUDA-event medians of 7
after a warm-up; every build is checked bit for bit (-0 included) against
the plain version before it is timed.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
from pathlib import Path

import torch

from . import _build
from .k1_variants import build_libs, stage_args, timed
from .k10_variants import same_bits
from .ops import dss_face, euler

OUT = _build.BUILD_DIR / "k5_variants"
SRC = "dss.cu"
S = 8


def edits():
    def const(name, old, new):
        return ((f"constexpr int {name} = {old};",
                 f"constexpr int {name} = {new};"),)
    return {
        "as_built": (),
        "ieee_divide": (("constexpr bool kMinmaxIeeeDivide = false;",
                         "constexpr bool kMinmaxIeeeDivide = true;"),),
        "cached_stores": (("constexpr bool kMinmaxStreamStores = true;",
                           "constexpr bool kMinmaxStreamStores = false;"),),
        "one_lane": const("kMinmaxVec", 2, 1),
        "lanes_4": const("kMinmaxVec", 2, 4),
        "threads_256": const("kMinmaxThreads", 128, 256),
        "passes_1": const("kMinmaxPasses", 4, 1),
        "passes_2": const("kMinmaxPasses", 4, 2),
        "passes_8": const("kMinmaxPasses", 4, 8),
    }


def minmax_usage(log):
    """'f32 V4 40r/0B, ...': registers and spill stores of each
    minmax_kernel instantiation (the parent's has no lane width)."""
    out, cur, spill = [], None, "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"minmax_kernelI([fd])(?:Li(\d+)E)?E", m.group(1))
            cur = None if k is None or "nbr_minmax" in m.group(1) else (
                ("f32" if k.group(1) == "f" else "f64")
                + (f" V{k.group(2)}" if k.group(2) else ""))
        elif cur and "bytes spill stores" in ln:
            spill = ln.split("bytes spill stores")[0].split(",")[-1].strip()
        elif cur and "Used" in ln and "registers" in ln:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            out.append(f"{cur} {regs}r/{spill}B")
            cur = None
    return ", ".join(sorted(out))


def launch(lib, x, dp):
    """ops.dss_face.minmax_prep's launch through lib."""
    E, _, L = x.shape
    qmin, qmax = x.new_empty((E, L)), x.new_empty((E, L))
    fn = getattr(lib, "tse_minmax_prep_" + euler._DTYPES[x.dtype])
    code = fn(x.data_ptr(), dp.data_ptr(), qmin.data_ptr(), qmax.data_ptr(),
              E, L, dp.shape[-1], euler._stream(x.device))
    _build.check(code, f"minmax_prep of {Path(lib._name).parent.name}")
    return qmin, qmax


def config(lib, L, nk, dtype):
    buf = (ctypes.c_int * 5)()
    fn = getattr(lib, "tse_minmax_config_" + euler._DTYPES[dtype])
    fn.argtypes = _build.ENTRIES["tse_minmax_config"]
    fn.restype = ctypes.c_int
    _build.check(fn(int(L), int(nk), buf), "minmax_config")
    return "/".join(map(str, buf))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="csrc directory of another tree's K5")
    ap.add_argument("--only", help="comma-separated variants to build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    variants = edits()
    if args.only:
        keep = {"as_built", *args.only.split(",")}
        variants = {k: v for k, v in variants.items() if k in keep}
    sources = {name: (_build.CSRC, e) for name, e in variants.items()}
    if args.other:
        sources["other"] = (Path(args.other), ())
    libs, logs = build_libs(OUT, SRC, sources, ("tse_minmax_prep",))
    for name, log in logs.items():
        shape = "" if name == "other" else (
            "; launch shape (lanes a thread/threads/lane groups an element/"
            "shared B/blocks an SM) f32 "
            + config(libs[name], 2520, 72, torch.float32) + ", f64 "
            + config(libs[name], 2520, 72, torch.float64))
        print(f"{name} ptxas minmax_kernel: {minmax_usage(log)}{shape}",
              flush=True)
    order = list(variants) + ["as_built"]
    if args.other:
        order = ["as_built", "other", "other", "as_built"] + order[1:]
    for dtype in ("f32", "f64"):
        stages = stage_args(dtype, dev)
        a0, k0 = stages[0]
        x = euler.fused_advect_limit_plain(*a0, **k0)[0]
        dp = stages[1][0][2]               # stage 1's layer thickness
        del stages, a0, k0
        E = x.shape[0]
        eloc = E // S
        cases = {"sphere": (x, dp)}
        cases.update({f"shard {r}": (x[r * eloc:(r + 1) * eloc],
                                     dp[r * eloc:(r + 1) * eloc])
                      for r in range(S)})
        nq = x.shape[-1] // dp.shape[-1]
        want = {k: dss_face.minmax_prep_plain(xc, dc, nq)
                for k, (xc, dc) in cases.items()}
        ms = {"sphere": {}, "shard 0": {}}
        for name in order:
            for k, (xc, dc) in cases.items():
                if not same_bits(launch(libs[name], xc, dc), want[k]):
                    raise AssertionError(f"{name} {dtype} {k} differs from "
                                         "the plain version")
            for k in ms:
                xc, dc = cases[k]
                ms[k].setdefault(name, []).append(
                    timed(lambda: launch(libs[name], xc, dc)))
        for k, v in ms.items():
            print(f"{dtype} {k} ms: " + ", ".join(
                f"{n} " + "/".join(f"{t:.4f}" for t in ts)
                for n, ts in v.items()), flush=True)
        del x, dp, cases, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
