"""K4's design choices measured on the card: the face DSS kernel of
`csrc/dss.cu` (dss_face_kernel) built beside the package's library with
one choice changed, each held bit for bit against the plain version and
timed.

    python -m transport_se_tpu_torch.k4_variants [--other CSRC] [--only A,B]

from the repo root.  --other CSRC also builds the K4 of another tree's
csrc directory (its dss.cu and headers, e.g. an unpacked parent commit)
and times it in turns with this one (this, other, other, this); --only
builds and times the named variants alone (as_built always).

Variants (the source is edited in memory, built into `_build/k4_variants/`
with the package's nvcc flags, all builds started together; a variant whose
table edit leaves one dtype's Shape as it is builds that dtype as built):
  as_built       the source as it is (its Shape tables)
  ieee_divide    q = out/dp by IEEE divisions throughout (kFaceIeeeDivide)
  cached_stores  the outputs stored without the evict-first hint
  one_lane       one lane a thread in every case (no vector accesses)
  wide           twice the as-built lanes a thread, at most 4, every case
  threads_128    128 threads a block, one block an SM asked, every case
  threads_256    256 threads a block, 2 blocks an SM asked (128 registers)
  passes_1       one lane pass a block in the min/max cases (a prologue
                 each; the others keep theirs)
  passes_2       two
  passes_8       eight
  lane_major     the grid lane-group-major (every element's lane group 0
                 first) instead of element-major

Inputs: chip_smoke.py phase 3's, at NE30 (E = 5400, 35 x 72 lanes,
perf_config) in f32 and f64: x the fused stage 0's output, the state as
the time average's input, dp the layer thickness after stage 1, the
model's rspheremp, metric pack and derivative matrix.  Each build runs
K4's seven launch cases (raw, scale, +avg, +min/max, +avg+min/max,
+min/max+Laplacian, +avg+min/max+Laplacian); every launch is checked bit
for bit (-0 included) against dss_face_plain before it is timed.  Times
are CUDA-event medians of 7 after a warm-up, beside each case's bound
(bytes at 3.35 TB/s) and, per build, the launch-weighted time of K4's 12
launches of a face subcycle.  First it prints which of two tied zeros
torch.amin and torch.amax keep on the card, against the points' order
that K4 and its plain version follow.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
from pathlib import Path

import torch

from . import _build
from .config import perf_config
from .k1_variants import build_libs, stage_args, timed
from .k10_variants import same_bits
from .model import core
from .ops import dss_face, euler

OUT = _build.BUILD_DIR / "k4_variants"
SRC = "dss.cu"
CASES = tuple(dss_face.FACE_CASES)
NAMES = ("vec", "threads", "min_blocks", "passes")
# Shape's indices of the min/max cases
MINMAX_CASES = (3, 4, 5, 6)
# K4's launches a face subcycle by case (model/core.py: each of the 3
# tracer steps runs stage 0 with min/max, stage 1 with min/max and the
# Laplacian, stage 2's hyperviscosity input scaled, and its output with
# the time average, with min/max on the first two steps)
SUBCYCLE = {"scale": 3, "minmax": 3, "minmax+lap": 3, "avg+minmax": 2,
            "avg": 1}
HBM_BYTES_PER_S = 3.35e12


def shape_table(src, dtype):
    """(text, {name: [7 ints]}) of dss.cu's Shape<float|double> block."""
    t = "float" if dtype == "f32" else "double"
    m = re.search(r"struct Shape<%s> \{\n(.*?)\n\};" % t, src, re.S)
    vals = {k: [int(v) for v in re.search(
        r"int %s\[7\] = \{([^}]*)\}" % k, m.group(1)).group(1).split(",")]
        for k in NAMES}
    return m.group(0), vals


def shape_edit(src, dtype, **change):
    """The (old, new) edit of one Shape block: change maps a table name to
    a function of its 7 values."""
    old, vals = shape_table(src, dtype)
    new = old
    for k, fn in change.items():
        a = "int %s[7] = {%s}" % (k, ", ".join(map(str, vals[k])))
        b = "int %s[7] = {%s}" % (k, ", ".join(map(str, fn(vals[k]))))
        new = new.replace(a, b)
    return old, new


def switch(name, value):
    """The (old, new) edit of a bool switch of dss.cu set to value."""
    return (f"constexpr bool {name} = {str(not value).lower()};",
            f"constexpr bool {name} = {str(value).lower()};")


def edits(src=None):
    """{variant: ((old, new), ...)}: the in-memory edits of dss.cu."""
    if src is None:
        src = (_build.CSRC / SRC).read_text()

    def both(**change):
        """the edits of both dtypes' tables, less one that leaves its table
        as it is (that dtype's build is then the as-built kernel)"""
        return tuple(e for e in (shape_edit(src, d, **change)
                                 for d in ("f32", "f64")) if e[0] != e[1])

    def passes(n):
        return both(passes=lambda v: [n if i in MINMAX_CASES else p
                                      for i, p in enumerate(v)])
    return {
        "as_built": (),
        "ieee_divide": (switch("kFaceIeeeDivide", True),),
        "cached_stores": (switch("kFaceStreamStores", False),),
        "one_lane": both(vec=lambda v: [1] * 7),
        "wide": both(vec=lambda v: [min(2 * w, 4) for w in v]),
        "threads_128": both(threads=lambda v: [128] * 7,
                            min_blocks=lambda v: [1] * 7),
        "threads_256": both(threads=lambda v: [256] * 7,
                            min_blocks=lambda v: [2] * 7),
        "passes_1": passes(1),
        "passes_2": passes(2),
        "passes_8": passes(8),
        "lane_major": (switch("kFaceLaneMajor", True),),
    }


def face_usage(log):
    """'f32 scale V4 40r/0B, ...': registers and spill stores of each
    dss_face_kernel instantiation (the parent's has no rspheremp flag and
    no lane width: its raw and scale cases are one kernel)."""
    out, cur, spill = [], None, "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"dss_face_kernelI([fd])((?:Lb[01]E){3,4})"
                          r"(?:Li(\d+)E)?", m.group(1))
            cur = None
            if k is not None:
                b = [x == "1" for x in re.findall(r"Lb([01])", k.group(2))]
                if len(b) == 3:
                    b = [True] + b
                scale, avg, mm, lap = b
                name = next((n for n, (f, s) in dss_face.FACE_CASES.items()
                             if (f, s) == (avg | mm << 1 | lap << 2, scale)),
                            "?")
                cur = (("f32" if k.group(1) == "f" else "f64") + f" {name}"
                       + (f" V{k.group(3)}" if k.group(3) else ""))
        elif cur and "bytes spill stores" in ln:
            spill = ln.split("bytes spill stores")[0].split(",")[-1].strip()
        elif cur and "Used" in ln and "registers" in ln:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            out.append(f"{cur} {regs}r/{spill}B")
            cur = None
    return ", ".join(sorted(out))


def config(lib, L, nk, dtype):
    """'raw 4/128/5/0/4, ...': each case's launch shape through lib."""
    out = []
    buf = (ctypes.c_int * 5)()
    fn = getattr(lib, "tse_dss_face_config_" + euler._DTYPES[dtype])
    fn.argtypes = _build.ENTRIES["tse_dss_face_config"]
    fn.restype = ctypes.c_int
    for name, (flags, scale) in dss_face.FACE_CASES.items():
        _build.check(fn(int(L), int(nk), flags, int(scale), buf),
                     "dss_face_config")
        out.append(f"{name} " + "/".join(map(str, buf)))
    return ", ".join(out)


def launch(lib, x, ft, rsp=None, avg=None, dp=None, met=None, deriv=None):
    """ops.dss_face.dss_face's launch through lib."""
    E, _, L = x.shape
    nk = 1 if dp is None else dp.shape[-1]
    out = torch.empty_like(x)
    qmin = qmax = lap = None
    if dp is not None:
        qmin, qmax = x.new_empty((E, L)), x.new_empty((E, L))
    if met is not None:
        lap = torch.empty_like(x)
    flags = (int(avg is not None) | int(dp is not None) << 1
             | int(met is not None) << 2)

    def ptr(a):
        return None if a is None else a.data_ptr()
    fn = getattr(lib, "tse_dss_face_" + euler._DTYPES[x.dtype])
    code = fn(x.data_ptr(), ft.part.data_ptr(), ptr(rsp), ptr(avg), ptr(dp),
              ptr(met), ptr(deriv), out.data_ptr(), ptr(qmin), ptr(qmax),
              ptr(lap), E, L, nk, flags, euler._stream(x.device))
    _build.check(code, f"dss_face of {Path(lib._name).parent.name}")
    if dp is None:
        return out
    return (out, qmin, qmax) + ((lap,) if met is not None else ())


def case_bytes(name, E, L, nk, es):
    """Bytes K4 must move in launch case name (chip_smoke.py dss_cost):
    the field in and out, the partner table, rspheremp, and per case the
    average, dp and the two bounds, the metric pack and the Laplacian."""
    flags, scale = dss_face.FACE_CASES[name]
    F = E * 16 * L
    return (2 * F * es + E * 48 * 8 + (E * 16 * es if scale else 0)
            + (F * es if flags & 1 else 0)
            + ((E * 16 * nk + 2 * E * L) * es if flags & 2 else 0)
            + ((F + E * 160 + 16) * es if flags & 4 else 0))


def inputs(dtype, dev, ne=30):
    """(x, FaceTables, rsp, avg, dp, met, deriv): phase 3's K4 inputs."""
    stages = stage_args(dtype, dev, ne=ne)
    a0, k0 = stages[0]
    x = euler.fused_advect_limit(*a0, **k0)[0]
    dp = stages[1][0][2]
    del stages, a0, k0
    m = core.build_model(perf_config(ne, dtype=dtype, use_pallas=True), dev)
    E, nq, nk = m.lon.shape[0], m.cfg.qsize, m.cfg.nlev
    avg = core._tp(core.initial_qdp(m), E, nq * nk)
    return (x, m.tables.face, m.rspheremp.reshape(E, 16), avg, dp, m.met,
            m.deriv)


# columns whose min (rest 1) or max (rest -1) ties +0 with -0: {point:
# zero}
TIED_ZEROS = ({1: -0.0, 4: 0.0}, {0: 0.0, 15: -0.0}, {3: -0.0, 9: 0.0},
              {2: 0.0, 5: -0.0}, {6: -0.0, 7: 0.0}, {12: 0.0, 13: -0.0})


def tie_order(dev, L=2520):
    """'p1=-0,p4=+0 first, ...': for each tie of TIED_ZEROS, whether
    torch.amin and torch.amax over the points of a [3, 16, L] field on dev
    keep the first point's zero (as K4, K5 and their plain versions do:
    ops/dss_face.py _point_minmax) or another's."""
    out = []
    for dtype in (torch.float32, torch.float64):
        for tie in TIED_ZEROS:
            first = torch.signbit(torch.tensor(tie[min(tie)])).item()
            keeps = []
            for op, fill in ((torch.amin, 1.0), (torch.amax, -1.0)):
                x = torch.full((3, 16, L), fill, dtype=dtype, device=dev)
                for p, v in tie.items():
                    x[:, p] = v
                sign = torch.signbit(op(x, dim=1))
                keeps.append(bool((sign == first).all()))
            name = ",".join(f"p{p}={'-' if str(v)[0] == '-' else '+'}0"
                            for p, v in tie.items())
            out.append(f"{euler._DTYPES[dtype]} {name} "
                       + "/".join("first" if k else "another" for k in keeps))
    return ", ".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="csrc directory of another tree's K4")
    ap.add_argument("--only", help="comma-separated variants to build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    print("torch.amin/amax over 16 points on tied zeros (which zero they "
          f"keep): {tie_order(dev)}", flush=True)
    variants = edits()
    if args.only:
        keep = {"as_built", *args.only.split(",")}
        variants = {k: v for k, v in variants.items() if k in keep}
    sources = {name: (_build.CSRC, e) for name, e in variants.items()}
    if args.other:
        sources["other"] = (Path(args.other), ())
    libs, logs = build_libs(OUT, SRC, sources, ("tse_dss_face",))
    for name, log in logs.items():
        shape = "" if name == "other" else (
            "; launch shape (lanes a thread/threads/lane groups an element/"
            "shared B/blocks an SM) f32 "
            + config(libs[name], 2520, 72, torch.float32) + "; f64 "
            + config(libs[name], 2520, 72, torch.float64))
        print(f"{name} ptxas dss_face_kernel: {face_usage(log)}{shape}",
              flush=True)
    order = list(variants) + ["as_built"]
    if args.other:
        order = ["as_built", "other", "other", "as_built"] + order[1:]
    for dtype in ("f32", "f64"):
        x, ft, rsp, avg, dp, met, deriv = inputs(dtype, dev)
        E, _, L = x.shape
        nk = dp.shape[-1]
        ms = {}
        for case in CASES:
            kw = dss_face.face_case(case, rsp, avg, dp, met, deriv)
            want = dss_face.dss_face_plain(x, ft, **kw)
            for name in order:
                got = launch(libs[name], x, ft, **kw)
                if not same_bits(got, want):
                    raise AssertionError(f"{name} {dtype} {case} differs "
                                         "from the plain version")
                del got
                ms.setdefault(name, {}).setdefault(case, []).append(
                    timed(lambda: launch(libs[name], x, ft, **kw)))
            del want
            b = case_bytes(case, E, L, nk, x.element_size()) \
                / HBM_BYTES_PER_S * 1e3
            print(f"{dtype} {case} (bound {b:.4f} ms): " + ", ".join(
                f"{n} " + "/".join(f"{t:.4f}" for t in v[case])
                for n, v in ms.items()), flush=True)
        wb = sum(w * case_bytes(c, E, L, nk, x.element_size())
                 for c, w in SUBCYCLE.items()) / HBM_BYTES_PER_S * 1e3
        for name, v in ms.items():
            t = sum(w * statistics.mean(v[c]) for c, w in SUBCYCLE.items())
            print(f"{dtype} {name}: a face subcycle's 12 launches "
                  f"{t:.4f} ms against {wb:.4f} bound, {wb / t:.1%}",
                  flush=True)
        del x, ft, rsp, avg, dp, met, deriv
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
