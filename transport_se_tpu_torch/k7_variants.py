"""K7's design choices measured on the card: the banded face DSS kernel of
`csrc/band.cu` built beside the package's library with one choice changed,
each held bitwise against the plain version and timed.

    python -m transport_se_tpu_torch.k7_variants [--other CSRC] [--only A,B]

from the repo root.  --other CSRC also builds the K7 of another tree's
csrc directory (its band.cu and headers, e.g. an unpacked parent commit)
and times it in turns with this one (this, other, other, this); --only
builds and times the named variants alone (as_built always).

Variants (the source is edited in memory, built into `_build/k7_variants/`
with the package's nvcc flags, all builds started together):
  as_built       the source as it is (its Shape tables)
  ieee_divide    q = out/dp by IEEE divisions throughout (kIeeeDivide)
  cached_stores  the outputs stored without the evict-first hint
  one_lane       one lane a thread in every variant (no vector accesses)
  wide           4 lanes a thread in f32 and 2 in f64 in every variant
  threads_128    128 threads a block, no register bound (f64 changes)
  threads_256    256 threads a block, 2 blocks an SM asked (128 registers)
  passes_2       two lane passes a block with min/max (a prologue each)
  passes_8       eight

Times are CUDA-event medians of 7 after a warm-up, of the four variants
(raw, scale, scale+min/max, scale+min/max+Laplacian) at NE30 (E = 5400,
35 x 72 lanes, perf_config; chip_smoke.py phase 13's inputs) at S = 1 (one
shard holds the sphere) and on shard 0 of S = 8 (675 elements, partners in
the halo); then as_built and ieee_divide on the scale+min/max+Laplacian
input of a steady-state sharded NE30 f32 subcycle (S = 1, the second
subcycle), with the share of its columns that hold an assembled value
outside the inline division's range.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import re
import statistics
from pathlib import Path

import torch

from . import _build
from .config import perf_config
from .k1_variants import build_libs, timed
from .model import core
from .model.wind_basis import build_wind_basis
from .ops import band, dss_face, euler
from .parallel import comm, face_sharded, halo, sharded

OUT = _build.BUILD_DIR / "k7_variants"
KINDS = ("raw", "scale", "scale+minmax", "scale+minmax+lap")
NAMES = ("vec", "threads", "min_blocks", "passes")


def shape_table(src, dtype):
    """(text, {name: [4 ints]}) of band.cu's Shape<float|double> block."""
    t = "float" if dtype == "f32" else "double"
    m = re.search(r"struct Shape<%s> \{\n(.*?)\n\};" % t, src, re.S)
    vals = {k: [int(v) for v in re.search(
        r"int %s\[4\] = \{([^}]*)\}" % k, m.group(1)).group(1).split(",")]
        for k in NAMES}
    return m.group(0), vals


def shape_edit(src, dtype, **change):
    """The (old, new) edit of one Shape block: change maps a table name to
    a function of its 4 values."""
    old, vals = shape_table(src, dtype)
    new = old
    for k, fn in change.items():
        a = "int %s[4] = {%s}" % (k, ", ".join(map(str, vals[k])))
        b = "int %s[4] = {%s}" % (k, ", ".join(map(str, fn(vals[k]))))
        new = new.replace(a, b)
    return old, new


def edits():
    src = (_build.CSRC / "band.cu").read_text()

    def both(**change):
        return tuple(shape_edit(src, d, **change) for d in ("f32", "f64"))

    def each(f32, f64):
        return (shape_edit(src, "f32", **f32), shape_edit(src, "f64", **f64))
    wide = (dict(vec=lambda v: [4] * 4), dict(vec=lambda v: [2] * 4))
    return {
        "as_built": (),
        "ieee_divide": (("constexpr bool kIeeeDivide = false;",
                         "constexpr bool kIeeeDivide = true;"),),
        "cached_stores": (("constexpr bool kStreamStores = true;",
                           "constexpr bool kStreamStores = false;"),),
        "one_lane": both(vec=lambda v: [1] * 4),
        "wide": each(*wide),
        "threads_128": both(threads=lambda v: [128] * 4,
                            min_blocks=lambda v: [1] * 4),
        "threads_256": both(threads=lambda v: [256] * 4,
                            min_blocks=lambda v: [2] * 4),
        "passes_2": both(passes=lambda v: [1, 1, 2, 2]),
        "passes_8": both(passes=lambda v: [1, 1, 8, 8]),
    }


def band_usage(log):
    """'f32 raw V4 40r/0B, ...': registers and spill stores of each
    dss_band_kernel instantiation."""
    out, cur, spill = [], None, "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"dss_band_kernelI([fd])Lb([01])ELb([01])ELb([01])"
                          r"ELi(\d+)E", m.group(1))
            cur = None if k is None else (
                ("f32" if k.group(1) == "f" else "f64") + " "
                + KINDS[[int(b) for b in k.group(2, 3, 4)].count(1)]
                + f" V{k.group(5)}")
        elif cur and "bytes spill stores" in ln:
            spill = ln.split("bytes spill stores")[0].split(",")[-1].strip()
        elif cur and "Used" in ln and "registers" in ln:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            out.append(f"{cur} {regs}r/{spill}B")
            cur = None
    return ", ".join(out)


def launch(lib, x, halo_rows, t, rsp=None, dp=None, nq=None, lap=False,
           stream=None):
    """ops.band.dss_band's launch through lib (x, the halo rows and the
    tables on one device; stream None: the device's current stream)."""
    E, _, L = x.shape
    nk = 1 if dp is None else dp.shape[-1]
    out = torch.empty_like(x)
    qmin = qmax = lapo = None
    if dp is not None:
        qmin, qmax = x.new_empty((E, L)), x.new_empty((E, L))
    if lap:
        lapo = torch.empty_like(x)
    flags = int(rsp is not None) | int(dp is not None) << 1 | int(lap) << 2

    def ptr(a):
        return None if a is None else a.data_ptr()
    if stream is None:
        stream = euler._stream(x.device)
    fn = getattr(lib, "tse_dss_band_" + euler._DTYPES[x.dtype])
    code = fn(x.data_ptr(), halo_rows.data_ptr(), t.role.data_ptr(),
              ptr(rsp), ptr(dp), ptr(t.met if lap else None),
              ptr(t.deriv if lap else None), out.data_ptr(), ptr(qmin),
              ptr(qmax), ptr(lapo), E, L, nk, flags, stream)
    _build.check(code, "dss_band variant")
    if dp is None:
        return out
    return (out, qmin, qmax) + ((lapo,) if lap else ())


def bits(a):
    """a's bits as integers (so -0 and +0, and NaN payloads, differ)."""
    return a.view(torch.int32 if a.element_size() == 4 else torch.int64)


def same_bits(got, want):
    if isinstance(want, torch.Tensor):
        got, want = (got,), (want,)
    return all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want))


def shard(m, S, r):
    """(slice, halo_gid, ShardedFaceTables) of shard r of m's raster grid
    cut into S chunks."""
    g, ne = m.grid, m.cfg.ne
    plan = halo.build_shard_plan(g, S)
    ftd = dss_face.build_face_tables(g.part_idx, g.part_mask, ne)
    stack = face_sharded.build_sharded_face_tables(g, plan, ftd)
    roles = face_sharded.band_roles(plan, ftd, ne)
    sl = slice(r * plan.eloc, (r + 1) * plan.eloc)
    t = face_sharded.ShardedFaceTables.from_stack(
        stack, roles, r, plan.nhalo, m.device, met=m.met[sl], deriv=m.deriv)
    return sl, torch.as_tensor(plan.halo_gid[r], device=m.device), t


def halo_rows(x, hg):
    return torch.where((hg >= 0)[:, None, None],
                       x.index_select(0, hg.clamp(min=0)), 0.0)


def cases(dtype, dev, ne=30):
    """{(S, kind): (x, halo, t, kwargs)} of chip_smoke.py phase 13's
    inputs: the state of perf_config(ne) and stage 1's dp, at S = 1 and on
    shard 0 of S = 8."""
    m = core.build_model(perf_config(ne, dtype=dtype, use_pallas=True), dev)
    cfg = m.cfg
    E, nq, nk = m.lon.shape[0], cfg.qsize, cfg.nlev
    x = core._tp(core.initial_qdp(m), E, nq * nk)
    divp = build_wind_basis(m).eval(
        torch.tensor(cfg.tstep, dtype=m.dtype, device=dev))[3]
    dp = (m.dp0col[None, None, :] - cfg.dt_tracer / 2.0 * divp).contiguous()
    rsp = m.rspheremp.reshape(E, 16)
    out = {}
    for S in (1, 8):
        sl, hg, t = shard(m, S, 0)
        h = halo_rows(x, hg)
        xs = x[sl].contiguous()
        for kind in KINDS:
            kw = dict(nq=nq)
            if kind != "raw":
                kw["rsp"] = rsp[sl]
            if "minmax" in kind:
                kw["dp"] = dp[sl]
            kw["lap"] = kind.endswith("lap")
            out[S, kind] = (xs, h, t, kw)
    return out


def subcycle_input(dev, ne=30):
    """(x, halo, tables, kwargs) of the last scale+min/max+Laplacian K7
    launch of the second steady-state sharded subcycle of perf_config(ne,
    f32) at S = 1."""
    m = core.build_model(perf_config(ne, dtype="f32", use_pallas=True), dev)
    seen = []
    kernel = band.dss_band

    def record(x, ext, t, **kw):
        if kw.get("lap"):
            seen.append((x.clone(), ext.clone(), t,
                         {k: v.clone() if isinstance(v, torch.Tensor) else v
                          for k, v in kw.items()}))
        return kernel(x, ext, t, **kw)

    band.dss_band = record
    try:
        runner = sharded.make_sharded_subcycle(m, comm.ThreadComm(1),
                                               overlap=False)
        state = runner.shard_qdp(core.initial_qdp(m))
        state, _, nstep, _ = runner.step(state, 0)
        runner.step(state, nstep)
    finally:
        band.dss_band = kernel
    return seen[-1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="csrc directory of another tree's K7")
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
    libs, logs = build_libs(OUT, "band.cu", sources, ("tse_dss_band",))
    for name, log in logs.items():
        print(f"{name} ptxas dss_band_kernel: {band_usage(log)}", flush=True)
    order = list(variants) + ["as_built"]
    if args.other:
        order = ["as_built", "other", "other", "as_built"] + order[1:]
    for dtype in ("f32", "f64"):
        cs = cases(dtype, dev)
        want = {k: band.dss_band_plain(x, h, t, **kw)
                for k, (x, h, t, kw) in cs.items()}
        torch.cuda.synchronize()
        for S in (1, 8):
            for name in order:
                ms = []
                for kind in KINDS:
                    x, h, t, kw = cs[S, kind]
                    got = launch(libs[name], x, h, t, **kw)
                    if not same_bits(got, want[S, kind]):
                        raise AssertionError(f"{name} {dtype} S={S} {kind} "
                                             "differs from the plain version")
                    del got
                    ms.append(timed(lambda: launch(libs[name], x, h, t,
                                                   **kw)))
                print(f"{dtype} S={S}{' shard 0' if S > 1 else ''} {name}: "
                      + ", ".join(f"{k} {t:.4f}" for k, t in zip(KINDS, ms))
                      + f" ms, mean {statistics.mean(ms):.4f}", flush=True)
        del cs, want
        torch.cuda.empty_cache()
    x, ext, t, kw = subcycle_input(dev)
    res = band.dss_band_plain(x, ext, t, **kw)[0]
    mag = res.view(torch.int32) & 0x7fffffff
    lo, hi = 0x0d800000, 0x71800000          # 2^-100, 2^100 (common.cuh)
    out = (mag != 0) & ((mag < lo) | (mag > hi))
    print("sharded subcycle input: "
          f"{out.any(1).double().mean().item():.4%} of the (element, lane) "
          "columns hold an assembled value outside 2^-+100 (or -0)",
          flush=True)
    want = band.dss_band_plain(x, ext, t, **kw)
    for name in ("as_built", "ieee_divide", "ieee_divide", "as_built"):
        if name not in libs:
            continue
        got = launch(libs[name], x, ext, t, **kw)
        if not same_bits(got, want):
            raise AssertionError(f"{name} differs on the subcycle input")
        print(f"f32 {name} scale+minmax+lap on the subcycle input: "
              f"{timed(lambda: launch(libs[name], x, ext, t, **kw)):.4f} ms",
              flush=True)


if __name__ == "__main__":
    main()
