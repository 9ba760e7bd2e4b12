"""K3's launch shape measured on the card: the PPM remap kernel of
`csrc/ppm.cu` built beside the package's library with its block shape
changed, each held bitwise against the plain version and timed.

    python -m transport_se_tpu_torch.k3_variants [--other CSRC]

from the repo root.  --other CSRC also builds the K3 of another tree's
csrc directory (its ppm.cu, e.g. an unpacked parent commit) and times it in
turns with this one (this, other, other, this).

Variants (the source is edited in memory, built into `_build/k3_variants/`
with the package's nvcc flags, all builds started together):
  as_built      about 160 (f32) / 96 (f64) columns a block and at most
                56 KB of shared memory a block (four blocks an SM)
  big_blocks    288 / 160 columns, 112 KB (two blocks an SM)
  ieee_divide   IEEE divisions throughout (no inline divisions)

Times are CUDA-event medians of 7 after a warm-up, at NE30 (E = 5400,
35 x 72 lanes; perf_config's remap inputs as chip_smoke.py phase 3 makes
them), at alg 0 and 2; then as_built and ieee_divide in f32 on the remap
input of a steady-state NE30 face subcycle (the second one), with the
share of its columns that hold a tracer mass below 2^-60 and 2^-100 (the
inline divisions' range was 2^-60 first, is 2^-100 now).  Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
from pathlib import Path

import torch

from . import _build
from .config import perf_config
from .k1_variants import build_libs, timed
from .model import core
from .model.wind_basis import build_wind_basis
from .ops import euler, remap

OUT = _build.BUILD_DIR / "k3_variants"
COLS = "static constexpr int cols = sizeof(T) == 4 ? 160 : 96;"
CAP = "static constexpr int smem_cap = 56 * 1024;"
FAST = "const bool fast = srow_ok[r];"
EDITS = {
    "as_built": (),
    "big_blocks": ((COLS, COLS.replace("160 : 96", "288 : 160")),
                   (CAP, CAP.replace("56", "112"))),
    "ieee_divide": ((FAST, "const bool fast = false;"),),
}
ALGS = (0, 2)


def ppm_usage(log):
    """'f32 40r/0B, f64 ...': registers and spill stores of ppm_kernel."""
    out, cur, spill = [], None, "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"ppm_kernelI([fd])", m.group(1))
            cur = None if k is None else ("f32" if k.group(1) == "f" else
                                          "f64")
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
    buf = (ctypes.c_int * 4)()
    _build.check(fn(nq, nk, buf), "ppm_config variant")
    return (f"rows {buf[0]}, threads {buf[1]}, shared {buf[2]} B, "
            f"blocks/SM {buf[3]}")


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
    """ops.remap.remap_q_ppm_t's launch, through lib."""
    E, _, qk = Qt.shape
    nk = dps.shape[-1]
    out = torch.empty_like(Qt)
    fn = getattr(lib, "tse_remap_q_ppm_t_" + euler._DTYPES[Qt.dtype])
    code = fn(Qt.data_ptr(), dps.data_ptr(), dpr.data_ptr(), out.data_ptr(),
              E, qk // nk, nk, alg, euler._stream(Qt.device))
    _build.check(code, "remap_q_ppm_t variant")
    return out


def held(lib, args, alg):
    """K3 through lib == the plain version, bitwise; its time."""
    got = launch(lib, *args, alg)
    if not torch.equal(got, remap.remap_q_ppm_t_plain(*args, alg=alg)):
        raise AssertionError("variant differs from the plain version")
    return timed(lambda: launch(lib, *args, alg))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="csrc directory of another tree's K3")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    sources = {name: (_build.CSRC, edits) for name, edits in EDITS.items()}
    if args.other:
        sources["other"] = (Path(args.other), ())
    libs, logs = build_libs(OUT, "ppm.cu", sources, ("tse_remap_q_ppm_t",))
    for name, log in logs.items():
        print(f"{name} ptxas ppm_kernel: {ppm_usage(log)}", flush=True)
    for dtype in ("f32", "f64"):
        a = remap_args(dtype, dev)
        nq, nk = a[0].shape[-1] // a[1].shape[-1], a[1].shape[-1]
        for name, lib in libs.items():
            print(f"{dtype} {name} shape: {shape(lib, nq, nk, dtype)}",
                  flush=True)
        order = ["as_built", "big_blocks", "ieee_divide", "as_built"]
        if args.other:
            order = ["as_built", "other", "other", "as_built"] + order[1:]
        for name in order:
            ms = [held(libs[name], a, alg) for alg in ALGS]
            print(f"{dtype} {name}: alg " + "/".join(map(str, ALGS)) + " "
                  + "/".join(f"{t:.4f}" for t in ms) + " ms, mean "
                  f"{sum(ms) / len(ms):.4f}", flush=True)
        del a
        torch.cuda.empty_cache()
    Qt, dps, dpr, alg = subcycle_input(dev)
    nk = dps.shape[-1]
    mag = Qt.view(torch.int32) & 0x7fffffff
    for name, lo in (("2^-60", 0x21800000), ("2^-100", 0x0d800000)):
        share = ((mag != 0) & (mag < lo)).reshape(-1, nk).any(-1)
        print(f"subcycle input: {share.double().mean().item():.4%} of the "
              f"columns hold a mass below {name}", flush=True)
    for name in ("as_built", "ieee_divide", "ieee_divide", "as_built"):
        print(f"f32 {name} on the subcycle input (alg {alg}): "
              f"{held(libs[name], (Qt, dps, dpr), alg):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
