"""K6's design choices measured on the card: the neighbour min/max of
`csrc/dss.cu` (nbr_minmax_kernel) built beside the package's library with
one choice changed, each held bit for bit to the plain version and timed.

    python -m transport_se_tpu_torch.k6_variants [--other CSRC] [--only A,B]

from the repo root.  --other CSRC also builds the K6 of another tree's
csrc directory (its dss.cu and headers, e.g. an unpacked parent commit)
and times it in turns with this one (this, other, other, this); --only
builds and times the named variants alone (as_built always).

Variants (the source is edited in memory, built into `_build/k6_variants/`
with the package's nvcc flags, all builds started together):
  as_built       the source as it is (32 lane vectors of 16 bytes by up to
                 10 element columns a block, up to 15 rows marched, a ring
                 of 2 window rows in shared memory, one in flight)
  cached_stores  the bounds stored without the evict-first hint
  stages_3       a ring of 3 rows (two in flight)
  stages_4       4
  stages_6       6
  rows_8         up to 8 rows a block (more blocks, more halo rows read)
  rows_30        up to 30 rows: a block marches a whole face at NE30
  cols_6         up to 6 columns a block
  cols_15        up to 15
  chunk_16       16 lane vectors a block across
  blocks_4       launch bounds asking 4 resident blocks an SM (at most 51
                 registers; 3 fit at the registers nvcc picks)

Inputs: chip_smoke.py phase 3's (the bounds of the fused stage 0's output
over the layer thickness after stage 1, at NE30: E = 5400, 35 x 72 lanes,
perf_config) in f32 and f64.  Times are CUDA-event medians of 7 after a
warm-up, each over BURST launches back to back (a launch takes about
0.1 ms, so one launch between two events would also time the host's
launch path); every build of this tree is checked bit for bit (-0 included)
against the plain version before it is timed.  The other tree's K6 is held
to the plain version's values, and its bits are reported: a kernel that
orders tied zeros otherwise may differ in the sign of a zero bound.  Each
line gives the bytes the launch shape reads from L2 (the halo rows and
columns a block reads again) over the bytes of the two input arrays.  A
yardstick of the card's rate for these bytes is timed beside them: two
`Tensor.copy_` calls of the input arrays into the outputs (the same
bytes read and written, with no neighbours), also in bursts.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
from pathlib import Path

import torch

from . import _build
from .config import perf_config
from .k1_variants import build_libs, stage_args, timed
from .k10_variants import same_bits
from .model import core
from .ops import dss_face, euler

OUT = _build.BUILD_DIR / "k6_variants"
SRC = "dss.cu"
BURST = 20


def edits():
    def const(name, old, new):
        return ((f"constexpr int {name} = {old};",
                 f"constexpr int {name} = {new};"),)
    return {
        "as_built": (),
        "cached_stores": (("constexpr bool kNbrStreamStores = true;",
                           "constexpr bool kNbrStreamStores = false;"),),
        "stages_3": const("kNbrStages", 2, 3),
        "stages_4": const("kNbrStages", 2, 4),
        "stages_6": const("kNbrStages", 2, 6),
        "rows_8": const("kNbrRows", 15, 8),
        "rows_30": const("kNbrRows", 15, 30),
        "cols_6": const("kNbrCols", 10, 6),
        "cols_15": const("kNbrCols", 10, 15),
        "chunk_16": const("kNbrChunk", 32, 16),
        "blocks_4": (("__launch_bounds__(kNbrChunk * kNbrCols)",
                      "__launch_bounds__(kNbrChunk * kNbrCols, 4)"),),
    }


def nbr_usage(log):
    """'f32 V4 40r/0B, ...': registers and spill stores of each
    nbr_minmax_kernel instantiation (the parent's has no lane width)."""
    out, cur, spill = [], None, "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"nbr_minmax_kernelI([fd])(?:Li(\d+)E)?E",
                          m.group(1))
            cur = None if k is None else (
                ("f32" if k.group(1) == "f" else "f64")
                + (f" V{k.group(2)}" if k.group(2) else ""))
        elif cur and "bytes spill stores" in ln:
            spill = ln.split("bytes spill stores")[0].split(",")[-1].strip()
        elif cur and "Used" in ln and "registers" in ln:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            out.append(f"{cur} {regs}r/{spill}B")
            cur = None
    return ", ".join(sorted(out))


def launch(lib, qmin, qmax, nbr):
    """ops.dss_face.neighbor_minmax's launch through lib."""
    E, L = qmin.shape
    gmin, gmax = torch.empty_like(qmin), torch.empty_like(qmax)
    fn = getattr(lib, "tse_neighbor_minmax_" + euler._DTYPES[qmin.dtype])
    code = fn(qmin.data_ptr(), qmax.data_ptr(), nbr.data_ptr(),
              gmin.data_ptr(), gmax.data_ptr(), E, L,
              euler._stream(qmin.device))
    _build.check(code, f"neighbor_minmax of {Path(lib._name).parent.name}")
    return gmin, gmax


def config(lib, E, L, dtype):
    """K6's launch shape through lib: lanes a thread/threads/blocks/shared
    B/blocks an SM."""
    buf = (ctypes.c_int * 5)()
    fn = getattr(lib, "tse_nbr_minmax_config_" + euler._DTYPES[dtype])
    fn.argtypes = _build.ENTRIES["tse_nbr_minmax_config"]
    fn.restype = ctypes.c_int
    _build.check(fn(int(E), int(L), buf), "nbr_minmax_config")
    return list(buf)


def l2_reads(src_text, ne):
    """The element rows a launch reads per output row, from a source's
    kNbrCols and kNbrRows: (rows + 2)(cols + 2) / (rows cols) of the
    balanced strips and segments of a face."""
    def get(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src_text).group(1))
    strips = -(-ne // get("kNbrCols"))
    cols = -(-ne // strips)
    segs = -(-ne // get("kNbrRows"))
    rows = -(-ne // segs)
    return sum((min(rows, ne - s * rows) + 2) * (min(cols, ne - t * cols)
                                                 + 2)
               for s in range(segs) for t in range(strips)) / (ne * ne)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="csrc directory of another tree's K6")
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
    libs, logs = build_libs(OUT, SRC, sources, ("tse_neighbor_minmax",))
    ne = 30
    E, L = 6 * ne * ne, 35 * 72
    for name, log in logs.items():
        if name == "other":
            print(f"other ptxas nbr_minmax_kernel: {nbr_usage(log)}",
                  flush=True)
            continue
        text = (OUT / name / SRC).read_text()
        print(f"{name} ptxas nbr_minmax_kernel: {nbr_usage(log)}; launch "
              "shape (lanes a thread/threads/blocks/shared B/blocks an SM) "
              "f32 " + "/".join(map(str, config(libs[name], E, L,
                                                 torch.float32)))
              + ", f64 " + "/".join(map(str, config(libs[name], E, L,
                                                     torch.float64)))
              + f"; L2 reads {l2_reads(text, ne):.3f} x the inputs",
              flush=True)
    order = list(variants) + ["as_built"]
    if args.other:
        order = ["as_built", "other", "other", "as_built"] + order[1:]
    for dtype in ("f32", "f64"):
        stages = stage_args(dtype, dev, ne)
        a0, k0 = stages[0]
        x = euler.fused_advect_limit_plain(*a0, **k0)[0]
        dp = stages[1][0][2]               # stage 1's layer thickness
        nq = x.shape[-1] // dp.shape[-1]
        del stages, a0, k0
        qmin, qmax = dss_face.minmax_prep_plain(x, dp, nq)
        del x, dp
        ft = core.build_model(perf_config(ne, dtype=dtype, use_pallas=True),
                              dev).tables.face
        want = dss_face.neighbor_minmax_plain(qmin, qmax, ft)
        ms, notes = {}, []
        for name in order:
            got = launch(libs[name], qmin, qmax, ft.nbr)
            if name == "other":
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"other {dtype} differs from the "
                                         "plain version")
                if not same_bits(got, want):
                    notes.append("other differs in the sign of a zero")
            elif not same_bits(got, want):
                raise AssertionError(f"{name} {dtype} differs from the "
                                     "plain version")
            del got
            ms.setdefault(name, []).append(timed(lambda: [
                launch(libs[name], qmin, qmax, ft.nbr)
                for _ in range(BURST)]) / BURST)
        outs = (torch.empty_like(qmin), torch.empty_like(qmax))
        ms["copy"] = [timed(lambda: [(outs[0].copy_(qmin), outs[1].copy_(
            qmax)) for _ in range(BURST)]) / BURST]
        del outs
        zeros = int((qmin == 0).sum() + (qmax == 0).sum())
        print(f"{dtype} sphere ms a launch, {BURST} back to back ({zeros} "
              "zero bounds in the input"
              + ("; " + "; ".join(notes) if notes else "") + "): "
              + ", ".join(f"{n} " + "/".join(f"{t:.4f}" for t in ts)
                          for n, ts in ms.items()), flush=True)
        del qmin, qmax, want, ft
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
