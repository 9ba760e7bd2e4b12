"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources in `csrc/` have a plain C interface and include no PyTorch
header, so one `nvcc` call builds them in seconds.  The shared library goes
to `_build/`, named by a hash of the sources and the flags, and is built on
first use.  There is no fallback: without `nvcc`, or when it fails, the
loader raises.

Pointers and the stream cross as `c_void_p` (a Python int from
`tensor.data_ptr()` / `torch.cuda.current_stream().cuda_stream`); every C
entry returns the `cudaError_t` of its launch, and `check()` raises on a
non-zero one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("euler.cu", "ppm.cu", "dss.cu", "limiter.cu", "band.cu")
# included by the sources; part of the library's hash
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # no fused multiply-add: every product and sum rounds as in the plain
    # PyTorch versions, so kernel and plain agree to the last bit where
    # their operation order agrees
    "--fmad=false",
    # registers, shared memory and spills of every kernel, into build.log
    "-Xptxas", "-v",
)

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
D = ctypes.c_double
# C entry points: name -> argtypes (each has an _f32 and an _f64 variant)
ENTRIES = {
    # qdp u v dp divdp met qmin qmax deriv dp0 bih | out qmin_o qmax_o |
    # E L nk dt nu_coef bih_mode max_iter tol | stream
    "tse_fused_advect_limit": [P] * 14 + [I, I, I, D, D, I, I, D, P],
    # s met deriv | out | E B | stream
    "tse_laplace_wk_t": [P] * 4 + [I, I, P],
    # qdp dp_star dp_ref | out | E nq nk alg | stream
    "tse_remap_q_ppm_t": [P] * 4 + [I, I, I, I, P],
    # nq nk | out[4]: K3's rows, threads, shared bytes per block, blocks/SM
    "tse_ppm_config": [I, I, P],
    # x part rsp avg dp met deriv | out qmin qmax lap | E L nk flags | stream
    "tse_dss_face": [P] * 11 + [I, I, I, I, P],
    # x dp | qmin qmax | E L nk | stream
    "tse_minmax_prep": [P] * 4 + [I, I, I, P],
    # qmin qmax nbr | gmin gmax | E L | stream
    "tse_neighbor_minmax": [P] * 5 + [I, I, P],
    # x halo role rsp dp met deriv | out qmin qmax lap | E L nk flags | stream
    "tse_dss_band": [P] * 11 + [I, I, I, I, P],
    # L nk flags | out[5]: K7's lanes a thread, threads, lane groups an
    # element, shared bytes per block, blocks/SM
    "tse_band_config": [I, I, I, P],
    # ptens sph dpmass minp maxp | out minp_o maxp_o | n sph_rep sph_inner
    # dp_rep dp_inner | tol | stream
    "tse_limiter_optim": [P] * 8 + [LL] * 5 + [D, P],
    # out[3]: K10's lanes a row, threads, blocks/SM
    "tse_limiter_config": [P],
    # L nk | out[5]: K5's lanes a thread, threads, lane groups an element,
    # shared bytes per block, blocks/SM
    "tse_minmax_config": [I, I, P],
    # E L | out[5]: K6's lanes a thread, threads a block, blocks, shared
    # bytes per block, blocks/SM
    "tse_nbr_minmax_config": [I, I, P],
}

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME (/usr/local/cuda)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels "
        "of transport_se_tpu_torch cannot be built")


def source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libtse_kernels_{source_key()}.so"


def build(out: Path) -> Path:
    """Compile every source into `out`; nvcc's report goes to build.log."""
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in ENTRIES.items():
                for suffix in ("_f32", "_f64"):
                    fn = getattr(lib, name + suffix)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def entry(name: str, dtype_name: str):
    return getattr(library(), f"{name}_{dtype_name}")


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {code}")
