"""Launch counters of the kernels and of their plain PyTorch versions.

Each kernel wrapper adds one to its kernel's count where it launches the
kernel; each plain version adds one to its own count where it runs.  A run
resets the counts, drives the main path and reads them back to show which
implementation the path went through.
"""

KERNELS = ("fused_advect_limit", "laplace_wk_t", "remap_q_ppm_t",
           "dss_face", "minmax_prep", "neighbor_minmax")

COUNTS = {name: 0 for k in KERNELS for name in (k, k + "_plain")}


def reset() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def snapshot() -> dict:
    return dict(COUNTS)
