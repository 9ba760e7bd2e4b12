"""The card's peaks and a call's bound (frozen from the repository's
`chip_smoke.py`).

NVIDIA's data sheet for the H100 SXM (the rates assume its 700 W power
limit, which the benchmark prints beside every run): 3.35 TB/s of HBM3 and
67 / 34 TFLOP/s in float32 / float64 outside the tensor cores.
"""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}
BYTES = {"f32": 4, "f64": 8}
# floating-point operations, counted from the plain versions: per point of
# an (element, lane) column for the stage parts and the DSS epilogues, per
# (point, tracer, level) cell for the PPM remap, and one limiter pass per
# column or row
OPS = {"advect": 16 * 30, "limiter_iter": 16 * 8, "lap": 16 * 50,
       "ppm": 100, "dss_add": 3, "scale": 1, "avg": 3, "minmax": 2}


def bound(nbytes, nops, dtype):
    """(least ms the card could take for a call, "bytes" or "operations"):
    the larger of its bytes over the memory rate and its operations over
    the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
