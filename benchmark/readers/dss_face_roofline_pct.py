"""K4's share of its roofline: the summed bound of the profiled subcycles'
face-DSS launches over K4's device time in them."""

from ..rooflines import dss_face


def read(trace):
    t = trace.kernel_s("dss_face")
    if t <= 0:
        return None
    c = trace.cfg
    bound_ms = dss_face.subcycle_bound_ms(c["E"], c["qsize"], c["nlev"],
                                          c["dtype"])
    return 100.0 * bound_ms * trace.subcycles / (t * 1e3)
