"""K1's share of its roofline: the summed bound of the profiled subcycles'
fused-stage launches over K1's device time in them."""

from ..rooflines import euler


def read(trace):
    t = trace.kernel_s("euler")
    if t <= 0:
        return None
    c = trace.cfg
    bound_ms = euler.subcycle_bound_ms(c["E"], c["qsize"], c["nlev"],
                                       c["dtype"], c["rsplit"])
    return 100.0 * bound_ms * trace.subcycles / (t * 1e3)
