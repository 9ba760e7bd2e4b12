"""K10's share of its roofline: the summed bound of the profiled
subcycles' row-limiter launches over K10's device time in them."""

from ..rooflines import limiter


def read(trace):
    t = trace.kernel_s("limiter")
    if t <= 0:
        return None
    c = trace.cfg
    bound_ms = limiter.subcycle_bound_ms(c["E"], c["qsize"], c["nlev"],
                                         c["dtype"], c["rsplit"])
    return 100.0 * bound_ms * trace.subcycles / (t * 1e3)
