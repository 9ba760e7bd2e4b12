"""The device's idle share over the profiled subcycles: 1 - busy/span,
busy merged over overlapping operations."""


def read(trace):
    if trace.span_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.span_s)
