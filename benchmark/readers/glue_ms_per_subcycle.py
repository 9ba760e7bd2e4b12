"""Device milliseconds a subcycle of every operation that is none of the
port's own kernels (benchmark/kernels): the plain-torch stage glue, its
copies and fills."""


def read(trace):
    if trace.subcycles <= 0:
        return None
    return trace.other_s() * 1e3 / trace.subcycles
