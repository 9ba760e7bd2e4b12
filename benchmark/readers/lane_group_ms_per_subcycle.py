"""Device milliseconds a subcycle of the tracer-group plan's lane copies
(benchmark/kernels/lane_group.json): 0 where the plan runs one group and
launches none."""


def read(trace):
    if trace.subcycles <= 0:
        return None
    return trace.kernel_s("lane_group") * 1e3 / trace.subcycles
