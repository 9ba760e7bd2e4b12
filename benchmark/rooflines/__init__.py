"""Operations and bytes of the port's kernels, one module a kernel, from
the algorithm's call sequence and shapes: each input byte read once, each
output byte written once, whatever implements the call."""
