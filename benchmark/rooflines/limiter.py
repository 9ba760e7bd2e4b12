"""K10, the row limiter of the std path
(`transport_se_tpu_torch/csrc/limiter.cu`): bytes and operations of one
launch, and of the launches of one subcycle."""

from .peaks import BYTES, OPS, bound


def cost(E, qsize, nlev, es):
    """(bytes, operations) of one launch on ptens [E, q, k, 16]: ptens in
    and out, spheremp [E, 16] and dp_star [E, k, 16] (read in place by the
    q*k and q rows that share them), the bounds minp and maxp [E, q, k] in
    and out; one limiter pass a row."""
    rows = E * qsize * nlev
    nbytes = (2 * rows * 16 + E * 16 + E * nlev * 16 + 4 * rows) * es
    return nbytes, rows * OPS["limiter_iter"]


def subcycle_bound_ms(E, qsize, nlev, dtype, rsplit=3):
    """The summed bound of one subcycle's K10 launches (one a stage, three
    stages a tracer step), in ms."""
    return 3 * rsplit * bound(*cost(E, qsize, nlev, BYTES[dtype]), dtype)[0]
