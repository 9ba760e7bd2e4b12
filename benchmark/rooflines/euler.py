"""K1, the fused euler stage (`transport_se_tpu_torch/csrc/euler.cu`):
bytes and operations of one launch, and of the launches of one
subcycle."""

from .peaks import BYTES, OPS, bound


def cost(E, qsize, nlev, es, stage):
    """(bytes, operations) of one launch of stage kind 0, 1 or 2 on
    [E, 16, q*k]: the state in and out, u, v, dp and divdp [E, 16, k], the
    bounds in and out [E, q*k], the metric pack and deriv, and on stage 2
    the hyperviscosity input and dp0; one limiter pass a column."""
    L = qsize * nlev
    F, EL, lv = E * 16 * L, E * L, E * 16 * nlev
    nbytes = (2 * F + 4 * lv + 4 * EL + E * 160 + 16
              + (F + nlev if stage == 2 else 0)) * es
    return nbytes, EL * (OPS["advect"] + OPS["limiter_iter"]
                         + (OPS["lap"] if stage == 2 else 0))


def subcycle_bound_ms(E, qsize, nlev, dtype, rsplit=3):
    """The summed bound of one subcycle's K1 launches (one a stage, three
    stages a tracer step), in ms."""
    es = BYTES[dtype]
    return rsplit * sum(bound(*cost(E, qsize, nlev, es, s), dtype)[0]
                        for s in (0, 1, 2))
