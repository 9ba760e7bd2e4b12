"""K4, the face DSS (`transport_se_tpu_torch/csrc/dss.cu`): bytes and
operations of one launch, and of the launches of one face subcycle."""

from .peaks import BYTES, OPS, bound

# a face subcycle's launches by case: each of the 3 tracer steps runs stage
# 0's output with min/max, stage 1's with min/max and the first Laplacian,
# stage 2's hyperviscosity input scaled, and stage 2's output with the time
# average, with min/max on the first two steps
SUBCYCLE = {"scale": 3, "minmax": 3, "minmax+lap": 3, "avg+minmax": 2,
            "avg": 1}


def cost(E, L, nk, es, avg=False, minmax=False, lap=False, scale=True,
         part=8):
    """(bytes, operations) of one call on [E, 16, L]: the field in and out,
    the [E, 16, 3] partner table (part bytes a slot), rspheremp, and per
    epilogue the average, dp and the two bounds, the metric pack and the
    Laplacian."""
    F, EL = E * 16 * L, E * L
    nbytes = 2 * F * es + E * 48 * part + (E * 16 * es if scale else 0) \
        + (F * es if avg else 0) \
        + ((E * 16 * nk + 2 * EL) * es if minmax else 0) \
        + ((F + E * 160 + 16) * es if lap else 0)
    per = (OPS["dss_add"] + (OPS["scale"] if scale else 0)
           + (OPS["avg"] if avg else 0) + (OPS["minmax"] if minmax else 0))
    return nbytes, EL * (16 * per + (OPS["lap"] if lap else 0))


def subcycle_bound_ms(E, qsize, nlev, dtype):
    """The summed bound of one face subcycle's K4 launches, in ms."""
    es = BYTES[dtype]
    total = 0.0
    for case, n in SUBCYCLE.items():
        flags = set(case.split("+"))
        total += n * bound(*cost(E, qsize * nlev, nlev, es,
                                 avg="avg" in flags,
                                 minmax="minmax" in flags,
                                 lap="lap" in flags), dtype)[0]
    return total
