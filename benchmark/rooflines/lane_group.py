"""The lane kernels of the tracer-group plan
(`transport_se_tpu_torch/csrc/lanes.cu`): bytes of one subcycle's
gathers and scatters, and their bound."""

from .peaks import BYTES, bound


def subcycle_bytes(E, qsize, nlev, dtype):
    """A group plan gathers every lane of the state [E, 16, q*k] into its
    group's buffer once a subcycle and scatters it back once: each copy
    reads and writes the state's bytes, four times the state in all,
    whatever the group widths."""
    return 4 * E * 16 * qsize * nlev * BYTES[dtype]


def subcycle_bound_ms(E, qsize, nlev, dtype):
    """The least ms of one subcycle's lane copies (bytes alone: a copy
    computes nothing)."""
    return bound(subcycle_bytes(E, qsize, nlev, dtype), 0, dtype)[0]
