"""Host-side grid construction: the port's copies of the JAX package's
numpy grid modules."""
