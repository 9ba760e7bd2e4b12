"""The benchmark of transport_se_tpu_torch (see README.md)."""
