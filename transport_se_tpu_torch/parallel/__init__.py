"""Sharded execution: the halo plan and tables, the communicators, the
banded face DSS per shard, the sharded subcycle and its multi-process
runtime."""
