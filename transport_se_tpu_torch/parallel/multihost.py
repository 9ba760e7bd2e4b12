"""Multi-process runtime: distributed init and the canonical gather.

Port of `transport_se_tpu/parallel/multihost.py` (reference:
parallel_mod.F90:100 `initmp`; the restart gather of restart_io_mod.F90:524
WriteRestart).  One process per shard, each running the sharded subcycle
(parallel/sharded.py) over a `DistComm`.  The shard plan depends only on
the shard count, and every exchange is a fixed point-to-point permutation,
so a run gives the same bits in one process with S threads (`ThreadComm`)
as in S processes (tests/test_torch_multihost.py).

Each process takes its shard with `ShardedRunner.shard_qdp`, which builds
the state of the process's own rank in the runner's io_layout (the JAX
package's shard_qdp_multihost fed std-layout state to the T-layout step,
ROADMAP C).  Nothing here discovers a cluster: the caller gives the
address (tcp://host:port), the world size and the rank.
"""

from __future__ import annotations

import torch

__all__ = ["init", "gather_canonical"]


def init(address: str, world_size: int, rank: int,
         device: str) -> torch.device:
    """torch.distributed.init_process_group at `address` (tcp://host:port)
    for shards on `device`: "cuda" (NCCL; rank r takes card
    r % device_count()) or "cpu" (gloo).  Returns this rank's device."""
    import torch.distributed as dist
    if device == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif device == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"device {device!r} not in ('cuda', 'cpu')")
    dist.init_process_group(backend, init_method=address,
                            world_size=world_size, rank=rank)
    return dev


def gather_canonical(runner, states):
    """Every shard's state gathered to every process (all_gather) ->
    std-layout Qdp [E, q, k, 4, 4] in model order, the multi-process form
    of ShardedRunner.gather."""
    import torch.distributed as dist
    (local,) = states
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local.contiguous())
    return runner.state_to_qdp(torch.cat(parts))
