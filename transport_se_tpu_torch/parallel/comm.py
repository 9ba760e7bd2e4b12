"""Communicators of the sharded pipeline: the counterparts of the JAX
package's `lax.ppermute` and `lax.pmin` over its mesh axis.

The sharded subcycle (`parallel/sharded.py`) runs one program per shard.
It talks to the other shards through two calls, made by every shard in the
same order:

* `exchange_start(rank, sends, recvs, like)`: one halo exchange, all of
  its rounds at once (each round a partial permutation, each shard pair
  one message), started.  Shard `rank` sends each (dst, payload) of
  `sends` and receives, for each (src, nrecv) of `recvs`, the nrecv rows
  that shard src sends it, shaped, typed and placed as the rows of
  `like`.  Returns `finish()`, which gives the received tensors in the
  order of `recvs`; work issued between the two runs beside the exchange
  where the communicator allows it (DistComm).
* `min(rank, x)`: the minimum of a 0-d tensor over all shards.

Two implementations:

* `ThreadComm(S)`: S shards as S threads of one process on one device
  (the counterpart of the JAX tests' 8 virtual CPU devices).  An exchange
  is a barrier exchange of tensor references: every thread posts what it
  sends, waits, takes what it receives, and waits again before the slots
  are reused; a halo exchange takes all its rounds in one pair of
  barriers.  The threads share one interpreter, so their host work (the
  launches of S shards) runs one thread at a time.  All threads issue
  their work on the device's one current stream, so stream order after
  the barrier puts each payload's producer before its consumer; nothing
  synchronises with the host, and nothing runs beside the exchange (it is
  done when `exchange_start` returns).  A failure in any thread aborts
  the barrier, so the others stop at their next exchange, and `run`
  re-raises it in the caller: a broken shard fails the run instead of
  hanging it.
* `DistComm()`: one shard per process of an initialised
  `torch.distributed` group (NCCL on cards, gloo on the CPU); an exchange
  is one `batch_isend_irecv` and `finish()` waits for it.  With NCCL the
  exchange runs on NCCL's own stream, beside the work issued before
  `finish()`, and `finish()` makes the current stream wait for it.  The
  minimum is an `all_reduce(MIN)`.

`run(fn)` calls fn(rank) for every shard this process hosts (`ranks`) and
returns the results in that order.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["ThreadComm", "DistComm"]


class ThreadComm:
    """S shards in S threads of this process (see the module docstring)."""

    def __init__(self, size: int, timeout: float = 1800.0):
        if size < 1:
            raise ValueError(f"ThreadComm needs >= 1 shard, got {size}")
        self.size = size
        self.ranks = tuple(range(size))
        self.timeout = timeout
        self._barrier = None
        self._slots = [None] * size

    def _wait(self):
        self._barrier.wait()

    def exchange_start(self, rank, sends, recvs, like):
        self._slots[rank] = dict(sends)
        self._wait()
        got = [self._slots[src].get(rank) for src, _ in recvs]
        self._wait()
        for (src, n), g in zip(recvs, got):
            if g is None or g.shape[0] != n:
                raise RuntimeError(f"shard {rank}: shard {src} sent "
                                   f"{None if g is None else g.shape[0]} "
                                   f"rows, expected {n}")
        return lambda: got

    def min(self, rank, x):
        self._slots[rank] = x
        self._wait()
        out = torch.stack(list(self._slots)).amin()
        self._wait()
        return out

    def run(self, fn):
        """fn(rank) in one thread per shard -> [fn(0), ..., fn(S-1)]."""
        if self.size == 1:
            self._barrier = threading.Barrier(1, timeout=self.timeout)
            return [fn(0)]
        self._barrier = threading.Barrier(self.size, timeout=self.timeout)
        results = [None] * self.size
        errors = [None] * self.size

        def body(rank):
            try:
                results[rank] = fn(rank)
            except BaseException as e:          # noqa: BLE001 - re-raised
                errors[rank] = e
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(r,),
                                    name=f"shard-{r}", daemon=True)
                   for r in self.ranks]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._slots = [None] * self.size
        # the first failure that is not another thread's broken barrier
        real = [e for e in errors if e is not None
                and not isinstance(e, threading.BrokenBarrierError)]
        if real:
            raise real[0]
        broken = [e for e in errors if e is not None]
        if broken:
            raise broken[0]
        return results


class DistComm:
    """One shard per process of the default `torch.distributed` group."""

    def __init__(self):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("DistComm needs torch.distributed initialised "
                               "(parallel.multihost.init)")
        self._dist = dist
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.ranks = (self.rank,)
        # a first collective over the whole group: point-to-point rounds
        # in which some ranks take no part follow it safely
        dist.barrier()

    def exchange_start(self, rank, sends, recvs, like):
        dist = self._dist
        got = [like.new_empty((n,) + tuple(like.shape[1:])) for _, n in recvs]
        ops = [dist.P2POp(dist.isend, p.contiguous(), dst)
               for dst, p in sends]
        ops += [dist.P2POp(dist.irecv, g, src)
                for (src, _), g in zip(recvs, got)]
        reqs = dist.batch_isend_irecv(ops) if ops else []

        def finish():
            for req in reqs:
                req.wait()
            return got
        return finish

    def min(self, rank, x):
        y = x.clone()
        self._dist.all_reduce(y, op=self._dist.ReduceOp.MIN)
        return y

    def run(self, fn):
        return [fn(self.rank)]
