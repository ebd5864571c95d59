"""Communicators: the collectives one rank of the distributed join calls.

The counterpart of `shard_map`'s axis context in the JAX package
(`jax.lax.axis_size`, `all_to_all`, `all_gather`, `psum` over a named axis).
A communicator has `rank`, `size` and three collectives, each called by every
rank of its group in the same order:

  all_to_all(x)  x [size * k, ...]: rows [d*k, (d+1)*k) go to rank d; the
                 result [size * k, ...] holds rank j's block for this rank at
                 rows [j*k, (j+1)*k) (the tiled `lax.all_to_all`, equal splits
                 along dim 0);
  all_gather(x)  [size * k, ...], rank j's x at rows [j*k, (j+1)*k) (tiled);
  psum_u32(x)    the elementwise sum over ranks of an int32 tensor mod 2^32,
                 as int32 (`lax.psum` of the uint32 view).

Two kinds:

* `ThreadWorld` + `ThreadComm`: N ranks as N threads of one process, their
  tensors on one device. A rank deposits its tensor in a slot of its group
  and waits at the group's barrier; then every rank reads all the slots.
  Slots alternate between two sets, so one barrier a collective suffices: a
  rank can refill a set only after every rank has passed the next barrier,
  that is after every rank has read the set. A slot keeps its tensor alive
  until then, so the caching allocator cannot hand its memory out before
  every reader has queued its read. On the card all ranks queue on the same
  stream (each thread's current stream is the device's default stream), so a
  read queued after the barrier runs after the writes that made the tensor.
  A rank with a stream of its own would have to record an event with each
  deposit and make readers wait on it. Every barrier wait has a timeout; an
  exception in any rank aborts every barrier of the world, so the other ranks
  raise instead of hanging, and `ThreadWorld.run` re-raises the first error.
* `ProcessGroupComm(group)`: one rank of a `torch.distributed` process group
  (NCCL on the card, gloo on the CPU) through `all_to_all_single` with equal
  splits and `all_gather_into_tensor`. `psum_u32` gathers the int32 values
  and adds them here mod 2^32: neither backend has a uint32 sum, and an int32
  sum that overflows is undefined in C++.

`grid_ranks` names the groups of a 2-D (host, chip) grid; the mesh module
makes them for a ThreadWorld, `process_grid_comms` for a process group.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Sequence, Tuple, TypeVar

import torch
import torch.distributed as dist

from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32

T = TypeVar("T")


def _sum_u32(stacked: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 of an int32 tensor, mod 2^32, as int32."""
    return wrap_i32(stacked.long().sum(0))


class _ThreadGroup:
    """The slots and the barrier of one group of ranks of a ThreadWorld."""

    def __init__(self, size: int, timeout: float):
        self.barrier = threading.Barrier(size, timeout=timeout)
        self.slots: List[List[object]] = [[None] * size, [None] * size]
        self.calls = [0] * size   # collectives each rank has entered


class ThreadComm:
    """One rank of a group of a ThreadWorld (see the module docstring)."""

    def __init__(self, group: _ThreadGroup, rank: int, size: int):
        self._group = group
        self.rank = rank
        self.size = size

    def _exchange(self, x: torch.Tensor) -> List[torch.Tensor]:
        group = self._group
        slots = group.slots[group.calls[self.rank] % 2]
        group.calls[self.rank] += 1
        slots[self.rank] = x
        group.barrier.wait()
        return list(slots)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % self.size:
            raise ValueError(f"all_to_all: {x.shape[0]} rows do not split "
                             f"into {self.size} equal blocks")
        k = x.shape[0] // self.size
        lo = self.rank * k
        return torch.cat([y[lo:lo + k] for y in self._exchange(x)])

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat(self._exchange(x))

    def psum_u32(self, x: torch.Tensor) -> torch.Tensor:
        return _sum_u32(torch.stack(self._exchange(x)))


class ThreadWorld:
    """N ranks run as N threads of this process (see the module docstring).

    `run(fn)` calls fn(rank) on every rank, each in its own thread, and
    returns the results in rank order. Inside fn, `comm(rank, ranks)` is the
    communicator of the group `ranks` (global rank numbers, in group order;
    every rank of a group asks for it with the same tuple). Barrier waits
    time out after `timeout` seconds."""

    def __init__(self, size: int, timeout: float = 300.0):
        if size < 1:
            raise ValueError(f"a world needs at least one rank, not {size}")
        self.size = size
        self.timeout = timeout
        self._lock = threading.Lock()
        self._groups: Dict[Tuple[int, ...], _ThreadGroup] = {}

    def comm(self, rank: int, ranks: Sequence[int]) -> ThreadComm:
        ranks = tuple(int(r) for r in ranks)
        with self._lock:
            group = self._groups.get(ranks)
            if group is None:
                group = self._groups[ranks] = _ThreadGroup(len(ranks),
                                                           self.timeout)
        return ThreadComm(group, ranks.index(rank), len(ranks))

    def _abort(self):
        with self._lock:
            for group in self._groups.values():
                group.barrier.abort()

    def run(self, fn: Callable[[int], T]) -> List[T]:
        with self._lock:
            self._groups = {}       # fresh barriers: an aborted run breaks them
        results: List[object] = [None] * self.size
        errors: List[BaseException] = [None] * self.size

        def body(rank: int):
            try:
                results[rank] = fn(rank)
            except BaseException as e:   # re-raised by run() below
                errors[rank] = e
                self._abort()

        threads = [threading.Thread(target=body, args=(r,), name=f"rank-{r}",
                                    daemon=True) for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        raised = [e for e in errors if e is not None]
        if raised:
            own = [e for e in raised
                   if not isinstance(e, threading.BrokenBarrierError)]
            if own:
                raise own[0]
            raise TimeoutError(f"a collective of the {self.size}-rank thread "
                               f"world did not complete within "
                               f"{self.timeout} s") from raised[0]
        return results


class ProcessGroupComm:
    """This process's rank of a `torch.distributed` group (None: the world)."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % self.size:
            raise ValueError(f"all_to_all: {x.shape[0]} rows do not split "
                             f"into {self.size} equal blocks")
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        out = x.new_empty((self.size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=self.group)
        return out

    def psum_u32(self, x: torch.Tensor) -> torch.Tensor:
        return _sum_u32(self.all_gather(x.reshape(1, *x.shape)))


def grid_ranks(n_hosts: int, chips_per_host: int):
    """The groups of a host-major (host, chip) grid: (columns, rows). Column
    c holds ranks h * chips_per_host + c for every h (the host axis); row h
    holds ranks h * chips_per_host + c for every c (the chip axis)."""
    cols = [tuple(h * chips_per_host + c for h in range(n_hosts))
            for c in range(chips_per_host)]
    rows = [tuple(h * chips_per_host + c for c in range(chips_per_host))
            for h in range(n_hosts)]
    return cols, rows


def process_grid_comms(n_hosts: int, chips_per_host: int
                       ) -> Tuple[ProcessGroupComm, ProcessGroupComm]:
    """(host axis, chip axis) communicators of this process in a host-major
    grid over the whole world. Every rank creates every row and column group,
    in the same order, as `torch.distributed.new_group` requires."""
    if n_hosts * chips_per_host != dist.get_world_size():
        raise ValueError(f"a {n_hosts} x {chips_per_host} grid needs "
                         f"{n_hosts * chips_per_host} ranks, the world has "
                         f"{dist.get_world_size()}")
    cols, rows = grid_ranks(n_hosts, chips_per_host)
    col_groups = [dist.new_group(list(r)) for r in cols]
    row_groups = [dist.new_group(list(r)) for r in rows]
    h, c = divmod(dist.get_rank(), chips_per_host)
    return ProcessGroupComm(col_groups[c]), ProcessGroupComm(row_groups[h])
