"""Meshes of ranks for the distributed join.

Counterpart of `icde2019_gpu_join_tpu/parallel/mesh.py`. The reference has no
distributed layer (single GPU, PCIe streams); JAX's meshes are 1-D ("x") for
chips of one host and 2-D ("host", "chip") for a slice whose exchange rides
the fast links inside a host and the slow ones across hosts.

Two kinds here:

* `Mesh` (`make_mesh`, `make_mesh_2d`): virtual ranks as threads of this
  process on one device (`comm.ThreadWorld`), the counterpart of JAX's mesh
  of devices. `run` cuts global tensors into equal row blocks in rank order
  (host-major on a 2-D mesh, like `PartitionSpec((host, chip))`), runs a
  per-rank function on each and returns the results in rank order. On one
  card this is how more than one rank runs: NCCL refuses two ranks of a
  world on one device.
* `GroupMesh` (`group_mesh`, `group_mesh_2d`): this process's rank of a
  `torch.distributed` world (NCCL on the card, gloo on the CPU); the caller
  has initialised the process group. It holds the communicators only: a
  process holds its own shard, and the `*_local` entry points of
  `dist_join` take them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from icde2019_gpu_join_tpu_torch.parallel.comm import (
    ProcessGroupComm,
    ThreadWorld,
    grid_ranks,
    process_grid_comms,
)


class Mesh:
    """Virtual ranks in a grid of named axes, run as threads on `device`."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 device="cuda", timeout: float = 300.0):
        if len(shape) != len(axis_names) or len(shape) not in (1, 2):
            raise ValueError(f"a mesh has 1 or 2 named axes, not {axis_names} "
                             f"of shape {shape}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))
        self.size = int(np.prod(shape))
        self.device = torch.device(device)
        self.world = ThreadWorld(self.size, timeout)

    def _groups(self, rank: int) -> Dict[str, Tuple[int, ...]]:
        """The ranks of each axis's group of `rank`."""
        if len(self.axis_names) == 1:
            return {self.axis_names[0]: tuple(range(self.size))}
        host, chip = self.axis_names
        cols, rows = grid_ranks(self.shape[host], self.shape[chip])
        h, c = divmod(rank, self.shape[chip])
        return {host: cols[c], chip: rows[h]}

    def run(self, fn: Callable, *tensors) -> List:
        """fn(comms, *shards) on every rank, where comms maps each axis name
        to the rank's communicator and shards are the rank's row blocks of
        `tensors` (moved to the mesh's device; their lengths must divide the
        mesh size). Returns the results in rank order."""
        blocks = []
        for x in tensors:
            x = torch.as_tensor(x, device=self.device)
            if x.shape[0] % self.size:
                raise ValueError(f"{x.shape[0]} rows do not shard evenly "
                                 f"over {self.size} ranks")
            blocks.append(x.view(self.size, -1, *x.shape[1:]))

        def rank_fn(rank: int):
            comms = {axis: self.world.comm(rank, ranks)
                     for axis, ranks in self._groups(rank).items()}
            return fn(comms, *(b[rank] for b in blocks))

        return self.world.run(rank_fn)


def make_mesh(n_devices: Optional[int] = None, axis: str = "x",
              device="cuda", timeout: float = 300.0) -> Mesh:
    """A 1-D mesh of `n_devices` virtual ranks on `device`. JAX takes the
    first n devices, all of them by default; here every rank is a thread on
    the one device, so the default is one rank, the device itself."""
    return Mesh((n_devices or 1,), (axis,), device, timeout)


def make_mesh_2d(n_hosts: int, chips_per_host: int,
                 axes: Tuple[str, str] = ("host", "chip"), device="cuda",
                 timeout: float = 300.0) -> Mesh:
    """A host-major (host, chip) mesh of virtual ranks on `device`."""
    return Mesh((n_hosts, chips_per_host), axes, device, timeout)


class GroupMesh:
    """This process's rank of a `torch.distributed` world over named axes;
    its tensors live where the process group's backend wants them (the card
    for NCCL, the CPU for gloo)."""

    def __init__(self, comms: Dict[str, ProcessGroupComm]):
        self.comms = comms
        self.shape: Dict[str, int] = {a: c.size for a, c in comms.items()}

    def comm(self, axis: str) -> ProcessGroupComm:
        return self.comms[axis]


def group_mesh(axis: str = "x", group=None) -> GroupMesh:
    """The 1-D mesh of the process group `group` (None: the world)."""
    return GroupMesh({axis: ProcessGroupComm(group)})


def group_mesh_2d(n_hosts: int, chips_per_host: int,
                  axes: Tuple[str, str] = ("host", "chip")) -> GroupMesh:
    """A host-major (host, chip) mesh over the whole world; every rank
    must call it (it creates the row and column groups)."""
    host, chip = process_grid_comms(n_hosts, chips_per_host)
    return GroupMesh({axes[0]: host, axes[1]: chip})
