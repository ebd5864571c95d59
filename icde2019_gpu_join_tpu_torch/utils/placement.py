"""Memory placement policies (the MEM_TYPE analog) and the host-to-device
copy path of the out-of-memory regimes.

Port of `icde2019_gpu_join_tpu/utils/placement.py`. The reference chooses
where relations live (MEM_HOST pinned mapped memory / MEM_DEVICE / MEM_MANAGED,
src/common.h:74-86, src/main.cu:162-184). In torch the axis is a tensor's
device and whether its host memory is pinned:

    "hbm", "device"  the card's memory (the default; MEM_DEVICE analog)
    "pinned_host"    a CPU tensor in page-locked memory, which the card's copy
                     engine reads directly (MEM_HOST cudaHostAlloc analog)
    "unpinned_host"  a pageable CPU tensor
    "host"           host numpy, streamed explicitly by the engine

`place` moves an array to the policy's memory; `placement_sharding` has no
torch counterpart of a sharding, so it validates the policy and returns what
`place` will do: a `Placement(device, pinned)`. With `device="cpu"` there is
no card to pin for, and "pinned_host" is pageable; with a card, a failed pin
raises and never falls back to pageable memory.

`Uploader` is the copy path of `models/streaming.py` and
`models/coprocess.py`: host tensors go to the card on a copy stream of their
own, and the compute stream waits on one event per upload.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

_POLICIES = ("hbm", "device", "pinned_host", "unpinned_host")

# host tensors that `Uploader.put` sent to a card, by their host memory
COPIES = {"pinned": 0, "pageable": 0}

# One copy stream per card for the process. The caching allocator keeps
# freed device memory in a pool per stream, so uploads on the same stream
# reuse the memory of earlier calls' uploads; with a new stream per call
# that memory stayed stranded, and every upload paid a cudaMalloc.
_COPY_STREAMS = {}


def reset_copies():
    for key in COPIES:
        COPIES[key] = 0


class Placement(NamedTuple):
    device: torch.device
    pinned: bool


def placement_sharding(policy: str, device="cuda") -> Placement:
    """Where `place(x, policy, device)` puts a tensor. "host" (numpy) has no
    tensor placement and raises, as an unknown policy does."""
    if policy not in _POLICIES:
        raise ValueError(f"unknown placement policy: {policy!r}")
    device = torch.device(device)
    if policy in ("hbm", "device"):
        return Placement(device, False)
    return Placement(torch.device("cpu"),
                     policy == "pinned_host" and device.type == "cuda")


def host_numpy(x) -> np.ndarray:
    """A contiguous int32 numpy array of x's values on the host (a view
    where x already lies there; a CUDA tensor is read back)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, dtype=np.int32)


def pinned_empty(n: int, device="cuda") -> torch.Tensor:
    """An int32 host tensor of n rows, page-locked when `device` is a card
    (its copies to the card are then asynchronous); pageable otherwise."""
    return torch.empty(n, dtype=torch.int32,
                       pin_memory=torch.device(device).type == "cuda")


def place(x, policy: str, device="cuda"):
    """Place an array per policy. "host" returns host numpy; the others a
    tensor on `placement_sharding(policy, device)`."""
    if policy == "host":
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    target = placement_sharding(policy, device)
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    if target.pinned:
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
    return t.to(target.device)


def place_relation(rel, policy: str, device="cuda"):
    """Place a Relation's columns per policy (returns a new Relation; under
    "host" its columns are CPU tensors over the numpy arrays)."""
    from icde2019_gpu_join_tpu_torch.relation import Relation

    cols = [place(c, policy, device) for c in (rel.keys, rel.payload)]
    if policy == "host":
        cols = [torch.from_numpy(c) for c in cols]
    return Relation(*cols)


class Uploader:
    """Host -> device copies for a pipeline that overlaps them with compute.

    On a card each `put` runs on the card's copy stream with
    `non_blocking=True` (asynchronous when the source is pinned), records
    one event, and marks each new tensor as used by the compute stream (the
    stream current when the uploader was made), so that the caching
    allocator does not hand its memory to a later upload while a kernel
    still reads it. `wait` makes the compute stream wait for an upload.
    `COPIES` counts the tensors sent from pinned and from pageable memory.

    On the CPU, `Tensor.to("cpu")` returns the source itself, so a staging
    buffer that is refilled later would change a segment already "on the
    device": `put` copies instead (JAX's `device_put` may alias numpy the
    same way, `models/streaming.py:95-99` of the JAX package). This is the
    only place where the pipelines branch on the device."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        if self.on_card:
            self.compute_stream = torch.cuda.current_stream(self.device)
            index = self.compute_stream.device_index
            if index not in _COPY_STREAMS:
                _COPY_STREAMS[index] = torch.cuda.Stream(self.device)
            self.copy_stream = _COPY_STREAMS[index]

    def put(self, *host: torch.Tensor
            ) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.cuda.Event]]:
        """(the tensors on the device, the event that marks their copy;
        None on the CPU, where the copy is done on return)."""
        if not self.on_card:
            return tuple(t.to(self.device, copy=True) for t in host), None
        for t in host:
            COPIES["pinned" if t.is_pinned() else "pageable"] += 1
        with torch.cuda.stream(self.copy_stream):
            out = tuple(t.to(self.device, non_blocking=True) for t in host)
            event = torch.cuda.Event()
            event.record(self.copy_stream)
        for t in out:
            t.record_stream(self.compute_stream)
        return out, event

    def wait(self, event: Optional[torch.cuda.Event]):
        """Order the compute stream after an upload (no-op on the CPU)."""
        if event is not None:
            self.compute_stream.wait_event(event)
