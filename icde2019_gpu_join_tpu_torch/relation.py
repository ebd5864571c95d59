"""Relation containers: a (keys, payload) pair of int32 columns on one
device, and the radix-partitioned CSR layout (`PartitionedRelation`)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class Relation:
    """A (keys, payload) column pair of int32 tensors on `device`.

    KEY-DOMAIN CONTRACT (as in the JAX package): keys must be >= 0. The
    engine reserves -1 as the pad sentinel; a negative real key corrupts
    aggregates. Payload defaults to row ids."""

    def __init__(self, keys: torch.Tensor, payload: Optional[torch.Tensor] = None,
                 device=None):
        device = torch.device(device) if device is not None else keys.device
        if payload is None:
            payload = torch.arange(keys.shape[0], dtype=torch.int32,
                                   device=device)
        for name, col in (("keys", keys), ("payload", payload)):
            if col.dtype != torch.int32 or col.dim() != 1:
                raise ValueError(f"{name} must be a 1-D int32 tensor, got "
                                 f"{col.dtype} of shape {tuple(col.shape)}")
        if payload.shape != keys.shape:
            raise ValueError(f"payload shape {tuple(payload.shape)} != keys "
                             f"shape {tuple(keys.shape)}")
        self.keys = keys.to(device).contiguous()
        self.payload = payload.to(device).contiguous()

    @classmethod
    def from_numpy(cls, keys: np.ndarray, payload: Optional[np.ndarray] = None,
                   device="cpu") -> "Relation":
        k = torch.from_numpy(np.ascontiguousarray(keys, dtype=np.int32))
        p = None if payload is None else torch.from_numpy(
            np.ascontiguousarray(payload, dtype=np.int32))
        return cls(k, p, device)

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @property
    def num_rows(self) -> int:
        return self.keys.shape[0]

    def __repr__(self):
        return f"Relation(n={self.num_rows}, device={self.device})"


class PartitionedRelation:
    """CSR-partitioned relation (`ops/partition.radix_partition`).

    keys/payload: int32 rows grouped by partition id (ascending).
    counts[p]:    int32 rows in partition p, [2^total_bits].
    offsets[p]:   int32 exclusive prefix sum of counts, [2^total_bits + 1]
                  (offsets[-1] == num_rows).
    total_bits/first_bit: the radix geometry that produced it."""

    def __init__(self, keys: torch.Tensor, payload: torch.Tensor,
                 counts: torch.Tensor, offsets: torch.Tensor,
                 total_bits: int, first_bit: int):
        self.keys = keys
        self.payload = payload
        self.counts = counts
        self.offsets = offsets
        self.total_bits = total_bits
        self.first_bit = first_bit

    @classmethod
    def from_numpy(cls, keys, payload, counts, offsets, total_bits: int,
                   first_bit: int, device="cpu") -> "PartitionedRelation":
        """From host arrays, e.g. `np.asarray` of a JAX PartitionedRelation's
        fields; every column becomes an int32 tensor on `device`."""
        cols = (torch.from_numpy(np.array(a, dtype=np.int32)).to(device)
                for a in (keys, payload, counts, offsets))
        return cls(*cols, int(total_bits), int(first_bit))

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @property
    def num_rows(self) -> int:
        return self.keys.shape[0]

    @property
    def num_partitions(self) -> int:
        return self.counts.shape[0]

    def __repr__(self):
        return (f"PartitionedRelation(n={self.num_rows}, "
                f"parts=2^{self.total_bits}, first_bit={self.first_bit}, "
                f"device={self.device})")
