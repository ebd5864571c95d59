"""Radix partitioning into a dense CSR layout.

Port of `icde2019_gpu_join_tpu/ops/partition.py`. The partition is one sort
of (rotated key, payload): `rotate_keys` moves the radix field to the top
bits, so one sort groups rows by partition id and orders them by the rest of
the key within it; the keys are rotated back after the sort and the CSR
offsets come from a binary search of each partition's smallest sortval.

Layout contract (as in JAX): within a partition rows are ordered by the
rotated key, for first_bit = 0 ascending key order. `radix_partition` sorts
unstably, so the payload order among duplicate keys is unspecified (the
per-key payload multiset is kept); `radix_partition_multipass` is stable.
"""

from __future__ import annotations

import torch

from icde2019_gpu_join_tpu_torch.ops.band_join import sort_pairs
from icde2019_gpu_join_tpu_torch.ops.bits import (
    _SIGN,
    _shr,
    partition_boundaries,
    partition_ids,
    rotate_keys,
    unrotate_keys,
)
from icde2019_gpu_join_tpu_torch.relation import PartitionedRelation


def histogram(keys: torch.Tensor, total_bits: int, first_bit: int = 0) -> torch.Tensor:
    """Per-partition row counts, int32 [2^total_bits]."""
    p = partition_ids(keys, total_bits, first_bit)
    return torch.bincount(p, minlength=1 << total_bits).to(torch.int32)


def _csr_from_sorted_sortval(sv_sorted: torch.Tensor, total_bits: int):
    """(counts, offsets), int32, from the sorted rotated keys: a binary
    search of each partition's smallest sortval."""
    n = sv_sorted.shape[0]
    probes = partition_boundaries(total_bits, device=sv_sorted.device)
    offsets = torch.cat([
        torch.searchsorted(sv_sorted, probes, side="left").to(torch.int32),
        torch.full((1,), n, dtype=torch.int32, device=sv_sorted.device),
    ])
    return torch.diff(offsets), offsets


def radix_partition(keys: torch.Tensor, payload: torch.Tensor,
                    total_bits: int, first_bit: int = 0,
                    sort_impl: str = "lax") -> PartitionedRelation:
    """Partition (keys, payload) into 2^total_bits partitions, CSR layout,
    by one unstable (rotated key, payload) sort; sort_impl picks its
    implementation (`band_join.sort_pairs`)."""
    sv = rotate_keys(keys, total_bits, first_bit)
    sv_sorted, pays_s = sort_pairs(sv, payload, sort_impl)
    keys_s = unrotate_keys(sv_sorted, total_bits, first_bit)
    counts, offsets = _csr_from_sorted_sortval(sv_sorted, total_bits)
    return PartitionedRelation(keys_s, pays_s, counts, offsets, total_bits,
                               first_bit)


def radix_partition_multipass(keys: torch.Tensor, payload: torch.Tensor,
                              total_bits: int, first_bit: int = 0,
                              bits_per_pass: int = 8) -> PartitionedRelation:
    """LSD variant: stable passes over `bits_per_pass`-bit fields of the
    rotated key (as uint32), least significant first. They compose to the
    order of `radix_partition`, with ties in arrival order."""
    u = rotate_keys(keys, total_bits, first_bit) ^ _SIGN  # uint32 bits
    v = payload
    mask = (1 << bits_per_pass) - 1
    for f in range(-(-32 // bits_per_pass)):
        field = _shr(u, f * bits_per_pass) & mask
        _, idx = torch.sort(field, stable=True)
        u, v = u[idx], v[idx]
    sv_sorted = u ^ _SIGN
    keys_s = unrotate_keys(sv_sorted, total_bits, first_bit)
    counts, offsets = _csr_from_sorted_sortval(sv_sorted, total_bits)
    return PartitionedRelation(keys_s, v, counts, offsets, total_bits, first_bit)
