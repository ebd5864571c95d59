"""Radix partition ids and the bijective sort-key rotation, on int32 tensors.

Keys are int32 but hashed as uint32 (src/common.h:45-47), so every right
shift is logical. Torch's int32 `>>` is arithmetic and uint32 tensors have
no `>>`, so each right shift is masked to the bits it keeps.
"""

from __future__ import annotations

import torch

from icde2019_gpu_join_tpu_torch.config import hasht

_SIGN = -2**31  # 0x80000000 as an int32


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32, reducing mod 2^32 (two's-complement wraparound)."""
    return (x & 0xFFFFFFFF).to(torch.int32)


def _shr(u: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of an int32 tensor holding uint32 bits."""
    return (u >> s) & ((1 << (32 - s)) - 1) if s else u


def partition_ids(keys: torch.Tensor, total_bits: int, first_bit: int = 0) -> torch.Tensor:
    """int32 partition id in [0, 2^total_bits) for each key."""
    u = hasht(keys)
    return _shr(u, first_bit) & ((1 << total_bits) - 1)


def rotate_keys(keys: torch.Tensor, total_bits: int, first_bit: int = 0) -> torch.Tensor:
    """rotr(uint32(key), first_bit + total_bits) with the sign bit flipped,
    so signed int32 order is the unsigned order of the rotated key: one sort
    groups by partition id and orders within each partition."""
    s = (first_bit + total_bits) % 32
    u = hasht(keys)
    if s:
        u = _shr(u, s) | (u << (32 - s))
    return u ^ _SIGN


def unrotate_keys(sortval: torch.Tensor, total_bits: int, first_bit: int = 0) -> torch.Tensor:
    """Inverse of rotate_keys (exact key recovery)."""
    s = (first_bit + total_bits) % 32
    u = sortval ^ _SIGN
    if s:
        u = (u << s) | _shr(u, 32 - s)
    return u


def partition_boundaries(total_bits: int, device="cuda") -> torch.Tensor:
    """The smallest sortval of each partition. Shape [2^total_bits], int32."""
    p = torch.arange(1 << total_bits, dtype=torch.int64, device=device)
    return wrap_i32((p << (32 - total_bits)) ^ (1 << 31))
