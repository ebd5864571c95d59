"""Radix sort over (key, payload) columns.

Port of `icde2019_gpu_join_tpu/ops/sort.py`: a stable sort by the low `bits`
of uint32(key), in one `torch.sort(stable=True)` or as explicit LSB-first
passes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from icde2019_gpu_join_tpu_torch.ops.bits import _SIGN, _shr


def _low_bits(keys: torch.Tensor, bits: int) -> torch.Tensor:
    """An int32 sort key whose signed order is the unsigned order of the
    low `bits` of uint32(key)."""
    if bits >= 32:
        return keys ^ _SIGN
    return keys & ((1 << bits) - 1)


def radix_sort(keys: torch.Tensor, payload: torch.Tensor, bits: int = 32,
               lsb_first_passes: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable sort by the low `bits` of uint32(key); payload carried along.

    lsb_first_passes > 1 composes ceil(bits / passes)-bit stable passes,
    least significant first (otherwise one sort)."""
    if lsb_first_passes <= 1:
        _, idx = torch.sort(_low_bits(keys, bits), stable=True)
        return keys[idx], payload[idx]
    per = -(-bits // lsb_first_passes)
    k, v = keys, payload
    shift = 0
    while shift < bits:
        b = min(per, bits - shift)
        _, idx = torch.sort(_low_bits(_shr(k, shift), b), stable=True)
        k, v = k[idx], v[idx]
        shift += b
    return k, v
