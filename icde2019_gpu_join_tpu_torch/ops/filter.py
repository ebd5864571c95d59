"""Filter (selection) with compaction.

Port of `icde2019_gpu_join_tpu/ops/filter.py`. The compacted output keeps the
input length and comes with the selected-row count: rows [0, count) are the
order-preserving survivors, the tail holds the dropped rows. Compaction is
one stable sort on the inverted mask (a filter is a 1-bit radix partition).
"""

from __future__ import annotations

from typing import Tuple

import torch

from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32


def filter_compact(keys: torch.Tensor, vals: torch.Tensor, lo, hi
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Select rows with lo <= key < hi. Returns (keys', vals', count)."""
    return filter_by_mask(keys, vals, (keys >= lo) & (keys < hi))


def filter_by_mask(keys: torch.Tensor, vals: torch.Tensor, keep: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Order-preserving compaction of rows where keep is True; the count is
    a 0-d int32 tensor."""
    _, idx = torch.sort((~keep).to(torch.uint8), stable=True)
    return keys[idx], vals[idx], wrap_i32(keep.sum())
