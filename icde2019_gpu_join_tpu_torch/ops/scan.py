"""Prefix sums and reductions with the engine's int32 wraparound.

Port of `icde2019_gpu_join_tpu/ops/scan.py` (the reference's block/grid
scan and reduce library, src/common.cu:106-880). JAX's int32 arithmetic
wraps; torch's `cumsum` and `sum` promote int32 to int64, so every int32
result is reduced mod 2^32 with `bits.wrap_i32`. The "u32" results are
int32 tensors holding uint32 bits (the convention of `bits.py`): read them
through `.numpy().view(np.uint32)`. Floating-point inputs keep their dtype;
their sums may differ from JAX's in the order of summation.
"""

from __future__ import annotations

import torch

from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32


def _as_dtype_of(total: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A cumsum or sum of x back in x's dtype: int32 wraps mod 2^32."""
    if x.dtype == torch.int32:
        return wrap_i32(total)
    return total.to(x.dtype)


def exclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along dim 0, same dtype. As in JAX, the result
    has x's length, except that an empty x gives [0]."""
    c = _as_dtype_of(torch.cumsum(x, 0), x)
    return torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device), c[:-1]])


def offsets_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """CSR offsets [parts + 1] from per-partition counts."""
    c = _as_dtype_of(torch.cumsum(counts, 0), counts)
    return torch.cat([torch.zeros(1, dtype=counts.dtype, device=counts.device), c])


def wrap_prefix_u32(vals: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums of int32 values mod 2^32 with a leading zero,
    as uint32 bits in an int32 tensor: the wraparound-safe building block
    of segmented sums."""
    c = wrap_i32(torch.cumsum(vals.to(torch.int64), 0))
    return torch.cat([torch.zeros(1, dtype=torch.int32, device=vals.device), c])


def aggregate(x: torch.Tensor, func_id: int) -> torch.Tensor:
    """min / max / sum by id (reference `aggregate` kernel,
    src/common.cu:763-778: funcId 0 = min, 1 = max, 2 = sum); a 0-d tensor."""
    if func_id == 0:
        return torch.min(x)
    if func_id == 1:
        return torch.max(x)
    if func_id == 2:
        return _as_dtype_of(torch.sum(x), x)
    raise ValueError(f"unknown funcId {func_id}")


def segmented_sum_u32(vals: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Per-segment sums mod 2^32 given CSR offsets [segments + 1], as uint32
    bits in an int32 tensor."""
    pref = wrap_prefix_u32(vals).to(torch.int64)
    off = offsets.to(torch.int64)
    return wrap_i32(pref[off[1:]] - pref[off[:-1]])


def associative_scan_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan (JAX's log-depth `associative_scan`, the analog of the
    reference's tree-structured totalPrefixSum, src/common.cu:838-880):
    int32 wraps, so integer results equal JAX's bit for bit."""
    return _as_dtype_of(torch.cumsum(x, 0), x)
