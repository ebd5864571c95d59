"""A late aggregate's column sums: each row's int32 columns, summed mod 2^32
and read at its row id.

    row_colsums(cols [n, c], rowid [m]) -> int32 [m]
    out[i] = sum(cols[id(rowid[i])]) mod 2^32

Row ids are read as JAX indexes: a negative id counts from the end (id + n),
then every id is clamped into [0, n - 1]. With no columns (c == 0) or no rows
(n == 0) every sum is 0.

cols is a 2-D int32 tensor at any strides and rowid a 1-D int32 tensor, on
the CPU or on one card. On CUDA tensors the kernel of `csrc/row_colsums.cu`
runs on the current stream: one launch reads each id and the row at it once
and writes one int32, whatever order the ids are in, at the tensors' own
strides (no copy). On CPU tensors the plain version runs:
`torch_row_colsums`, the sums as torch operations through int64.

It replaces no TPU kernel: the JAX package sums with library operations,
`jnp.sum(cols.astype(uint32), axis=1)[payload]`, whose counterpart on the
card was the plain version (ROADMAP R7a).

`LAUNCHES` counts kernel launches: one a call with at least one id and one
column, none otherwise.
"""

from __future__ import annotations

import torch

from icde2019_gpu_join_tpu_torch.ops import _launches
from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32

# Kernel launches since the last reset; only the CUDA path adds. With the C
# entry point's (pointers, int64 values); a stream follows them.
LAUNCHES = _launches.table(__name__, ("row_colsums",), {"row_colsums": (3, 6)})


def torch_row_colsums(cols: torch.Tensor, rowid: torch.Tensor) -> torch.Tensor:
    """`row_colsums`' plain version: the columns summed in int64, wrapped to
    int32, gathered at the ids after JAX's index rule."""
    if cols.numel() == 0:
        return torch.zeros_like(rowid)
    n = cols.shape[0]
    idx = torch.where(rowid < 0, rowid.long() + n, rowid.long()).clamp_(0, n - 1)
    return wrap_i32(cols.sum(1))[idx]


def _check(cols: torch.Tensor, rowid: torch.Tensor):
    if cols.dtype != torch.int32 or cols.dim() != 2:
        raise ValueError(f"cols: expected a 2-D int32 tensor, got {cols.dtype} "
                         f"{tuple(cols.shape)}")
    if rowid.dtype != torch.int32 or rowid.dim() != 1:
        raise ValueError(f"rowid: expected a 1-D int32 tensor, got "
                         f"{rowid.dtype} {tuple(rowid.shape)}")
    if cols.device != rowid.device:
        raise ValueError(f"cols on {cols.device} and rowid on {rowid.device} "
                         f"differ")
    if cols.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {cols.device}")


def row_colsums(cols: torch.Tensor, rowid: torch.Tensor) -> torch.Tensor:
    """Each row id's row of `cols` summed mod 2^32; see the module doc."""
    _check(cols, rowid)
    if not cols.is_cuda:
        return torch_row_colsums(cols, rowid)
    (n, c), m = cols.shape, rowid.shape[0]
    if n == 0 or c == 0:
        return torch.zeros_like(rowid)
    out = torch.empty(m, dtype=torch.int32, device=rowid.device)
    if m == 0:
        return out
    _launches.launch(LAUNCHES, "row_colsums", (cols, rowid, out), n, m, c,
                     *cols.stride(), rowid.stride(0))
    return out
