"""Hash aggregate (group-by COUNT / SUM).

Port of `icde2019_gpu_join_tpu/ops/groupby.py`: group-by over an integer
group-id domain by a stable sort, a binary search of the group boundaries
and wraparound-safe prefix sums, with no scatter-adds and no atomics; and,
for small group domains, a one-hot contraction in blocks of 2048 rows. JAX
computes both outside any Pallas kernel, so both are plain torch here.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch

from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32

_BLOCK = 2048               # rows per one-hot block, as in JAX
_ONEHOT_ELEMENTS = 1 << 25  # one-hot elements built at once (128 MiB)


def groupby_count_sum(gids: torch.Tensor, vals: torch.Tensor, num_groups: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group COUNT (int32) and SUM(vals) (int32, wraparound).

    gids must lie in [0, num_groups)."""
    g_sorted, order = torch.sort(gids, stable=True)
    probes = torch.arange(num_groups + 1, dtype=g_sorted.dtype,
                          device=gids.device)
    offsets = torch.searchsorted(g_sorted, probes, side="left")  # int64
    counts = torch.diff(offsets).to(torch.int32)
    # exact int64 prefix sums (fewer than 2^32 int32 rows); their
    # differences reduced mod 2^32 are JAX's uint32 prefix differences
    pref = torch.cat([torch.zeros(1, dtype=torch.int64, device=gids.device),
                      torch.cumsum(vals[order], 0)])
    return counts, wrap_i32(pref[offsets[1:]] - pref[offsets[:-1]])


@contextlib.contextmanager
def _ieee_fp32_matmul():
    """float32 matmuls at full precision for the block, the caller's
    setting restored after it: TF32 rounds the products' inputs to 10 bits
    of mantissa, and the one-hot sums are exact only in full float32. Uses
    the per-backend setting where torch has it, the legacy flag before."""
    m = torch.backends.cuda.matmul
    name, ieee = (("fp32_precision", "ieee") if hasattr(m, "fp32_precision")
                  else ("allow_tf32", False))
    old = getattr(m, name)
    setattr(m, name, ieee)
    try:
        yield
    finally:
        setattr(m, name, old)


def groupby_count_sum_onehot(gids: torch.Tensor, vals: torch.Tensor,
                             num_groups: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one-hot path for small num_groups (JAX's MXU path).

    Exact for counts, and for sums while each block's exact per-group sum
    fits float32's 2^24 integer window: blocks of 2^11 rows with int32
    accumulation across blocks keep it exact for |vals| < 2^13. For general
    int32 vals use groupby_count_sum. Blocks are contracted in batches of
    at most 2^25 one-hot elements."""
    n = gids.shape[0]
    pad = (-n) % _BLOCK
    g = torch.nn.functional.pad(gids, (0, pad), value=num_groups)
    v = torch.nn.functional.pad(vals, (0, pad))
    g = g.view(-1, _BLOCK)
    v = v.view(-1, 1, _BLOCK).to(torch.float32)
    iota = torch.arange(num_groups, dtype=gids.dtype, device=gids.device)
    counts = torch.zeros(num_groups, dtype=torch.int64, device=gids.device)
    sums = torch.zeros(num_groups, dtype=torch.int64, device=gids.device)
    step = max(1, _ONEHOT_ELEMENTS // (_BLOCK * max(num_groups, 1)))
    with _ieee_fp32_matmul():
        for lo in range(0, g.shape[0], step):
            onehot = (g[lo:lo + step, :, None] == iota).to(torch.float32)
            # per block: counts and sums, exact integers in float32
            counts += onehot.sum(1).to(torch.int32).sum(0)
            sums += torch.bmm(v[lo:lo + step], onehot)[:, 0].to(torch.int32).sum(0)
    return wrap_i32(counts), wrap_i32(sums)
