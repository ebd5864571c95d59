"""Sort-merge equi-join via vectorized binary search.

Port of `icde2019_gpu_join_tpu/ops/join_sorted.py`: the non-partitioned
baseline (the reference's perfect-hash / global-chain baselines,
src/join-primitives.cu:620-742 analog) for general keys. Sort the build side
by uint32 key, prefix-sum its payloads, and binary-search every probe key.

Torch has no uint32 sort or searchsorted; keys are compared as the
sign-flipped int32 `rotate_keys(k, 0, 0)`, whose signed order is the uint32
order. Sums wrap mod 2^32 (src/join-primitives.cu:885-1095).
"""

from __future__ import annotations

from typing import Tuple

import torch

from icde2019_gpu_join_tpu_torch.ops.bits import rotate_keys, wrap_i32

# Probe rows per chunk (JAX probes in separate dispatches of this size;
# wraparound sums are associative, so chunking never changes the result).
_PROBE_CHUNK = 1 << 24


def _sorted_build(r_keys: torch.Tensor, r_pay: torch.Tensor):
    """Build side in uint32 key order (as sortvals) and the exclusive prefix
    sums of its payloads (int64; their differences are exact mod 2^32)."""
    ks, idx = torch.sort(rotate_keys(r_keys, 0, 0), stable=True)
    pref = torch.zeros(ks.shape[0] + 1, dtype=torch.int64, device=ks.device)
    pref[1:] = torch.cumsum(r_pay[idx].long(), 0)
    return ks, pref


def _probe_chunk_sum(ks, pref, cu, cp) -> torch.Tensor:
    """SUM over the chunk's probe rows of (matching Pr sum) * Ps, mod 2^32,
    as an int64 below 2^63."""
    lo = torch.searchsorted(ks, cu, side="left")
    hi = torch.searchsorted(ks, cu, side="right")
    sub = wrap_i32(pref[hi] - pref[lo]).long()   # sum of matching Pr per row
    return ((sub * cp.long()) & 0xFFFFFFFF).sum()


def sort_merge_aggregate(r_keys: torch.Tensor, r_pay: torch.Tensor,
                         s_keys: torch.Tensor, s_pay: torch.Tensor
                         ) -> torch.Tensor:
    """SUM(Pr*Ps) over matches, int32 wraparound, as a 0-d int32 tensor."""
    ks, pref = _sorted_build(r_keys, r_pay)
    su = rotate_keys(s_keys, 0, 0)
    total = torch.zeros((), dtype=torch.int64, device=ks.device)
    for lo in range(0, su.shape[0], _PROBE_CHUNK):
        hi = lo + _PROBE_CHUNK
        total += _probe_chunk_sum(ks, pref, su[lo:hi], s_pay[lo:hi])
        total &= 0xFFFFFFFF
    return wrap_i32(total)


def sort_merge_count(r_keys: torch.Tensor, s_keys: torch.Tensor) -> torch.Tensor:
    """Number of matching pairs as a 0-d int32 tensor, wrapping mod 2^32.
    JAX declares int64 but runs with x64 off, so its sum is int32 too."""
    ks, _ = torch.sort(rotate_keys(r_keys, 0, 0))
    su = rotate_keys(s_keys, 0, 0)
    lo = torch.searchsorted(ks, su, side="left")
    hi = torch.searchsorted(ks, su, side="right")
    return wrap_i32((hi - lo).sum())


def sort_merge_lookup(r_keys: torch.Tensor, s_keys: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For unique-key build sides: the index into R (int32) of each S row's
    match (undefined where absent) and the match mask."""
    ks, order = torch.sort(rotate_keys(r_keys, 0, 0), stable=True)
    su = rotate_keys(s_keys, 0, 0)
    pos = torch.searchsorted(ks, su, side="left")
    pos_c = torch.clamp(pos, max=ks.shape[0] - 1)
    return order[pos_c].to(torch.int32), ks[pos_c] == su
