"""Banded sort-merge probe over sorted relations: the aggregate/count path.

Port of `icde2019_gpu_join_tpu/ops/band_join.py` (`:86-304`, `:780-797`,
`:820-836`). Both relations are sorted by the sign-flipped key, so the join
is a merge with block-level alignment:

  1. block summaries: min/max of every 128-row block;
  2. for each S block its exact matching R-block window [lo, hi), from the
     ranks of the sorted summaries (`_ranks_of_sorted_probes`);
  3. per round r: gather W R-blocks at lo + r*W for every S block whose
     window still has uncovered R-blocks, and reduce the chunk with the
     fused compare x multiply x sum (`ops/band_compare.py`).

The aggregate is SUM(Pr*Ps) with int32 wraparound
(src/join-primitives.cu:1052-1092); it does not depend on how the S blocks
are ordered or chunked.

Unlike the jitted JAX version, the round loop runs on the host: the number
of active S blocks in each round comes from one host read of the round-count
histogram, and each round walks its active prefix in chunks of
`_CHUNK_BLOCKS` S blocks.
"""

from __future__ import annotations

from typing import Tuple

import torch

from icde2019_gpu_join_tpu_torch.ops.band_compare import banded_compare_sum
from icde2019_gpu_join_tpu_torch.ops.bits import rotate_keys, wrap_i32

_BLK = 128

# S blocks per probe chunk. A chunk bounds the gathered arrays of one
# kernel launch, 4 * CH * 128 * (2 + 2W) bytes: 64 MiB at W = 1. The TPU
# path used 2048 blocks, sized to its on-chip memory; on the card a larger
# chunk means fewer host-side launches (2^27 S rows: 32 chunks per round).
_CHUNK_BLOCKS = 1 << 15


def _pad_sorted_input(keys: torch.Tensor, pay: torch.Tensor):
    """Pad to a 128 multiple (at least one block: empty relations become a
    pure-sentinel block) with sentinel rows (key -1 -> max sortval,
    payload 0: sorts to the end, contributes 0 to any aggregate)."""
    n = keys.shape[0]
    pad = (-n) % _BLK if n else _BLK
    if pad:
        keys = torch.cat([keys, keys.new_full((pad,), -1)])
        pay = torch.cat([pay, pay.new_zeros(pad)])
    return keys, pay


def sort_pairs(sv: torch.Tensor, pay: torch.Tensor):
    """(sortval, payload) sorted by signed int32 sortval; unstable, so the
    payload order among equal keys is unspecified."""
    sv_s, idx = torch.sort(sv)
    return sv_s, pay[idx]


def sort_by_key(keys: torch.Tensor, pay: torch.Tensor):
    """Sort (keys, pay) by uint32 key order; returns 128-padded tensors of
    (sortval, payload)."""
    keys, pay = _pad_sorted_input(keys, pay)
    return sort_pairs(rotate_keys(keys, 0, 0), pay)


def _ranks_of_sorted_probes(a: torch.Tensor, b: torch.Tensor,
                            a_first_on_ties: bool) -> torch.Tensor:
    """For each b[i] (b sorted ascending): the number of a-elements that sort
    before it, ties broken toward a if a_first_on_ties (# {a <= b[i]}) else
    toward b (# {a < b[i]}). One sort of (val, tag, index) packed in int64."""
    na, nb = a.shape[0], b.shape[0]
    if na >= (1 << 30) or nb >= (1 << 30):
        raise ValueError(f"too many blocks to rank: {na}, {nb}")
    dev = a.device
    tag_a, tag_b = (0, 1) if a_first_on_ties else (1, 0)
    packed = torch.cat([
        (tag_a << 30) | torch.arange(na, device=dev),
        (tag_b << 30) | torch.arange(1, nb + 1, device=dev),
    ])
    # packed is unique and in [0, 2^31), so (val, packed) order is total
    merged, _ = torch.sort(torch.cat([a, b]).long() * (1 << 32) + packed)
    packed_s = merged & 0xFFFFFFFF
    is_b = ((packed_s >> 30) & 1) == tag_b
    idx_s = packed_s & ((1 << 30) - 1)
    is_b_i = is_b.long()
    b_before = torch.cumsum(is_b_i, 0) - is_b_i
    a_before = torch.arange(na + nb, device=dev) - b_before
    # a-rows scatter into the spare last slot, which is dropped
    ranks = torch.zeros(nb + 1, dtype=torch.int64, device=dev)
    ranks.scatter_(0, torch.where(is_b, idx_s - 1, nb), a_before)
    return ranks[:nb].to(torch.int32)


def block_windows(r_sv: torch.Tensor, s_sv: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact matching R-block window [lo, hi) (int32) for every S block.

    R block j can contain a match for S block b iff
    r_bmax[j] >= s_bmin[b] and r_bmin[j] <= s_bmax[b]."""
    r2 = r_sv.view(-1, _BLK)
    s2 = s_sv.view(-1, _BLK)
    lo = _ranks_of_sorted_probes(r2.amax(1), s2.amin(1), a_first_on_ties=False)
    hi = _ranks_of_sorted_probes(r2.amin(1), s2.amax(1), a_first_on_ties=True)
    return lo, torch.maximum(hi, lo)


def banded_probe(r_sv: torch.Tensor, r_pay: torch.Tensor,
                 s_sv: torch.Tensor, s_pay: torch.Tensor,
                 window_blocks: int = 1, mode: str = "mul") -> torch.Tensor:
    """SUM(Pr*Ps) over key matches of sv-sorted 128-padded inputs; a 0-d
    int32 tensor (uint32 wraparound, the reference's semantics).

    S blocks are ordered by window width (widest first); round r processes
    only the prefix of blocks whose window still has uncovered R-blocks, so
    the compare work follows the true match volume under skew."""
    if mode != "mul":
        raise NotImplementedError(
            f"mode={mode!r} (late_aggregate) is not ported yet: ROADMAP.md "
            "queue 1, item 2")
    W = window_blocks
    nsb = s_sv.shape[0] // _BLK
    nrb = r_sv.shape[0] // _BLK
    lo, hi = block_windows(r_sv, s_sv)
    nrounds = (hi - lo + (W - 1)) // W
    _, bid_s = torch.sort(nrounds, descending=True)
    # one host read: blocks with exactly k rounds, for every k
    hist = torch.bincount(nrounds).tolist()

    r_svb = r_sv.view(-1, _BLK)
    r_payb = r_pay.view(-1, _BLK)
    s_svb = s_sv.view(-1, _BLK)
    s_payb = s_pay.view(-1, _BLK)
    warr = torch.arange(W, device=s_sv.device)
    lo, hi = lo.long(), hi.long()

    acc = torch.zeros((), dtype=torch.int64, device=s_sv.device)
    done = 0
    for r in range(len(hist) - 1):
        done += hist[r]
        cnt = nsb - done  # S blocks with more than r rounds
        for start in range(0, cnt, _CHUNK_BLOCKS):
            ids = bid_s[start:min(start + _CHUNK_BLOCKS, cnt)]
            n = ids.shape[0]
            bidx = (lo[ids] + r * W)[:, None] + warr[None, :]    # [n, W]
            valid = bidx < hi[ids][:, None]
            bidx = bidx.clamp_(max=nrb - 1).view(-1)
            rk = r_svb[bidx].view(n, W * _BLK)
            rp = r_payb[bidx]
            rp.view(n, W, _BLK).masked_fill_(~valid[:, :, None], 0)
            acc += banded_compare_sum(s_svb[ids], s_payb[ids], rk,
                                      rp.view(n, W * _BLK))
    return wrap_i32(acc)


def banded_join_aggregate(r_keys: torch.Tensor, r_pay: torch.Tensor,
                          s_keys: torch.Tensor, s_pay: torch.Tensor,
                          window_blocks: int = 1) -> torch.Tensor:
    """Sort both sides, then the banded probe: SUM(Pr*Ps) over key matches,
    int32 wraparound, as a 0-d int32 tensor."""
    r_sv, r_p = sort_by_key(r_keys, r_pay)
    s_sv, s_p = sort_by_key(s_keys, s_pay)
    return banded_probe(r_sv, r_p, s_sv, s_p, window_blocks, "mul")


def banded_join_count(r_keys: torch.Tensor, s_keys: torch.Tensor,
                      window_blocks: int = 1) -> torch.Tensor:
    """Match count (int32 wraparound; exact when < 2^31), computed as
    SUM(1*1) so the sentinel pad rows (payload 0) count nothing."""
    return banded_join_aggregate(r_keys, torch.ones_like(r_keys),
                                 s_keys, torch.ones_like(s_keys),
                                 window_blocks)
