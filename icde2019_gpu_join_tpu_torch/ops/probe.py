"""Blocked-compare probe over radix partitions.

Port of `icde2019_gpu_join_tpu/ops/probe.py`, the XLA formulation: plain
torch, no kernel. Each partition contributes ceil(|R_p|/TR) * ceil(|S_p|/TS)
work items, the cross product of its R and S tiles; heavy partitions become
many items (the decompose_chains analog, src/join-primitives.cu:843-874).
Item w joins R rows [r_start[w], r_start[w] + r_len[w]) against S rows
[s_start[w], s_start[w] + s_len[w]) with a dense masked equality block:

    eq[i, j] = (Rk[i] == Sk[j]) & valid_r[i] & valid_s[j]

JAX scans the items 64 at a time (`lax.scan` over a `vmap`); here a host
loop walks them in batches whose [items, TR, TS] compare tensor holds at
most `_ITEM_ELEMS` elements. Sums wrap mod 2^32 and do not depend on the
batching.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32


@dataclasses.dataclass
class ProbePlan:
    """Static work-item table (host numpy; `as_device` copies it once).

    Item w joins R rows [r_start[w], r_start[w]+r_len[w]) against S rows
    [s_start[w], s_start[w]+s_len[w]); zero-length items are padding."""

    r_start: np.ndarray
    r_len: np.ndarray
    s_start: np.ndarray
    s_len: np.ndarray
    num_items: int
    tile_r: int
    tile_s: int

    @property
    def padded_items(self) -> int:
        return self.r_start.shape[0]

    def as_device(self, device="cuda") -> Tuple[torch.Tensor, ...]:
        return tuple(torch.from_numpy(a.astype(np.int32)).to(device)
                     for a in (self.r_start, self.r_len, self.s_start,
                               self.s_len))


def _ceil_div(a, b):
    return -(-a // b)


def plan_probe(counts_r: np.ndarray, offsets_r: np.ndarray,
               counts_s: np.ndarray, offsets_s: np.ndarray,
               tile_r: int = 256, tile_s: int = 256,
               pad_items_to: int = 1024) -> ProbePlan:
    """The work-item table from per-partition histograms (numpy), the item
    count padded to a multiple of pad_items_to."""
    counts_r = np.asarray(counts_r, dtype=np.int64)
    counts_s = np.asarray(counts_s, dtype=np.int64)
    offsets_r = np.asarray(offsets_r, dtype=np.int64)
    offsets_s = np.asarray(offsets_s, dtype=np.int64)

    nbr = _ceil_div(counts_r, tile_r)
    nbs = _ceil_div(counts_s, tile_s)
    m = np.where((counts_r > 0) & (counts_s > 0), nbr * nbs, 0)
    total = int(m.sum())

    part_of_item = np.repeat(np.arange(m.shape[0]), m)
    base = np.concatenate([[0], np.cumsum(m)])[:-1]
    within = np.arange(total) - np.repeat(base, m)
    nbs_i = nbs[part_of_item]
    ir = within // np.maximum(nbs_i, 1)
    is_ = within % np.maximum(nbs_i, 1)

    r_start = offsets_r[part_of_item] + ir * tile_r
    s_start = offsets_s[part_of_item] + is_ * tile_s
    r_len = np.minimum(tile_r, counts_r[part_of_item] - ir * tile_r)
    s_len = np.minimum(tile_s, counts_s[part_of_item] - is_ * tile_s)

    padded = max(pad_items_to, _ceil_div(total, pad_items_to) * pad_items_to)

    def pad(a):
        out = np.zeros(padded, dtype=np.int32)
        out[:total] = a
        return out

    return ProbePlan(pad(r_start), pad(r_len), pad(s_start), pad(s_len),
                     total, tile_r, tile_s)


# Elements of one batch's [items, TR, TS] compare tensor (at most); its
# int32 select is 4 bytes per element, 256 MiB.
_ITEM_ELEMS = 1 << 26


def _gather_tiles(keys, vals, start, length, tile: int):
    """[B, tile] rows of keys/vals from each item's start (indices clamped
    into range, as JAX clamps) and the [B, tile] validity mask."""
    iota = torch.arange(tile, dtype=torch.int64, device=keys.device)
    idx = (start.long()[:, None] + iota).clamp_(0, keys.shape[0] - 1)
    return keys[idx], vals[idx], iota < length.long()[:, None]


def _item_blocks(r_keys, r_vals, s_keys, s_vals, plan_dev, tile_r: int,
                 tile_s: int) -> Iterator[Tuple[slice, torch.Tensor,
                                                torch.Tensor, torch.Tensor]]:
    """Per batch of consecutive items: (the batch's item slice, eq
    [B, TR, TS], R values [B, TR], S values [B, TS]). Nothing when either
    side has no rows (every item is then empty)."""
    rs, rl, ss, sl = plan_dev
    if r_keys.shape[0] == 0 or s_keys.shape[0] == 0:
        return
    step = max(1, _ITEM_ELEMS // (tile_r * tile_s))
    for i in range(0, rs.shape[0], step):
        b = slice(i, i + step)
        rk, rv, r_ok = _gather_tiles(r_keys, r_vals, rs[b], rl[b], tile_r)
        sk, sv, s_ok = _gather_tiles(s_keys, s_vals, ss[b], sl[b], tile_s)
        eq = rk[:, :, None] == sk[:, None, :]
        eq &= r_ok[:, :, None]
        eq &= s_ok[:, None, :]
        yield b, eq, rv, sv


def _per_s_sums(eq: torch.Tensor, rv: torch.Tensor) -> torch.Tensor:
    """SUM over R of the matched R values per S column, [B, TS] int64."""
    return torch.where(eq, rv[:, :, None], 0).sum(1)


def blocked_probe_aggregate(r_keys, r_pay, s_keys, s_pay, r_start, r_len,
                            s_start, s_len, tile_r: int = 256,
                            tile_s: int = 256) -> torch.Tensor:
    """SUM(Pr*Ps) over matches, int32 wraparound, as a 0-d int32 tensor."""
    acc = torch.zeros((), dtype=torch.int64, device=r_keys.device)
    for _, eq, rp, sp in _item_blocks(r_keys, r_pay, s_keys, s_pay,
                                      (r_start, r_len, s_start, s_len),
                                      tile_r, tile_s):
        t = wrap_i32(_per_s_sums(eq, rp)).long()
        acc += ((t * sp.long()) & 0xFFFFFFFF).sum()
    return wrap_i32(acc)


def blocked_probe_count(r_keys, s_keys, r_start, r_len, s_start, s_len,
                        tile_r: int = 256, tile_s: int = 256) -> torch.Tensor:
    """Number of matching pairs as a 0-d int32 tensor, wrapping mod 2^32.
    JAX declares int64 but runs with x64 off, so its sum is int32 too."""
    acc = torch.zeros((), dtype=torch.int64, device=r_keys.device)
    for _, eq, _, _ in _item_blocks(r_keys, r_keys, s_keys, s_keys,
                                    (r_start, r_len, s_start, s_len),
                                    tile_r, tile_s):
        acc += eq.sum()
    return wrap_i32(acc)


def blocked_probe_item_counts(r_keys, s_keys, r_start, r_len, s_start, s_len,
                              tile_r: int = 256, tile_s: int = 256
                              ) -> torch.Tensor:
    """Match count per work item, int32 [W] (phase 1 of materialization)."""
    out = torch.zeros(r_start.shape[0], dtype=torch.int32,
                      device=r_keys.device)
    for b, eq, _, _ in _item_blocks(r_keys, r_keys, s_keys, s_keys,
                                    (r_start, r_len, s_start, s_len),
                                    tile_r, tile_s):
        out[b] = eq.sum((1, 2)).to(torch.int32)
    return out


def ring_slot(match_index: torch.Tensor, capacity: int) -> torch.Tensor:
    """The ring slot of a join's match_index-th match (int64; an item's base
    plus the match's place in the item): the index wrapped to int32, then
    mod capacity, non-negative. The reference adds base and place in int32,
    so past 2^31 - 1 the sum wraps before the modulo; with a capacity that
    is not a power of two, the modulo of the unwrapped sum would name
    another slot."""
    return torch.remainder(wrap_i32(match_index).long(), capacity)


def blocked_probe_materialize(r_keys, r_pay, s_keys, s_pay, r_start, r_len,
                              s_start, s_len, item_base: torch.Tensor,
                              capacity: int, tile_r: int = 256,
                              tile_s: int = 256
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write matched (Pr, Ps) pairs into two int32 rings of `capacity`.

    Item w's k-th match (row-major over its [TR, TS] block, as JAX
    flattens it) is match item_base[w] + k and lands in slot
    (item_base[w] + k) mod capacity, later matches overwriting earlier
    ones: the FOLD ring of src/join-primitives.cu:1099-1373. JAX scatters
    64 items per scan step; a batch here may hold more matches than the
    ring, so it writes only its last `capacity` matches, one writer per
    slot. Unused slots stay 0."""
    dev = r_keys.device
    out_r = torch.zeros(capacity, dtype=torch.int32, device=dev)
    out_s = torch.zeros(capacity, dtype=torch.int32, device=dev)
    for b, eq, rp, sp in _item_blocks(r_keys, r_pay, s_keys, s_pay,
                                      (r_start, r_len, s_start, s_len),
                                      tile_r, tile_s):
        item, r, s = eq.nonzero(as_tuple=True)   # row-major: item, r, s
        if item.numel() == 0:
            continue
        # k-th match of its item: its index in the batch minus the item's
        # first index
        per_item = torch.bincount(item, minlength=eq.shape[0])
        first = torch.cumsum(per_item, 0) - per_item
        k = torch.arange(item.numel(), device=dev) - first[item]
        g = item_base[b].long()[item] + k
        last = g >= g.max() - capacity + 1
        pos = ring_slot(g[last], capacity)
        out_r[pos] = rp[item[last], r[last]]
        out_s[pos] = sp[item[last], s[last]]
    return out_r, out_s


def blocked_probe_late_aggregate(r_keys, r_colsum, s_keys, s_colsum, r_start,
                                 r_len, s_start, s_len, tile_r: int = 256,
                                 tile_s: int = 256) -> torch.Tensor:
    """SUM over matches of (r_colsum + s_colsum), int32 wraparound
    (join_partitioned_varpayload analog, src/join-primitives.cu:1420-1557).
    The column sums are per row of the partitioned order. Computed per S
    column as t + h * s_colsum (t: matched r_colsum sum, h: matches),
    exact mod 2^32."""
    acc = torch.zeros((), dtype=torch.int64, device=r_keys.device)
    for _, eq, rc, sc in _item_blocks(r_keys, r_colsum, s_keys, s_colsum,
                                      (r_start, r_len, s_start, s_len),
                                      tile_r, tile_s):
        h = eq.sum(1)
        t = wrap_i32(_per_s_sums(eq, rc)).long()
        acc += ((t + h * sc.long()) & 0xFFFFFFFF).sum()
    return wrap_i32(acc)
