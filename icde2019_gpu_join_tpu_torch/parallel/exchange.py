"""Distributed radix shuffle: each rank partitions by destination, then one
all-to-all.

Port of `icde2019_gpu_join_tpu/parallel/exchange.py`, the replacement for
the reference's only interconnect, PCIe cudaMemcpyAsync streams
(src/hash_join_clustered_probe.cu:1312-1330). Each rank partitions its shard
by destination rank (the radix field's low bits), lays each destination
bucket into a padded frame of fixed width, and one all-to-all over the
communicator (`parallel/comm.py`) delivers every row to the rank that owns
its key range.

Exchange invariant: the multiset of rows with payload != 0 is preserved.
Padding rows carry payload 0, which adds nothing to SUM(Pr*Ps), so
aggregates and counts-as-sums are exact with frames of fixed width.
Overflowed rows (a bucket over its cap) are counted and returned; with caps
from plan.plan_cap (the exact histogram pre-pass) there are none.

Two bucketing methods:

* `partition_to_buckets` (sort-based): one sort of (rotated key, payload)
  groups by destination and orders by key within. Frames are cut at
  128-row block boundaries (one alignment block of slack a bucket), with
  (start, count) per bucket so a receiver can rebuild the exact valid mask.
* `partition_to_buckets_grouped` (`radix_group`): grouping without order
  inside a bucket, at the price of about one boundary block of interior
  padding per (chunk, destination) run; for receivers that sort anyway.

Bucket contents are deterministic as multisets; the row order inside a
bucket is key-sorted for the sort method (ties in no fixed order) and
unspecified for the grouped method.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from icde2019_gpu_join_tpu_torch.ops.bits import (
    partition_boundaries,
    rotate_keys,
    unrotate_keys,
)
from icde2019_gpu_join_tpu_torch.ops.radix_pairs import radix_sort_pairs
from icde2019_gpu_join_tpu_torch.ops.partition_radix import radix_group

_BLK = 128
_SENT = 0x7FFFFFFF  # sorts after every real row: keys are >= 0 (the engine's
# key-domain contract), so a rotated sortval has a zero bit at 31-s and
# stays below 0x7FFFFFFF


class BucketFrames(NamedTuple):
    keys: torch.Tensor      # [num_buckets, frame_rows] int32
    pays: torch.Tensor      # [num_buckets, frame_rows] int32
    start: torch.Tensor     # [num_buckets] first valid slot of each frame
    count: torch.Tensor     # [num_buckets] valid rows per frame
    overflow: torch.Tensor  # 0-d int32: rows dropped (0 => exact)


def frame_rows(cap: int) -> int:
    """Frame width for a bucket cap: cap + one 128-row alignment block."""
    if cap % _BLK:
        raise ValueError("cap must be a 128 multiple (plan.plan_cap)")
    return cap + _BLK


def _spread_pad_keys(gidx: torch.Tensor) -> torch.Tensor:
    """Non-negative pad keys spread over the key space (Knuth multiplicative
    hash of the slot index, uint32) so later re-bucketing or banded probing
    never meets a long run of equal pad keys; their payloads are 0, so a
    collision with a real key adds nothing."""
    h = (gidx.long() * 2654435761) & 0xFFFFFFFF
    return (h >> 1).to(torch.int32)


def _pad_to(x: torch.Tensor, n: int, fill: int) -> torch.Tensor:
    if x.shape[0] >= n:
        return x
    return torch.cat([x, x.new_full((n - x.shape[0],), fill)])


def _i32(x) -> torch.Tensor:
    return x.to(torch.int32)


def partition_to_buckets(
    keys: torch.Tensor,
    pays: torch.Tensor,
    num_buckets: int,
    cap: int,
    first_bit: int,
    valid: Optional[torch.Tensor] = None,
) -> BucketFrames:
    """Sort-based bucketing into block-aligned frames (see module doc).

    `valid`: optional bool mask; invalid rows are masked out of every
    bucket (they count toward no cap and never ride the exchange as live
    rows), which keeps two-level caps exact despite level-1 frame padding.
    """
    if num_buckets & (num_buckets - 1):
        raise ValueError("num_buckets must be a power of two")
    dev = keys.device
    if num_buckets == 1:
        # One rank: every row belongs to bucket 0. A sort on one bit would
        # route half the rows to a phantom bucket, so sort (valid rows to the
        # front), take up to cap and emit one padded frame.
        rot = rotate_keys(keys, 0, first_bit)
        if valid is not None:
            rot = torch.where(valid, rot, _SENT)
            pays = torch.where(valid, pays, 0)
            count = _i32(valid.sum())
        else:
            count = torch.tensor(keys.shape[0], dtype=torch.int32, device=dev)
        F = frame_rows(cap)
        rot_s, pays_s = radix_sort_pairs(_pad_to(rot, F, _SENT),
                                         _pad_to(pays, F, 0))
        take = torch.clamp(count, max=cap)
        idx = torch.arange(F, dtype=torch.int32, device=dev)
        live = idx < take
        out_k = torch.where(live, unrotate_keys(rot_s[:F], 0, first_bit),
                            _spread_pad_keys(idx))
        out_p = torch.where(live, pays_s[:F], 0)
        return BucketFrames(out_k[None, :], out_p[None, :],
                            torch.zeros(1, dtype=torch.int32, device=dev),
                            take.reshape(1), count - take)
    bits = (num_buckets - 1).bit_length()
    rot = rotate_keys(keys, bits, first_bit)
    if valid is not None:
        rot = torch.where(valid, rot, _SENT)
        pays = torch.where(valid, pays, 0)
    n = rot.shape[0] + (-rot.shape[0] % _BLK)
    rot_s, pays_s = radix_sort_pairs(_pad_to(rot, n, _SENT),
                                     _pad_to(pays, n, 0))

    bounds = torch.cat([partition_boundaries(bits, dev),
                        torch.tensor([_SENT], dtype=torch.int32, device=dev)])
    offsets = _i32(torch.searchsorted(rot_s, bounds, side="left"))
    counts = offsets[1:] - offsets[:-1]             # real rows per bucket
    take = torch.clamp(counts, max=cap)
    overflow = _i32((counts - take).sum())

    capb = cap // _BLK + 1                          # frame blocks
    nb = n // _BLK
    b0 = offsets[:-1] // _BLK                       # [buckets]
    blk = b0[:, None] + torch.arange(capb, dtype=torch.int32, device=dev)
    blk_c = torch.clamp(blk.reshape(-1), 0, nb - 1).long()
    kb = rot_s.view(-1, _BLK)[blk_c]                # [buckets*capb, 128]
    vb = pays_s.view(-1, _BLK)[blk_c]
    gidx = (blk.reshape(-1, 1) * _BLK
            + torch.arange(_BLK, dtype=torch.int32, device=dev))
    lo = offsets[:-1].repeat_interleave(capb)[:, None]
    hi = (offsets[:-1] + take).repeat_interleave(capb)[:, None]
    live = (gidx >= lo) & (gidx < hi)
    out_k = torch.where(live, unrotate_keys(kb, bits, first_bit),
                        _spread_pad_keys(gidx))
    out_p = torch.where(live, vb, 0)
    F = capb * _BLK
    return BucketFrames(out_k.reshape(num_buckets, F),
                        out_p.reshape(num_buckets, F),
                        offsets[:-1] - b0 * _BLK, take, overflow)


def partition_to_buckets_grouped(
    keys: torch.Tensor,
    pays: torch.Tensor,
    num_buckets: int,
    cap: int,
    first_bit: int,
    chunk: int = 4096,
) -> BucketFrames:
    """radix_group-based bucketing: grouping only, no order inside a bucket.
    Interior (chunk-run boundary) padding rows ride inside the frames, so
    `cap` must budget for them: use plan.plan_cap_grouped. `start` is 0 and
    `count` counts valid rows, but valid rows are not a prefix (pads are
    interspersed): no valid-aware receiver; use it where the receiver sorts
    (one level)."""
    if num_buckets & (num_buckets - 1):
        raise ValueError("num_buckets must be a power of two")
    dev = keys.device
    if num_buckets == 1:
        # One rank: a pass-through into a single frame. Liveness is by
        # position (the rows are an untouched prefix), never a compare with
        # the sentinel: a real key of 0x7FFFFFFF is in the key domain.
        F = (cap // _BLK) * _BLK
        n = keys.shape[0]
        k = _pad_to(keys, F, 0)[:F]
        p = _pad_to(pays, F, 0)[:F]
        idx = torch.arange(F, dtype=torch.int32, device=dev)
        live = idx < n
        out_k = torch.where(live, k, _spread_pad_keys(idx))
        out_p = torch.where(live, p, 0)
        return BucketFrames(
            out_k[None, :], out_p[None, :],
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.full((1,), min(n, F), dtype=torch.int32, device=dev),
            torch.tensor(max(n - F, 0), dtype=torch.int32, device=dev))
    bits = (num_buckets - 1).bit_length()
    # the rotation puts the destination bits on top, where radix_group reads
    # its partition id (it flips the sign bit back: pid == destination)
    g = radix_group(rotate_keys(keys, bits, first_bit), pays, bits, chunk)
    capb = cap // _BLK
    pb = g.block_offsets[1:] - g.block_offsets[:-1]
    take_b = torch.clamp(pb, max=capb)
    # dropped blocks (only when cap was guessed, not planned), each counted
    # as a full block of rows
    overflow = _i32((pb - take_b).sum() * _BLK)
    nb_tot = g.keys.shape[0] // _BLK
    ar = torch.arange(capb, dtype=torch.int32, device=dev)
    blk = g.block_offsets[:-1][:, None] + ar
    in_run = ar[None, :] < take_b[:, None]
    blk_c = torch.clamp(blk.reshape(-1), 0, max(nb_tot - 1, 0)).long()
    kb = g.keys.view(-1, _BLK)[blk_c]
    vb = g.pays.view(-1, _BLK)[blk_c]
    live = in_run.reshape(-1)[:, None] & (kb != _SENT)
    gidx = (blk.reshape(-1, 1) * _BLK
            + torch.arange(_BLK, dtype=torch.int32, device=dev))
    out_k = torch.where(live, unrotate_keys(kb, bits, first_bit),
                        _spread_pad_keys(gidx))
    out_p = torch.where(live, vb, 0)
    F = capb * _BLK
    return BucketFrames(out_k.reshape(num_buckets, F),
                        out_p.reshape(num_buckets, F),
                        torch.zeros(num_buckets, dtype=torch.int32, device=dev),
                        g.counts[:num_buckets], overflow)


def all_to_all_exchange(bucket_keys: torch.Tensor, bucket_pays: torch.Tensor,
                        comm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shuffle padded bucket frames over the communicator: row block d of
    my buckets goes to rank d; I receive one block from every rank."""
    return comm.all_to_all(bucket_keys), comm.all_to_all(bucket_pays)


def all_to_all_meta(start: torch.Tensor, count: torch.Tensor, comm
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exchange per-bucket (start, count) with the frames so the receiver
    can rebuild the exact valid mask of what it got."""
    return comm.all_to_all(start), comm.all_to_all(count)


def frames_valid_mask(start: torch.Tensor, count: torch.Tensor,
                      frame: int) -> torch.Tensor:
    """[num_buckets, frame] bool: which received slots hold real rows
    (sort-based frames only: valid rows are [start, start+count))."""
    j = torch.arange(frame, dtype=torch.int32, device=start.device)[None, :]
    return (j >= start[:, None]) & (j < (start + count)[:, None])
