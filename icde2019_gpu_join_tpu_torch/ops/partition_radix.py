"""Histogram -> scan -> block-gather radix grouping.

Port of `icde2019_gpu_join_tpu/ops/partition_radix.py`, the prototype of the
reference's partition_pass_one/_two (src/join-primitives.cu:58-283,338-535)
that the distributed exchange uses to group rows by destination:

  1. reshape to [C, L] chunks and sort each chunk (the partition id rides
     the top bits of the unsigned key view, so a chunk sort groups runs);
  2. per-chunk histograms [C, P] -> exact run starts within each chunk;
  3. the destination block table: every (chunk, partition) run padded to
     128-row blocks (partition-major exclusive scan over block counts);
  4. one block-level gather moves everything; rows outside a run's [lo, hi)
     inside boundary blocks are masked to sentinels.

Output: partition-grouped columns with per-partition valid counts and the
block offsets of each partition's run (padding instead of bucket chains).

The chunk sort is `torch.sort` along dim 1 plus a payload gather; like the
JAX package's unstable `lax.sort`, it fixes the key order and leaves the
payload order among equal keys unspecified. Keys are int32 holding uint32
bits, so every right shift is logical (`bits._shr`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from icde2019_gpu_join_tpu_torch.ops.bits import _SIGN, _shr

_BLK = 128
_SENT = 0x7FFFFFFF


class GroupedColumns(NamedTuple):
    keys: torch.Tensor           # [n_padded] partition-grouped, 128-padded
    pays: torch.Tensor           # [n_padded]
    counts: torch.Tensor         # [P] valid rows per partition
    block_offsets: torch.Tensor  # [P+1] block offsets of each partition's run
    # valid rows of partition p: the non-sentinel rows in blocks
    # [block_offsets[p], block_offsets[p+1]) (sentinels interleave at
    # chunk-run boundaries; key sentinel 0x7FFFFFFF, payload 0)


def _geometry(n: int, chunk: int):
    """(L, C, pad): chunk length, chunk count and sentinel rows appended."""
    L = min(chunk, -(-max(n, 1) // _BLK) * _BLK)
    C = -(-n // L)
    return L, C, C * L - n


def _pids(keys: torch.Tensor, bits: int) -> torch.Tensor:
    """Partition id: the top `bits` of the unsigned view (sign bit flipped)."""
    if bits == 0:
        return torch.zeros_like(keys)
    return _shr(keys ^ _SIGN, 32 - bits)


def _chunk_hist(pid: torch.Tensor, P: int) -> torch.Tensor:
    """[C, P] int32 row counts of each partition in each chunk of pid [C, L]."""
    hist = torch.zeros((pid.shape[0], P), dtype=torch.int32, device=pid.device)
    return hist.scatter_add_(1, pid.long(), torch.ones_like(pid))


def _run_blocks(hist: torch.Tensor, L: int):
    """(g0, nblk) [C, P]: the global row where each (chunk, partition) run
    starts and the 128-row blocks it spans."""
    C = hist.shape[0]
    starts = torch.cumsum(hist, 1, dtype=torch.int32) - hist
    g0 = starts + torch.arange(C, dtype=torch.int32, device=hist.device)[:, None] * L
    nblk = torch.where(hist > 0, (g0 + hist - 1) // _BLK - g0 // _BLK + 1, 0)
    return g0, nblk


def _repeat_to(values: torch.Tensor, repeats: torch.Tensor,
               length: int) -> torch.Tensor:
    """`jnp.repeat(values, repeats, total_repeat_length=length)`: each value
    repeated its count, cut at `length`; when the counts sum to less, the
    last value fills the rest (`torch.repeat_interleave` requires the exact
    sum). Entry i is values[j] for the last j whose exclusive count prefix
    is <= i."""
    starts = torch.cumsum(repeats, 0) - repeats
    pos = torch.arange(length, dtype=starts.dtype, device=values.device)
    return values[torch.searchsorted(starts, pos, right=True) - 1]


def radix_group(keys: torch.Tensor, pays: torch.Tensor, bits: int,
                chunk: int = 4096,
                cap_blocks: Optional[int] = None) -> GroupedColumns:
    """Group rows by partition id = top `bits` of the unsigned key view.

    Rows inside a partition keep no particular order (grouping only). Pad
    and garbage rows carry key sentinel 0x7FFFFFFF, payload 0. `cap_blocks`
    (default: enough for any input) fixes the number of output blocks."""
    n = keys.shape[0]
    P = 1 << bits
    if chunk % _BLK:
        raise ValueError("chunk must be a 128 multiple")
    dev = keys.device
    L, C, pad = _geometry(n, chunk)
    if pad:
        keys = torch.cat([keys, keys.new_full((pad,), _SENT)])
        pays = torch.cat([pays, pays.new_zeros(pad)])

    # 1. chunk-local sort (sorting by key groups by pid: pid is a prefix of
    # the key's order bits)
    k2, idx = torch.sort(keys.view(C, L), dim=1)
    v2 = torch.gather(pays.view(C, L), 1, idx)
    # sentinel rows land in the top partition (counted out below)
    pid = _pids(k2, bits)

    # 2. per-chunk histograms + run starts
    hist = _chunk_hist(pid, P)                                # [C, P]
    # exclude sentinel pad rows from the last partition's count of the last
    # chunk (they sorted to its very end)
    valid_hist = hist.clone()
    if pad:
        valid_hist[C - 1, P - 1] -= pad

    # 3. destination block table, partition-major
    g0, nblk = _run_blocks(hist, L)
    run_lo = g0 % _BLK
    blk0 = g0 // _BLK
    nblk_pm = nblk.T.reshape(-1)                              # [P*C] p-major
    cum = torch.cumsum(nblk_pm, 0, dtype=torch.int32) - nblk_pm
    total_blocks = nblk_pm.sum()

    if cap_blocks is None:
        cap_blocks = (C * L) // _BLK + C * P
    run_id = _repeat_to(torch.arange(C * P, dtype=torch.int32, device=dev),
                        nblk_pm, cap_blocks)                  # p-major run
    run_start_blk = _repeat_to(cum, nblk_pm, cap_blocks)
    bpos = torch.arange(cap_blocks, dtype=torch.int32, device=dev) - run_start_blk

    run_id = run_id.long()
    src_blk = blk0.T.reshape(-1)[run_id] + bpos
    lo = run_lo.T.reshape(-1)[run_id]
    hi = lo + hist.T.reshape(-1)[run_id]
    in_range = torch.arange(cap_blocks, device=dev) < total_blocks

    # 4. block gather + boundary masking
    src_blk = torch.where(in_range, src_blk, 0).long()
    gk = k2.reshape(-1, _BLK)[src_blk]                        # [cap, 128]
    gv = v2.reshape(-1, _BLK)[src_blk]
    row = torch.arange(_BLK, dtype=torch.int32, device=dev)[None, :]
    abs_row = bpos[:, None] * _BLK + row
    valid = (abs_row >= lo[:, None]) & (abs_row < hi[:, None]) & in_range[:, None]
    gk = torch.where(valid, gk, _SENT)
    gv = torch.where(valid, gv, 0)

    counts = valid_hist.sum(0, dtype=torch.int32)
    pblocks = nblk.sum(0, dtype=torch.int32)                  # [P]
    block_offsets = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=dev),
        torch.cumsum(pblocks, 0, dtype=torch.int32)])
    return GroupedColumns(gk.reshape(-1), gv.reshape(-1), counts, block_offsets)


def grouped_block_counts(keys: torch.Tensor, bits: int,
                         chunk: int = 4096) -> torch.Tensor:
    """[P] int32: how many destination blocks radix_group(keys, ..., bits,
    chunk) lays out per partition (same geometry, same boundary-block
    padding, same sentinel accounting). Histograms only, no sort: an
    exchange planner derives exact grouped-frame caps from it
    (parallel/plan.plan_cap_grouped)."""
    n = keys.shape[0]
    P = 1 << bits
    L, C, pad = _geometry(n, chunk)
    pid = _pids(keys, bits)
    if pad:
        pid = torch.cat([pid, pid.new_full((pad,), P - 1)])   # sentinels -> P-1
    _, nblk = _run_blocks(_chunk_hist(pid.view(C, L), P), L)
    return nblk.sum(0, dtype=torch.int32)


def radix_sort_via_grouping(keys: torch.Tensor, pays: torch.Tensor,
                            bits: int = 5, chunk: int = 4096,
                            lmax_blocks: Optional[int] = None):
    """Full sort via one radix-group level + a per-partition sort.

    The measured prototype behind the JAX package's "radix vs flat sort"
    decision; the engine does not sort this way. Every partition is slotted
    into a [P, lmax_blocks*128] frame so the final sort batches; `overflow`
    > 0 means a partition outgrew the frame.

    Returns (keys_sorted_padded [P, lmax*128], pays_sorted_padded,
    n_valid_total, overflow_blocks). Sentinel rows (key 0x7FFFFFFF,
    payload 0) sort to each segment's tail."""
    g = radix_group(keys, pays, bits, chunk)
    P = 1 << bits
    nb = g.keys.shape[0] // _BLK
    if lmax_blocks is None:
        # 2x the uniform expectation over the partitions reachable by
        # non-negative keys (only P/2 of them fill), plus one boundary block
        # per (chunk, partition) run
        C = -(-keys.shape[0] // chunk)
        lmax_blocks = max(2 * nb // max(P // 2, 1) + C + 16, 1)
    pb = g.block_offsets[1:] - g.block_offsets[:-1]
    overflow = torch.clamp(pb - lmax_blocks, min=0).sum()
    jidx = torch.arange(lmax_blocks, dtype=torch.int32, device=keys.device)[None, :]
    ok = jidx < pb[:, None]
    src = torch.where(ok, g.block_offsets[:-1][:, None] + jidx, 0).long()
    okr = ok.reshape(-1)[:, None]
    kb = torch.where(okr, g.keys.view(-1, _BLK)[src.reshape(-1)], _SENT)
    vb = torch.where(okr, g.pays.view(-1, _BLK)[src.reshape(-1)], 0)
    ks, idx = torch.sort(kb.reshape(P, lmax_blocks * _BLK), dim=1)
    vs = torch.gather(vb.reshape(P, lmax_blocks * _BLK), 1, idx)
    return ks, vs, g.counts.sum(), overflow
