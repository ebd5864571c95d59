"""Exchange planning: exact bucket caps from a histogram pre-pass.

Port of `icde2019_gpu_join_tpu/parallel/plan.py`, the analog of the
reference's gain-driven re-planning (src/partition-primitives.cu:381-469):
caps come from measured per-(rank, destination) row counts, so an exchange
planned here cannot overflow.

Every function runs on each rank of a communicator (`parallel/comm.py`) with
that rank's shard. Where JAX runs one jitted `shard_map` pre-pass, a rank
here counts its own histogram and `comm.all_gather`s it: every rank then
holds the same [ranks, buckets] table, as a host numpy array, and derives
the same caps, which the ranks' collectives need. The host arithmetic is
numpy, as in JAX.

Histograms count with `torch.bincount`; the JAX package counts one-hot
compares (coarse) or sorts and searches (fine, `_fine_hist`), with equal
results.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from icde2019_gpu_join_tpu_torch.ops.bits import partition_ids, rotate_keys
from icde2019_gpu_join_tpu_torch.ops.partition_radix import grouped_block_counts

_BLK = 128


def _round_up(x: int, m: int) -> int:
    return -(-int(x) // m) * m


def _cap(x) -> int:
    """A cap covering x rows: 128-rounded, at least one block."""
    return max(_BLK, _round_up(x, _BLK))


def _local_hist(keys: torch.Tensor, bits: int, first_bit: int) -> torch.Tensor:
    """[2^bits] int32 destination histogram of one shard."""
    pid = partition_ids(keys, bits, first_bit)
    return torch.bincount(pid, minlength=1 << bits).to(torch.int32)


def _fine_hist(keys: torch.Tensor, bits: int, first_bit: int) -> torch.Tensor:
    """_local_hist without key -1, whose rotated sortval 0x7FFFFFFF lies past
    the end of the JAX fine histogram's search (the key domain, keys >= 0,
    never holds it)."""
    return _local_hist(keys[keys != -1], bits, first_bit)


def _gathered(comm, local: torch.Tensor) -> np.ndarray:
    """[ranks, *local.shape] host table of every rank's `local`."""
    return comm.all_gather(local[None]).cpu().numpy()


def _gathered_2d(host_comm, chip_comm, local: torch.Tensor) -> np.ndarray:
    """[nh * nc, *local.shape], host-major: gathered over the chips of my
    host, then over the hosts."""
    row = chip_comm.all_gather(local[None])
    return host_comm.all_gather(row).cpu().numpy()


def destination_histograms(keys: torch.Tensor, comm, num_buckets: int,
                           first_bit: int) -> np.ndarray:
    """[ranks, num_buckets] per-source-rank destination row counts."""
    if num_buckets == 1:
        # every row of a shard goes to bucket 0; shards are equal (the
        # module-wide contract, checked by the entry points)
        return np.full((comm.size, 1), keys.shape[0], dtype=np.int32)
    bits = (num_buckets - 1).bit_length()
    return _gathered(comm, _local_hist(keys, bits, first_bit))[:, :num_buckets]


def plan_cap(keys: torch.Tensor, comm, num_buckets: int,
             first_bit: int = 0) -> int:
    """Exact bucket cap (rows, 128-rounded) for a one-level exchange: the
    max over (source rank, destination) of the real row count."""
    return _cap(destination_histograms(keys, comm, num_buckets,
                                       first_bit).max())


def plan_caps_2level(keys: torch.Tensor, host_comm, chip_comm,
                     first_bit: int = 0) -> Tuple[int, int]:
    """Exact (cap_host, cap_chip) for the two-level exchange.

    Level 1 buckets rows by host bits [first_bit, first_bit+hbits); level 2
    by the chip bits above them. Level-1 frame pads are masked out of the
    second pass (exchange.partition_to_buckets(valid=...)), so the caps
    cover real rows only."""
    nh, nc = host_comm.size, chip_comm.size
    hbits = (nh - 1).bit_length()   # 0 when the level is a single bucket
    cbits = (nc - 1).bit_length()
    h = _gathered_2d(host_comm, chip_comm,
                     _local_hist(keys, hbits + cbits, first_bit))
    joint = h.reshape(nh, nc, 1 << (hbits + cbits))
    # destination id d = h + (c << hbits): joint[h0, c0, h, c] = rows on
    # source (h0, c0) with host bits h and chip bits c
    joint = joint[..., : nh * nc].reshape(nh, nc, nc, nh).transpose(0, 1, 3, 2)
    cap_h = _cap(joint.sum(axis=3).max())
    # level-2 input of chip (h, c0): over source hosts h0, the rows from
    # column c0 destined to host h, per level-2 destination c
    cap_c = _cap(joint.sum(axis=0).max())
    return cap_h, cap_c


def plan_cap_grouped(keys: torch.Tensor, comm, num_buckets: int,
                     first_bit: int = 0, chunk: int = 4096) -> int:
    """Exact bucket cap (rows) for grouped frames
    (exchange.partition_to_buckets_grouped): the max over (source rank,
    destination) of the blocks radix_group lays out, boundary and sentinel
    padding included."""
    if num_buckets == 1:
        # a single destination: the frame is a pass-through of the shard
        return _cap(keys.shape[0])
    bits = (num_buckets - 1).bit_length()
    pb = grouped_block_counts(rotate_keys(keys, bits, first_bit), bits, chunk)
    return max(_BLK, int(_gathered(comm, pb).max()) * _BLK)


def plan_cap_segmented(keys: torch.Tensor, comm, num_buckets: int,
                       first_bit: int, segments: int, method: str,
                       chunk: int = 4096) -> int:
    """Exact per-segment bucket cap for the segmented exchange: each shard
    is cut into `segments` equal probe segments, bucketed one by one; the
    cap is the max over (rank, segment, destination) of the fill (rows for
    method "sort", laid-out block rows for "group")."""
    if num_buckets == 1:
        return _cap(keys.shape[0] // segments)
    bits = (num_buckets - 1).bit_length()
    if method == "group":
        per = [grouped_block_counts(rotate_keys(k, bits, first_bit), bits,
                                    chunk).max() * _BLK
               for k in keys.view(segments, -1)]
    else:
        per = [_local_hist(k, bits, first_bit).max()
               for k in keys.view(segments, -1)]
    # one host read for all segments and ranks
    return _cap(_gathered(comm, torch.stack(per).max()).max())


def heavy_destinations(hist: np.ndarray, threshold_factor: float = 4.0
                       ) -> np.ndarray:
    """Destination ids whose global row count exceeds threshold_factor x
    the uniform expectation, the distributed analog of decompose_chains'
    oversized-partition detection (src/join-primitives.cu:843-874). `hist`
    is [ranks, buckets]."""
    totals = hist.sum(axis=0)
    expect = max(1.0, totals.sum() / hist.shape[1])
    return np.nonzero(totals > threshold_factor * expect)[0].astype(np.int32)


# --- Heavy-hitter split planning (PRPD skew handling) -----------------------
#
# The distributed analog of the reference's skew machinery (decompose_chains,
# src/join-primitives.cu:843-874, and the knapsack batcher,
# src/partition-primitives.cu:307-469): find fine radix buckets whose probe
# rows would swamp one rank, and handle them PRPD-style (partial
# redistribution, partial duplication): their build rows are all-gathered to
# every rank and their probe rows join where they live; everything else
# rides the normal all-to-all.


class HeavySplitPlan:
    """Plan of the heavy-split exchange (the same on every rank)."""

    def __init__(self, heavy_ids: Tuple[int, ...], fbits: int, cap_r: int,
                 cap_s: int, cap_rh: int, load_rows: np.ndarray):
        self.heavy_ids = tuple(int(h) for h in heavy_ids)
        self.fbits = int(fbits)
        self.cap_r = int(cap_r)    # normal R bucket cap (heavy excluded)
        self.cap_s = int(cap_s)    # normal S bucket cap (heavy excluded,
        #                            per segment when planned segmented)
        self.cap_rh = int(cap_rh)  # per-rank heavy-R broadcast frame rows
        self.load_rows = load_rows  # [ranks] projected probe rows per rank

    @property
    def split(self) -> bool:
        return len(self.heavy_ids) > 0


def fine_histograms(keys: torch.Tensor, comm, fbits: int, first_bit: int = 0,
                    segments: int = 1) -> np.ndarray:
    """[ranks, segments, 2^fbits] per-rank, per-segment fine radix
    histogram."""
    per = torch.stack([_fine_hist(k, fbits, first_bit)
                       for k in keys.view(segments, -1)])
    return _gathered(comm, per)


def fine_histograms_2d(keys: torch.Tensor, host_comm, chip_comm, fbits: int,
                       first_bit: int = 0) -> np.ndarray:
    """[nh*nc, 2^fbits] per-rank fine radix histogram over a 2-D mesh
    (host-major rank order)."""
    return _gathered_2d(host_comm, chip_comm,
                        _fine_hist(keys, fbits, first_bit))


def _heavy_set(hist_s: np.ndarray, tot_s: np.ndarray, nfine: int, nd: int,
               heavy_fraction: float, max_heavy: int) -> np.ndarray:
    """The heavy fine buckets: S count over heavy_fraction x the uniform
    per-rank share, at most max_heavy of them (the largest)."""
    factor = heavy_fraction * nfine / nd
    heavy = heavy_destinations(hist_s, factor)
    if len(heavy) > max_heavy:
        heavy = np.sort(heavy[np.argsort(tot_s[heavy])[::-1][:max_heavy]])
    return heavy


def plan_heavy_split(
    r_keys: torch.Tensor, s_keys: torch.Tensor, comm, num_buckets: int,
    first_bit: int = 0, extra_bits: int = 6, heavy_fraction: float = 0.25,
    max_heavy: int = 128, segments: int = 1,
) -> HeavySplitPlan:
    """Plan the PRPD heavy-split exchange from one fine-histogram pre-pass
    a side.

    A fine bucket (destination bits + extra_bits more) is heavy when its
    global S row count exceeds heavy_fraction x the uniform per-rank share
    (n_s / ranks). At most max_heavy buckets split (the largest).

    Caps are exact: cap_r / cap_s cover the normal exchange with heavy rows
    excluded; cap_rh the largest per-rank heavy R residue."""
    nd = comm.size
    if num_buckets != nd:
        raise ValueError("plan_heavy_split plans the rank-destination "
                         f"exchange: num_buckets must equal the number of "
                         f"ranks ({num_buckets} != {nd})")
    dbits = (nd - 1).bit_length()
    fbits = min(dbits + extra_bits, 22)
    nfine = 1 << fbits
    hist_s = fine_histograms(s_keys, comm, fbits, first_bit,
                             segments)                    # [nd, seg, nfine]
    hist_r = fine_histograms(r_keys, comm, fbits, first_bit, 1)
    tot_s = hist_s.sum(axis=(0, 1))                       # [nfine]
    heavy = _heavy_set(hist_s.sum(axis=1), tot_s, nfine, nd, heavy_fraction,
                       max_heavy)
    mask = np.ones(nfine, bool)
    mask[heavy] = False
    # the destination of fine bucket f is its low dbits (nd is a power of 2)
    m3 = mask.reshape(-1, nd)
    hs = hist_s.reshape(hist_s.shape[0], segments, -1, nd)
    hr = hist_r.reshape(hist_r.shape[0], 1, -1, nd)
    norm_s = (hs * m3[None, None]).sum(axis=2)            # [nd, seg, nd]
    norm_r = (hr * m3[None, None]).sum(axis=2)            # [nd, 1, nd]
    cap_s = _cap(norm_s.max())
    cap_r = _cap(norm_r.max())
    if len(heavy):
        cap_rh = _cap(hist_r[:, 0][:, ~mask].sum(axis=1).max())
    else:
        cap_rh = _BLK
    # projected probe rows per rank: normal S received + heavy S kept local
    # (the R broadcast is the same everywhere and left out of the spread)
    recv_s = norm_s.sum(axis=(0, 1))                      # [nd] received
    local_heavy_s = hist_s.sum(axis=1)[:, ~mask].sum(axis=1)
    load = recv_s + local_heavy_s
    return HeavySplitPlan(tuple(int(h) for h in heavy), fbits, cap_r, cap_s,
                          cap_rh, load.astype(np.int64))


class HeavySplit2LevelPlan:
    """PRPD plan for the two-level exchange: heavy fine buckets and exact
    per-level caps with heavy rows excluded (the same on every rank)."""

    def __init__(self, heavy_ids: Tuple[int, ...], fbits: int,
                 cap_r_h: int, cap_s_h: int, cap_r_c: int, cap_s_c: int,
                 cap_rh: int, load_rows: np.ndarray):
        self.heavy_ids = tuple(int(h) for h in heavy_ids)
        self.fbits = int(fbits)
        self.cap_r_h = int(cap_r_h)  # level-1 (host) R bucket cap
        self.cap_s_h = int(cap_s_h)  # level-1 (host) S bucket cap
        self.cap_r_c = int(cap_r_c)  # level-2 (chip) R bucket cap
        self.cap_s_c = int(cap_s_c)  # level-2 (chip) S bucket cap
        self.cap_rh = int(cap_rh)    # per-rank heavy-R broadcast frame rows
        self.load_rows = load_rows   # [nh*nc] projected probe rows per rank

    @property
    def split(self) -> bool:
        return len(self.heavy_ids) > 0


def plan_heavy_split_2level(
    r_keys: torch.Tensor, s_keys: torch.Tensor, host_comm, chip_comm,
    first_bit: int = 0, extra_bits: int = 6, heavy_fraction: float = 0.25,
    max_heavy: int = 128,
) -> HeavySplit2LevelPlan:
    """PRPD heavy-split plan for the two-level exchange (decompose_chains
    applies to every strategy, src/join-primitives.cu:843-874).

    Fine bucket ids (dbits = hbits + cbits destination bits at first_bit,
    extra_bits more above): f = h + (c << hbits) + (rest << dbits), host
    bits low, as the two-level exchange splits them. Heavy as in
    plan_heavy_split; caps exact with heavy rows excluded at level 1."""
    nh, nc = host_comm.size, chip_comm.size
    nd = nh * nc
    hbits = (nh - 1).bit_length()
    cbits = (nc - 1).bit_length()
    if nh != 1 << hbits or nc != 1 << cbits:
        raise ValueError("mesh axes must be powers of two")
    dbits = hbits + cbits
    fbits = min(dbits + extra_bits, 22)
    nfine = 1 << fbits
    nrest = nfine >> dbits
    hist_s = fine_histograms_2d(s_keys, host_comm, chip_comm, fbits,
                                first_bit)                  # [nd, nfine]
    hist_r = fine_histograms_2d(r_keys, host_comm, chip_comm, fbits,
                                first_bit)
    heavy = _heavy_set(hist_s, hist_s.sum(axis=0), nfine, nd, heavy_fraction,
                       max_heavy)
    mask = np.ones(nfine, bool)
    mask[heavy] = False
    # hist[src, f] with f = rest*(nc*nh) + c*nh + h
    m5 = mask.reshape(1, 1, nrest, nc, nh)
    hs = hist_s.reshape(nh, nc, nrest, nc, nh) * m5   # [h0, c0, rest, c, h]
    hr = hist_r.reshape(nh, nc, nrest, nc, nh) * m5
    # level 1: rows from source (h0, c0) to host h
    cap_s_h = _cap(hs.sum(axis=(2, 3)).max())
    cap_r_h = _cap(hr.sum(axis=(2, 3)).max())
    # level 2: source chip (h, c0) holds, over h0, the rows to host h from
    # column c0; per level-2 destination chip c
    cap_s_c = _cap(hs.sum(axis=(0, 2)).max())
    cap_r_c = _cap(hr.sum(axis=(0, 2)).max())
    cap_rh = _cap(hist_r[:, ~mask].sum(axis=1).max()) if len(heavy) else _BLK
    # projected probe rows per destination (h, c): normal S received + heavy
    # S kept local at that position
    recv = hs.sum(axis=(0, 1, 2)).T.reshape(-1)       # [c, h] -> host-major
    local_heavy_s = hist_s[:, ~mask].sum(axis=1)
    load = recv + local_heavy_s
    return HeavySplit2LevelPlan(
        tuple(int(h) for h in heavy), fbits, cap_r_h, cap_s_h, cap_r_c,
        cap_s_c, cap_rh, load.astype(np.int64))
