"""Banded sort-merge probe over sorted relations: aggregate, per-S probe and
materialization.

Port of `icde2019_gpu_join_tpu/ops/band_join.py`. Both relations are sorted
by the sign-flipped key, so the join is a merge with block-level alignment:

  1. block summaries: min/max of every 128-row block;
  2. for each S block its exact matching R-block window [lo, hi), from the
     ranks of the sorted summaries (`_ranks_of_sorted_probes`);
  3. per round r: the W R-blocks at lo + r*W of every S block whose window
     still has uncovered R-blocks, against that S block, in a kernel of
     `ops/band_compare.py`. Every probe hands the kernel the block views
     and the round's S block ids, and it reads the windows itself
     (`banded_window_sum`, `banded_window_per_s`, `banded_window_first`);
     JAX gathers each chunk first and hands the kernel the chunk.

Unlike the jitted JAX version, the round loop runs on the host
(`_probe_schedule`, shared by every probe): the number of active S blocks
in each round comes from one host read of the round-count histogram, and
each round walks its active prefix in chunks of `_CHUNK_BLOCKS` S blocks.
Block ids are unique within a round, so per-S results accumulate straight
into [S blocks, 128] arrays by block id; JAX's padded descriptors and its
inverse-permutation scatter have no counterpart.

Aggregates are SUM with int32 wraparound (src/join-primitives.cu:1052-1092);
they do not depend on how the S blocks are ordered or chunked.

Spans (`utils/profiling`): `tpujoin.sort` a side, `tpujoin.probe` a probe
call with its `tpujoin.windows`, `tpujoin.reduce` the "add" probe's sum
after it, `tpujoin.extract` materialize's extraction, `tpujoin.sync` each
host read; `ops/_launches.EVENTS["probe_rounds"]` counts the rounds each
schedule walks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from icde2019_gpu_join_tpu_torch.ops import _launches
from icde2019_gpu_join_tpu_torch.ops.band_compare import (
    INT32_MAX,
    R_PAD_SV as _R_PAD_SV,
    banded_compare_per_s,
    banded_interval_select,
    banded_window_first,
    banded_window_per_s,
    banded_window_sum,
)
from icde2019_gpu_join_tpu_torch.ops.bits import rotate_keys, wrap_i32
from icde2019_gpu_join_tpu_torch.ops.extract_pairs import (
    extract_pairs,
    torch_extract_pairs,
)
from icde2019_gpu_join_tpu_torch.ops.merge import (
    merge_sort_pairs,
    packed_sort_pairs,
)
from icde2019_gpu_join_tpu_torch.ops.radix_pairs import radix_sort_pairs
from icde2019_gpu_join_tpu_torch.utils import profiling

_BLK = 128

# S blocks per probe chunk: the rows of one kernel launch. The TPU path used
# 2048 blocks, sized to its on-chip memory; on the card a larger chunk means
# fewer host-side launches (2^27 S rows: 32 chunks per round).
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


SORT_IMPLS = ("lax", "merge", "packed")


def resolve_sort_impl(sort_impl: Optional[str]) -> str:
    """The name of the sort a call runs: None is "lax", as in the reference,
    whose default every function below shares; an unknown name raises.
    There is no process-wide default and no environment variable."""
    impl = "lax" if sort_impl is None else sort_impl
    if impl not in SORT_IMPLS:
        raise ValueError(f"unknown sort_impl {sort_impl!r}")
    return impl


def sort_pairs(sv: torch.Tensor, pay: torch.Tensor,
               sort_impl: Optional[str] = None):
    """The engine's hot (sortval, payload) sort: signed int32 ascending.
    All three implementations agree on the key order and on the per-key
    payload multiset; the payload order among equal keys is unspecified, and
    every caller compares its results as sums or multisets.

    sort_impl (`EngineConfig.sort_impl`; `resolve_sort_impl`): None or
    "lax", the config's name for the library sort, here
    `ops/radix_pairs.radix_sort_pairs` (on the card the stable radix pair
    sort of `csrc/radix_pairs.cu`; on the CPU `torch.sort` and a payload
    gather); "merge", the merge-tree cascade of ops/merge.py; "packed", one
    sort of (sortval << 32 | payload) words."""
    impl = resolve_sort_impl(sort_impl)
    if impl == "merge":
        return merge_sort_pairs(sv, pay)
    if impl == "packed":
        return packed_sort_pairs(sv, pay)
    return radix_sort_pairs(sv, pay)


def sort_by_key(keys: torch.Tensor, pay: torch.Tensor,
                sort_impl: Optional[str] = None):
    """Sort (keys, pay) by uint32 key order; returns 128-padded tensors of
    (sortval, payload)."""
    with profiling.annotate("tpujoin.sort"):
        keys, pay = _pad_sorted_input(keys, pay)
        return sort_pairs(rotate_keys(keys, 0, 0), pay, sort_impl)


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
    with profiling.annotate("tpujoin.windows"):
        r2 = r_sv.view(-1, _BLK)
        s2 = s_sv.view(-1, _BLK)
        lo = _ranks_of_sorted_probes(r2.amax(1), s2.amin(1),
                                     a_first_on_ties=False)
        hi = _ranks_of_sorted_probes(r2.amin(1), s2.amax(1),
                                     a_first_on_ties=True)
        return lo, torch.maximum(hi, lo)


def _probe_schedule(r_sv: torch.Tensor, s_sv: torch.Tensor, w: int):
    """The probe schedule, planned on the host from one read.

    S blocks are ordered by window width (widest first); round r covers
    R blocks lo + r*w .. lo + r*w + w-1 of only the prefix of blocks whose
    window still has uncovered R blocks, so the work follows the true match
    volume under skew. Returns (lo, hi, chunks): the windows [S blocks]
    (int32, `block_windows`), and an iterator over (r, ids) for each chunk
    of that prefix, ids the S block ids (int64, unique within a round)."""
    nsb = s_sv.shape[0] // _BLK
    lo, hi = block_windows(r_sv, s_sv)
    nrounds = (hi - lo + (w - 1)) // w
    _, bid_s = torch.sort(nrounds, descending=True)
    # one host read: blocks with exactly k rounds, for every k
    with profiling.host_wait():
        hist = torch.bincount(nrounds).tolist()
    _launches.count(_launches.EVENTS, "probe_rounds", len(hist) - 1)

    def chunks():
        done = 0
        for r in range(len(hist) - 1):
            done += hist[r]
            cnt = nsb - done  # S blocks with more than r rounds
            for start in range(0, cnt, _CHUNK_BLOCKS):
                yield r, bid_s[start:min(start + _CHUNK_BLOCKS, cnt)]
    return lo, hi, chunks()


def banded_probe(r_sv: torch.Tensor, r_pay: torch.Tensor,
                 s_sv: torch.Tensor, s_pay: torch.Tensor,
                 window_blocks: int = 1, mode: str = "mul") -> torch.Tensor:
    """SUM over key matches of sv-sorted 128-padded inputs of Pr*Ps
    (mode "mul") or Pr+Ps (mode "add"); a 0-d int32 tensor (uint32
    wraparound, the reference's semantics).

    "mul" runs the windowed kernel 1 on the block views: one uint32
    accumulator for every chunk. "add" runs the windowed per-S kernel into
    (h, t) per S row, then SUM(Pr+Ps) = SUM_l (t_l + h_l*sp_l) mod 2^32,
    once after the last round, exact. R keys outside a window are masked to
    the R-pad sentinel, so S pad rows (the same sentinel) count such columns
    in h, but their sp is 0 and every t they get is 0, so they add nothing,
    as in JAX."""
    if mode not in ("mul", "add"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "add":
        h, t = banded_probe_per_s(r_sv, r_pay, s_sv, window_blocks)
        with profiling.annotate("tpujoin.reduce"):
            # int64 wraps mod 2^64, a multiple of 2^32: the low word stays
            # exact
            return wrap_i32(t.sum() + (h.long() * s_pay).sum())
    with profiling.annotate("tpujoin.probe"):
        r_svb = r_sv.view(-1, _BLK)
        r_payb = r_pay.view(-1, _BLK)
        s_svb = s_sv.view(-1, _BLK)
        s_payb = s_pay.view(-1, _BLK)
        lo, hi, chunks = _probe_schedule(r_sv, s_sv, window_blocks)
        acc = torch.zeros(1, dtype=torch.int32, device=s_sv.device)
        for r, ids in chunks:
            banded_window_sum(s_svb, s_payb, r_svb, r_payb, ids, lo, hi, r,
                              window_blocks, acc)
        return acc[0]


def banded_probe_per_s(r_sv: torch.Tensor, r_pay: torch.Tensor,
                       s_sv: torch.Tensor, window_blocks: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-S-row probe: (h, t) int32, aligned with the given sorted S order;
    h[i] = number of R matches of S row i, t[i] = SUM of matched R payloads
    (int32 wraparound). The building block of the fused probe -> group-by
    pipeline (phase 1 of join_partitioned_results,
    src/join-primitives.cu:1107-1416). The windowed kernel 2 adds into h and
    t in place, round by round.

    Requires real keys >= 0. S pad rows may carry garbage h (pad-vs-pad
    sentinel equality); callers drop them."""
    with profiling.annotate("tpujoin.probe"):
        nsb = s_sv.shape[0] // _BLK
        r_svb = r_sv.view(-1, _BLK)
        r_payb = r_pay.view(-1, _BLK)
        s_svb = s_sv.view(-1, _BLK)
        h = torch.zeros((nsb, _BLK), dtype=torch.int32, device=s_sv.device)
        t = torch.zeros_like(h)
        lo, hi, chunks = _probe_schedule(r_sv, s_sv, window_blocks)
        for r, ids in chunks:
            banded_window_per_s(s_svb, r_svb, r_payb, ids, lo, hi, r,
                                window_blocks, h, t)
        return h.view(-1), t.view(-1)


def banded_match_descriptors(r_sv: torch.Tensor, s_sv: torch.Tensor,
                             window_blocks: int = 1
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-S-row (match count h, first-match sorted-R index fm), int32.

    Because both sides are key-sorted, S row i's matches are exactly the
    sorted-R rows [fm[i], fm[i] + h[i]): the dense-counting phase of
    materialization (phase 1 of join_partitioned_results,
    src/join-primitives.cu:1107-1416). fm = INT32_MAX where h == 0. The
    windowed kernel 3 updates h and fm in place, round by round."""
    with profiling.annotate("tpujoin.probe"):
        nsb = s_sv.shape[0] // _BLK
        r_svb = r_sv.view(-1, _BLK)
        s_svb = s_sv.view(-1, _BLK)
        h = torch.zeros((nsb, _BLK), dtype=torch.int32, device=s_sv.device)
        fm = torch.full_like(h, INT32_MAX)
        lo, hi, chunks = _probe_schedule(r_sv, s_sv, window_blocks)
        for r, ids in chunks:
            banded_window_first(s_svb, r_svb, ids, lo, hi, r, window_blocks,
                                h, fm)
        return h.view(-1), fm.view(-1)


def _blocks_of(x: torch.Tensor, idx: torch.Tensor, width: int) -> torch.Tensor:
    """Rows of the 128-wide blocks of x at idx [Cb, k], as [Cb, width]."""
    return x.view(-1, _BLK)[idx.view(-1)].view(idx.shape[0], width)


def _repeated_blocks(blk: torch.Tensor) -> torch.Tensor:
    """[Cb, k] block indices -> [Cb, k*128] mask of the columns whose block
    repeats the one before it (clamped window tails)."""
    dup = torch.zeros_like(blk, dtype=torch.bool)
    dup[:, 1:] = blk[:, 1:] == blk[:, :-1]
    return dup.repeat_interleave(_BLK, dim=1)


def _extract_blocked(h, fm, off, s_p, r_p, capacity: int, total: int, s_blk,
                     rb0, swb: int, rwb: int):
    """Block-windowed match extraction: slots [b*128, (b+1)*128) resolve
    their owning S row and R position against per-block windows, with block
    gathers and two windowed select kernels (`banded_interval_select` on the
    S side, `banded_compare_per_s` on the R side).

    Caller contract: descriptor arrays are 128-padded, `s_blk[b]` is the
    S block of the owner anchor row of slot b*128, `rb0[b]` the first R
    block of its window (in range), and the caller has verified both window
    span conditions (see banded_materialize); otherwise results are wrong.
    Returns (out_r, out_s), 0 outside live slots. Each slot's result does
    not depend on the others, so the kernels run once over the live slot
    blocks, those below `total` (the TPU path mapped over 512-row chunks of
    every block for VMEM and compile time); the dead ones stay 0."""
    cap_blocks = capacity // _BLK
    cb = min(cap_blocks, -(-total // _BLK))
    s_blk, rb0 = s_blk[:cb], rb0[:cb]
    dev = h.device
    nb_s = h.shape[0] // _BLK
    nb_r = r_p.shape[0] // _BLK
    lane = torch.arange(_BLK, dtype=torch.int32, device=dev)
    pos = (torch.arange(cb, dtype=torch.int32, device=dev)[:, None] * _BLK
           + lane)                                          # [Cb, 128]

    # S side: windows of swb blocks from the anchor; a clamped tail block
    # repeats its predecessor and gets an empty interval
    wblk = torch.clamp(s_blk.long()[:, None] + torch.arange(swb, device=dev),
                       max=nb_s - 1)
    off_w = _blocks_of(off, wblk, swb * _BLK)
    h_w = _blocks_of(h, wblk, swb * _BLK)
    hi_w = torch.where(_repeated_blocks(wblk), off_w, off_w + h_w)
    fmoff_w = _blocks_of(fm, wblk, swb * _BLK) - off_w
    sp_sel, fmoff_sel, valid = banded_interval_select(
        pos, off_w, hi_w, _blocks_of(s_p, wblk, swb * _BLK), fmoff_w,
        torch.ones_like(off_w))
    del off_w, h_w, hi_w, fmoff_w
    r_pos = fmoff_sel + pos                   # garbage where not valid

    # R side: equality select of r_p[r_pos] over rwb blocks from the anchor
    rblk = torch.clamp(rb0.long()[:, None] + torch.arange(rwb, device=dev),
                       max=nb_r - 1)
    ridx_w = (rblk.to(torch.int32)[:, :, None] * _BLK + lane).view(
        cb, rwb * _BLK)
    ridx_w.masked_fill_(_repeated_blocks(rblk), -1)
    _, r_sel = banded_compare_per_s(r_pos, ridx_w,
                                    _blocks_of(r_p, rblk, rwb * _BLK))

    live = (valid > 0) & (pos < total)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    dead = (cap_blocks - cb) * _BLK
    return tuple(torch.nn.functional.pad(torch.where(live, x, zero).view(-1),
                                         (0, dead))
                 for x in (r_sel, sp_sel))


# Fast-path window widths in blocks: S side (owner rows), R side (matches)
_SWB, _RWB = 4, 6


def _fast_path_plan(h, fm, off, s_p, r_p, capacity: int, total: int):
    """The block-windowed fast path's inputs and its span check.

    Returns (ok, args): ok is a 0-d bool tensor, true when every live slot
    block's owners fit the _SWB-block S window and their matches the
    _RWB-block R window; args are _extract_blocked's arguments."""
    dev = h.device
    n_s = h.shape[0]
    c128 = -(-capacity // _BLK) * _BLK
    padd = -n_s % _BLK
    pad = torch.nn.functional.pad
    h_p, fm_p, sp_p = (pad(x, (0, padd)) for x in (h, fm, s_p))
    off_p = pad(off, (0, padd), value=INT32_MAX)
    nb_s = (n_s + padd) // _BLK
    block_starts = torch.arange(c128 // _BLK, dtype=torch.int32,
                                device=dev) * _BLK
    # Owner anchor at S-block granularity: rank the slot-block starts among
    # the 128-coarse match-offset table. The true owner row lies within 127
    # rows after the anchor; the S window and the span checks absorb that.
    # Starts at/after `total`, and the end of the last slot block, are
    # anchored at the last match, so the last live block's span ends at its
    # last owner and not past unmatched S rows at the end (an exchange's
    # received pads, S keys above R's); the JAX engine anchors them at the
    # last S block and takes the slot path there.
    h2d = h_p.view(-1, _BLK)
    hb = h2d.sum(1)
    coarse_off = wrap_i32(torch.cumsum(hb, 0) - hb)
    ends = torch.cat([block_starts, block_starts.new_full((1,), c128)])
    anchors = torch.clamp(
        _ranks_of_sorted_probes(coarse_off, torch.clamp(ends, max=total - 1),
                                a_first_on_ties=True) - 1, 0, nb_s - 1)
    s_blk, s_nxt_blk = anchors[:-1], anchors[1:]
    # slot blocks at/after `total` are dead (all-zero output): their
    # "owners" are trailing h = 0 rows with fm = MAX
    livep = block_starts < total
    ok_s = torch.where(livep, s_nxt_blk - s_blk, 0).amax() < _SWB - 1
    # R window bounds from per-S-block summaries over matched rows only;
    # fm + h is monotone over matched rows, so cummax at s_nxt_blk bounds
    # every owner row the slot block can touch
    fm2d = fm_p.view(-1, _BLK)
    matched = h2d > 0
    blockmin_fm = torch.where(matched, fm2d, INT32_MAX).amin(1)
    blockmax_fmh = torch.where(matched, fm2d + h2d, 0).amax(1)
    rb0 = torch.clamp(blockmin_fm[s_blk] // _BLK, 0, r_p.shape[0] // _BLK - 1)
    rmax_need = torch.cummax(blockmax_fmh, 0).values[s_nxt_blk]
    ok_r = torch.where(livep, rmax_need - rb0 * _BLK, 0).amax() <= _RWB * _BLK
    return ok_s & ok_r, (h_p, fm_p, off_p, sp_p, r_p, c128, total, s_blk, rb0,
                         _SWB, _RWB)


def banded_materialize(r_keys: torch.Tensor, r_pay: torch.Tensor,
                       s_keys: torch.Tensor, s_pay: torch.Tensor,
                       capacity: int, window_blocks: int = 1,
                       wrap: bool = True, debug_force: Optional[str] = None,
                       sort_impl: Optional[str] = None):
    """Materialize matched (Pr, Ps) pairs into `capacity`-sized buffers.

    Returns (out_r, out_s, total): two int32 [capacity] tensors and the
    match count as a 0-d int32 tensor (wraparound, like the reference's
    cursor). When total <= capacity the output multiset equals the oracle's
    (order is engine-defined: S-sorted match order, 0 in unused slots). With
    wrap=True excess matches wrap around the output ring: match m lands in
    slot m mod capacity, later matches overwriting earlier (the FOLD ring of
    join_partitioned_results, src/join-primitives.cu:1371-1373). wrap=False
    truncates instead.

    Extraction on a card: one launch of `extract_pairs`, which maps every
    slot to its match by a load-balanced search over the match offsets.
    On the CPU, and on either device with debug_force, the JAX engine's
    routes: when no ring lap happened and per-block owner spans fit the
    static windows, the block-windowed fast path (_extract_blocked) runs;
    otherwise the exact slot path (`torch_extract_pairs`, the kernel's
    plain version) does. One host read of the span check decides (JAX:
    lax.cond). debug_force "fast" / "slow" takes that path regardless
    (tests, and kernels 4 and 2 held on the card)."""
    if debug_force not in (None, "fast", "slow"):
        raise ValueError(f"unknown debug_force {debug_force!r}")
    r_sv, r_p = sort_by_key(r_keys, r_pay, sort_impl)
    s_sv, s_p = sort_by_key(s_keys, s_pay, sort_impl)
    n_s = s_keys.shape[0]
    h, fm = banded_match_descriptors(r_sv, s_sv, window_blocks)
    with profiling.annotate("tpujoin.extract"):
        # drop S sentinel-padding rows (at the end of the sorted order)
        h, fm, s_p = h[:n_s], fm[:n_s], s_p[:n_s]
        hsum = torch.cumsum(h, 0)
        off = wrap_i32(hsum - h)
        total_t = wrap_i32(hsum[-1] if n_s else hsum.sum())
        with profiling.host_wait():
            total = int(total_t)
        if total <= 0:   # every slot is masked by pos < total on both paths
            zeros = torch.zeros(capacity, dtype=torch.int32, device=h.device)
            return zeros, zeros.clone(), total_t
        if h.is_cuda and debug_force is None:
            out_r, out_s = extract_pairs(off, fm, s_p, r_p, capacity, total,
                                         wrap)
            return out_r, out_s, total_t
        force = debug_force
        if force is None and wrap and total > capacity:
            force = "slow"   # a ring lap: the span check cannot pass
        if force != "slow":
            ok, plan = _fast_path_plan(h, fm, off, s_p, r_p, capacity, total)
            if force is None:
                with profiling.host_wait():
                    force = "fast" if bool(ok) else "slow"
            if force == "fast":
                out_r, out_s = _extract_blocked(*plan)
                return out_r[:capacity], out_s[:capacity], total_t
        out_r, out_s = torch_extract_pairs(off, fm, s_p, r_p, capacity, total,
                                           wrap)
        return out_r, out_s, total_t


def banded_join_aggregate(r_keys: torch.Tensor, r_pay: torch.Tensor,
                          s_keys: torch.Tensor, s_pay: torch.Tensor,
                          window_blocks: int = 1,
                          sort_impl: Optional[str] = None) -> torch.Tensor:
    """Sort both sides, then the banded probe: SUM(Pr*Ps) over key matches,
    int32 wraparound, as a 0-d int32 tensor."""
    r_sv, r_p = sort_by_key(r_keys, r_pay, sort_impl)
    s_sv, s_p = sort_by_key(s_keys, s_pay, sort_impl)
    return banded_probe(r_sv, r_p, s_sv, s_p, window_blocks, "mul")


def banded_join_late_aggregate(r_keys: torch.Tensor, r_colsum: torch.Tensor,
                               s_keys: torch.Tensor, s_colsum: torch.Tensor,
                               window_blocks: int = 1,
                               sort_impl: Optional[str] = None) -> torch.Tensor:
    """Late-materialization aggregate: SUM over matches of (Rcolsum +
    Scolsum), int32 wraparound (join_partitioned_varpayload analog,
    src/join-primitives.cu:1420-1557). Requires keys != -1 (sentinel)."""
    r_sv, r_c = sort_by_key(r_keys, r_colsum, sort_impl)
    s_sv, s_c = sort_by_key(s_keys, s_colsum, sort_impl)
    return banded_probe(r_sv, r_c, s_sv, s_c, window_blocks, "add")


def banded_join_count(r_keys: torch.Tensor, s_keys: torch.Tensor,
                      window_blocks: int = 1,
                      sort_impl: Optional[str] = None) -> torch.Tensor:
    """Match count (int32 wraparound; exact when < 2^31), computed as
    SUM(1*1) so the sentinel pad rows (payload 0) count nothing."""
    return banded_join_aggregate(r_keys, torch.ones_like(r_keys),
                                 s_keys, torch.ones_like(s_keys),
                                 window_blocks, sort_impl)
