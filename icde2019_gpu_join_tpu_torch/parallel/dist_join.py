"""The distributed join over a communicator.

Port of `icde2019_gpu_join_tpu/parallel/dist_join.py`. The reference is
single-GPU; its co-processing pipeline (outOfGPU_Join2) is the template:
host partitions become rank shards and PCIe streams become collectives.

  1. each rank holds an equal shard of R and S;
  2. it partitions its shard by destination rank, the low log2(ranks) bits
     of the radix field: grouped (radix_group) or sort-based;
  3. an all-to-all delivers (key, payload) bucket frames;
  4. each rank joins what it received with the banded engine
     (ops/band_join.py: kernel 1 through `banded_join_aggregate` and
     `banded_probe`, kernels 3, 4 and 2 through `banded_materialize`);
     payload-0 padding rows add nothing;
  5. a sum over the ranks mod 2^32 gives the global aggregate.

Every step from the plan to the sum is one function per rank, written once
against a communicator (`parallel/comm.py`): the `*_local` entry points run
it in one process of a `torch.distributed` world over that rank's shard
(NCCL on the card, gloo on the CPU); the global entry points, with JAX's
names and signatures, cut global tensors over a `Mesh` of virtual ranks
(threads on one device) and run the same function on each. `lax.scan` over
segments is a Python loop; JAX's cached jitted `shard_map` builders have no
counterpart (PyTorch runs eagerly).

Caps: by default (`slack=None`) bucket caps come from an exact histogram
pre-pass (parallel/plan.py), so overflow is impossible and the all-to-all
carries the true max bucket fill. An explicit `slack` skips the pre-pass and
relies on auto-replan: if the padded exchange overflows, the caps are
recomputed exactly and the join reruns, with a warning.

Every branch a rank takes (replan, heavy split, retry) follows from values
that are the same on every rank (sums over ranks or gathered tables), so the
ranks always call the same collectives in the same order.

Each rank's work is marked with `torch.profiler.record_function` spans,
"dist_join.plan" (shard check, heavy-hitter detection, caps),
"dist_join.exchange" (bucketing and the all-to-alls) and "dist_join.probe"
(the sorts and the banded join), which a profiler reads per rank; outside a
profiler a span costs a few microseconds of host time.
"""

from __future__ import annotations

import warnings
from functools import partial
from typing import Optional, Tuple

import torch

from icde2019_gpu_join_tpu_torch.ops.band_join import (
    banded_join_aggregate,
    banded_materialize,
    banded_probe,
    resolve_sort_impl,
    sort_by_key,
)
from icde2019_gpu_join_tpu_torch.ops.bits import partition_ids, rotate_keys
from icde2019_gpu_join_tpu_torch.ops.bits import unrotate_keys, wrap_i32
from icde2019_gpu_join_tpu_torch.ops.radix_pairs import radix_sort_pairs
from icde2019_gpu_join_tpu_torch.parallel import plan as xplan
from icde2019_gpu_join_tpu_torch.parallel.exchange import (
    _SENT,
    _spread_pad_keys,
    all_to_all_exchange,
    all_to_all_meta,
    frame_rows,
    frames_valid_mask,
    partition_to_buckets,
    partition_to_buckets_grouped,
)

_BLK = 128


def _span(name: str):
    return torch.profiler.record_function(f"dist_join.{name}")


def _round128(x: int) -> int:
    return max(_BLK, -(-int(x) // _BLK) * _BLK)


def _bucketize(method: str, chunk: int):
    if method == "group":
        return partial(partition_to_buckets_grouped, chunk=chunk)
    return partition_to_buckets


def _psum2(comm, a: torch.Tensor, b: torch.Tensor):
    """(sum of a, sum of b) over the ranks, mod 2^32, in one collective."""
    s = comm.psum_u32(torch.stack([a.to(torch.int32), b.to(torch.int32)]))
    return s[0], s[1]


def _check_shards(comm, *tensors, segments: int = 1):
    """The contract of the layer: every rank holds shards of one length a
    side, and the probe shard cuts into `segments` equal segments. Checked
    on every rank from gathered lengths, so all ranks raise together."""
    mine = torch.tensor([t.shape[0] for t in tensors], dtype=torch.int64,
                        device=tensors[0].device)
    lens = comm.all_gather(mine[None]).cpu().numpy()
    if (lens != lens[0]).any():
        raise ValueError(f"shard lengths differ between ranks: {lens.tolist()}")
    if lens[0, -1] % segments:
        raise ValueError(f"a probe shard of {lens[0, -1]} rows does not cut "
                         f"into {segments} equal segments")


# ---- the one-shot aggregate -------------------------------------------------

def _local_join_after_exchange(rk, rp, sk, sp, comm, first_bit: int,
                               cap_r: int, cap_s: int, method: str,
                               chunk: int, sort_impl: str):
    nd = comm.size
    part = _bucketize(method, chunk)
    with _span("exchange"):
        fr = part(rk, rp, nd, cap_r, first_bit)
        fs = part(sk, sp, nd, cap_s, first_bit)
        gk_r, gp_r = all_to_all_exchange(fr.keys, fr.pays, comm)
        gk_s, gp_s = all_to_all_exchange(fs.keys, fs.pays, comm)
    with _span("probe"):
        agg = banded_join_aggregate(gk_r.reshape(-1), gp_r.reshape(-1),
                                    gk_s.reshape(-1), gp_s.reshape(-1),
                                    sort_impl=sort_impl)
    return _psum2(comm, agg, fr.overflow + fs.overflow)


def _slack_caps(slack: float, n_r: int, n_s: int, nd: int,
                segments: int = 1) -> Tuple[int, int]:
    """Guessed caps from global lengths n_r, n_s."""
    cap_r = _round128(int(slack * (n_r // nd) / nd) + 1)
    cap_s = _round128(int(slack * (n_s // nd) / (nd * segments)) + 1)
    return cap_r, cap_s


def _exact_caps(rk, sk, comm, first_bit: int, method: str, chunk: int,
                segments: int = 1) -> Tuple[int, int]:
    nd = comm.size
    if method == "group":
        cap_r = xplan.plan_cap_grouped(rk, comm, nd, first_bit, chunk)
    else:
        cap_r = xplan.plan_cap(rk, comm, nd, first_bit)
    if segments > 1:
        cap_s = xplan.plan_cap_segmented(sk, comm, nd, first_bit, segments,
                                         method, chunk)
    elif method == "group":
        cap_s = xplan.plan_cap_grouped(sk, comm, nd, first_bit, chunk)
    else:
        cap_s = xplan.plan_cap(sk, comm, nd, first_bit)
    return cap_r, cap_s


def distributed_join_aggregate_local(
    rk: torch.Tensor, rp: torch.Tensor, sk: torch.Tensor, sp: torch.Tensor,
    comm,
    first_bit: int = 0,
    slack: Optional[float] = None,
    method: str = "group",
    chunk: int = 4096,
    sort_impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank of `distributed_join_aggregate`: this rank's shards and its
    communicator; returns the global (aggregate, overflow) on every rank."""
    impl = resolve_sort_impl(sort_impl)
    run = partial(_local_join_after_exchange, rk, rp, sk, sp, comm, first_bit,
                  method=method, chunk=chunk, sort_impl=impl)
    nd = comm.size
    with _span("plan"):
        _check_shards(comm, rk, sk)
        if slack is None:
            caps = _exact_caps(rk, sk, comm, first_bit, method, chunk)
        else:
            caps = _slack_caps(slack, nd * rk.shape[0], nd * sk.shape[0], nd)
    agg, ov = run(*caps)
    if slack is not None and int(ov) > 0:
        warnings.warn(
            f"exchange overflow ({int(ov)} rows) with slack={slack}; "
            "replanning with exact histogram caps and rerunning")
        with _span("plan"):
            caps = _exact_caps(rk, sk, comm, first_bit, method, chunk)
        agg, ov = run(*caps)
    return agg, ov


def distributed_join_aggregate(
    r_keys, r_pay, s_keys, s_pay,
    mesh,
    axis: str = "x",
    first_bit: int = 0,
    slack: Optional[float] = None,
    method: str = "group",
    chunk: int = 4096,
    sort_impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global SUM(Pr*Ps) over a 1-D mesh. Inputs are global tensors whose
    lengths divide the mesh size. Returns (aggregate int32, overflow rows:
    0 for an exact result, by construction when slack is None, after an
    auto-replan otherwise)."""
    return mesh.run(
        lambda c, *sh: distributed_join_aggregate_local(
            *sh, c[axis], first_bit, slack, method, chunk, sort_impl),
        r_keys, r_pay, s_keys, s_pay)[0]


# ---- the segmented pipeline (the default) ------------------------------------

def _local_segmented(rk, rp, sk, sp, comm, first_bit: int, cap_r: int,
                     cap_s: int, num_segments: int, method: str, chunk: int,
                     sort_impl: str):
    """The build side exchanged and sorted once (resident); the probe side
    flows in segments through bucket -> all-to-all -> sort -> banded probe
    (the analog of the reference's 3-stream double-buffered pipeline,
    src/hash_join_clustered_probe.cu:1400-1622). Returns (aggregate,
    overflow, probe rows this rank received)."""
    nd = comm.size
    part = _bucketize(method, chunk)
    with _span("exchange"):
        fr = part(rk, rp, nd, cap_r, first_bit)
        gk_r, gp_r = all_to_all_exchange(fr.keys, fr.pays, comm)
    with _span("probe"):
        r_sv, r_p = sort_by_key(gk_r.reshape(-1), gp_r.reshape(-1), sort_impl)
    acc = torch.zeros((), dtype=torch.int64, device=rk.device)
    ov = torch.zeros((), dtype=torch.int32, device=rk.device)
    recv = torch.zeros((), dtype=torch.int64, device=rk.device)
    for k, p in zip(sk.view(num_segments, -1), sp.view(num_segments, -1)):
        with _span("exchange"):
            fs = part(k, p, nd, cap_s, first_bit)
            gk, gp = all_to_all_exchange(fs.keys, fs.pays, comm)
            # executed balance: the real probe rows this rank received
            _, ct = all_to_all_meta(fs.start, fs.count, comm)
        with _span("probe"):
            s_sv, s_p = sort_by_key(gk.reshape(-1), gp.reshape(-1), sort_impl)
            acc += banded_probe(r_sv, r_p, s_sv, s_p, 2, "mul")
        ov += fs.overflow
        recv += ct.sum()
    agg, overflow = _psum2(comm, wrap_i32(acc), fr.overflow + ov)
    return agg, overflow, recv


def _is_heavy_mask(keys: torch.Tensor, fbits: int, first_bit: int,
                   heavy_ids) -> torch.Tensor:
    """Bool mask: rows whose fine radix bucket is in the heavy set."""
    fid = partition_ids(keys, fbits, first_bit)
    ids = torch.tensor(heavy_ids, dtype=fid.dtype, device=fid.device)
    return torch.isin(fid, ids)


def _pack_heavy(keys, pays, mask, cap: int, first_bit: int,
                pad_key: Optional[int] = None):
    """Compact the masked rows into a [cap] frame (sort to the front); pad
    slots get payload 0 and spread keys (aggregate paths) or the constant
    `pad_key` (materialize paths, where a spread pad equal to a real key
    would emit a phantom pair). Returns (keys, pays, overflow)."""
    sv = torch.where(mask, rotate_keys(keys, 0, first_bit), _SENT)
    pz = torch.where(mask, pays, 0)
    n = sv.shape[0]
    if n < cap:
        sv = torch.cat([sv, sv.new_full((cap - n,), _SENT)])
        pz = torch.cat([pz, pz.new_zeros(cap - n)])
    sv_s, p_s = radix_sort_pairs(sv, pz)
    sv_s, p_s = sv_s[:cap], p_s[:cap]
    cnt = mask.sum().to(torch.int32)
    idx = torch.arange(cap, dtype=torch.int32, device=keys.device)
    live = idx < cnt
    pads = (_spread_pad_keys(idx) if pad_key is None
            else torch.full((cap,), pad_key, dtype=torch.int32,
                            device=keys.device))
    out_k = torch.where(live, unrotate_keys(sv_s, 0, first_bit), pads)
    out_p = torch.where(live, p_s, 0)
    return out_k, out_p, torch.clamp(cnt - cap, min=0)


def _local_heavy_segmented(rk, rp, sk, sp, comm, first_bit: int, fbits: int,
                           heavy_ids, cap_r: int, cap_s: int, cap_rh: int,
                           num_segments: int, sort_impl: str):
    """PRPD heavy-split segmented join (reference analog: decompose_chains,
    src/join-primitives.cu:843-874, and the knapsack batcher,
    src/partition-primitives.cu:307-469):

      * build side: normal rows ride the all-to-all; rows in heavy fine
        buckets are packed into a [cap_rh] frame and all-gathered to every
        rank (a hot key's R side is small: one row for PK-FK);
      * probe side: normal rows ride the all-to-all; heavy rows join where
        they already live, spread over the ranks by input placement.

    Exactly once: heavy rows are masked out of the normal exchange, so a
    match pair is counted by the key's owner (normal x normal) or by the S
    row's home rank (heavy x replicated heavy R); the key sets are
    disjoint."""
    nd = comm.size
    with _span("exchange"):
        hm_r = _is_heavy_mask(rk, fbits, first_bit, heavy_ids)
        fr = partition_to_buckets(rk, rp, nd, cap_r, first_bit, valid=~hm_r)
        gk_r, gp_r = all_to_all_exchange(fr.keys, fr.pays, comm)
        hk, hp, ov_h = _pack_heavy(rk, rp, hm_r, cap_rh, first_bit)
        ghk, ghp = comm.all_gather(hk), comm.all_gather(hp)
    with _span("probe"):
        r_sv, r_p = sort_by_key(torch.cat([gk_r.reshape(-1), ghk]),
                                torch.cat([gp_r.reshape(-1), ghp]), sort_impl)
    seg_idx = torch.arange(sk.shape[0] // num_segments, dtype=torch.int32,
                           device=sk.device)
    acc = torch.zeros((), dtype=torch.int64, device=rk.device)
    ov = torch.zeros((), dtype=torch.int32, device=rk.device)
    recv = torch.zeros((), dtype=torch.int64, device=rk.device)
    for k, p in zip(sk.view(num_segments, -1), sp.view(num_segments, -1)):
        with _span("exchange"):
            hm = _is_heavy_mask(k, fbits, first_bit, heavy_ids)
            fs = partition_to_buckets(k, p, nd, cap_s, first_bit, valid=~hm)
            gk, gp = all_to_all_exchange(fs.keys, fs.pays, comm)
            # executed balance: received normal rows + local heavy rows
            _, ct = all_to_all_meta(fs.start, fs.count, comm)
        with _span("probe"):
            # heavy S rows stay; the other slots become payload-0 pads with
            # spread keys (a run of one pad key would blow up the band
            # window)
            lk = torch.where(hm, k, _spread_pad_keys(seg_idx))
            lp = torch.where(hm, p, 0)
            s_sv, s_p = sort_by_key(torch.cat([gk.reshape(-1), lk]),
                                    torch.cat([gp.reshape(-1), lp]), sort_impl)
            acc += banded_probe(r_sv, r_p, s_sv, s_p, 2, "mul")
        ov += fs.overflow
        recv += ct.sum() + hm.sum()
    agg, overflow = _psum2(comm, wrap_i32(acc), fr.overflow + ov_h + ov)
    return agg, overflow, recv


def _heavy_plan(rk, sk, comm, first_bit: int, split_heavy, allowed: bool,
                segments: int = 1):
    """The heavy-split plan when the split is to run, else None. split_heavy
    None (auto) first asks a coarse [ranks, ranks] histogram of S whether some
    destination would get over 2x its fair share; True plans the fine split
    at once; False never splits. The grouped exact caps count laid-out
    blocks, not rows per destination, so they cannot answer that question."""
    nd = comm.size
    if split_heavy is False or not allowed or nd == 1:
        return None
    if split_heavy is None:
        coarse = xplan.destination_histograms(sk, comm, nd, first_bit)
        if coarse.sum(axis=0).max() <= 2.0 * sk.shape[0]:
            return None
    hplan = xplan.plan_heavy_split(rk, sk, comm, nd, first_bit,
                                   segments=segments)
    return hplan if hplan.split else None


def distributed_join_segmented_local(
    rk: torch.Tensor, rp: torch.Tensor, sk: torch.Tensor, sp: torch.Tensor,
    comm,
    num_segments: int = 4,
    first_bit: int = 0,
    slack: Optional[float] = None,
    method: str = "group",
    chunk: int = 4096,
    split_heavy: Optional[bool] = None,
    sort_impl: Optional[str] = None,
    return_loads: bool = False,
):
    """One rank of `distributed_join_segmented`: this rank's shards and its
    communicator. Returns (aggregate, overflow), the same on every rank,
    and with return_loads every rank's executed probe load, [ranks] numpy."""
    nd = comm.size
    impl = resolve_sort_impl(sort_impl)

    def ret(agg, ov, recv):
        if return_loads:
            loads = comm.all_gather(recv.reshape(1)).cpu().numpy()
            return agg, ov, loads
        return agg, ov

    def run(cap_r, cap_s):
        return _local_segmented(rk, rp, sk, sp, comm, first_bit, cap_r, cap_s,
                                num_segments, method, chunk, impl)

    with _span("plan"):
        _check_shards(comm, rk, sk, segments=num_segments)
        hplan = _heavy_plan(rk, sk, comm, first_bit, split_heavy,
                            slack is None, num_segments)
        if hplan is None:
            if slack is None:
                caps = _exact_caps(rk, sk, comm, first_bit, method, chunk,
                                   segments=num_segments)
            else:
                caps = _slack_caps(slack, nd * rk.shape[0], nd * sk.shape[0],
                                   nd, num_segments)
    if hplan is not None:
        return ret(*_local_heavy_segmented(
            rk, rp, sk, sp, comm, first_bit, hplan.fbits, hplan.heavy_ids,
            hplan.cap_r, hplan.cap_s, hplan.cap_rh, num_segments, impl))
    out = run(*caps)
    if int(out[1]) > 0 and slack is not None:
        warnings.warn(f"segmented exchange overflow ({int(out[1])} rows); "
                      "replanning")
        with _span("plan"):
            caps = _exact_caps(rk, sk, comm, first_bit, method, chunk,
                               segments=num_segments)
        out = run(*caps)
    if int(out[1]) > 0:
        # the per-segment cap underestimates (skewed segments): retry with
        # the whole shard's worth
        out = run(caps[0], _round128(caps[1] * num_segments))
    return ret(*out)


def distributed_join_segmented(
    r_keys, r_pay, s_keys, s_pay,
    mesh,
    axis: str = "x",
    num_segments: int = 4,
    first_bit: int = 0,
    slack: Optional[float] = None,
    method: str = "group",
    chunk: int = 4096,
    split_heavy: Optional[bool] = None,
    sort_impl: Optional[str] = None,
    return_loads: bool = False,
):
    """Distributed join with the probe side streamed in segments, so one
    segment's all-to-all can overlap the previous one's banded probe
    (S_segment_size analog: min(CHUNK_SIZE, n/4),
    src/hash_join_clustered_probe.cu:1017). Returns (aggregate, overflow).
    The default distributed pipeline (config 5, the dry run).

    split_heavy: None (auto) runs a coarse destination histogram; when some
    destination would receive over 2x its fair share, the fine PRPD heavy
    split plan runs (heavy R broadcast + local heavy S,
    `_local_heavy_segmented`). True forces the fine plan; False disables
    the split.

    return_loads=True appends the executed per-rank probe load (real S rows
    each rank received through the exchange + heavy rows it kept, from the
    exchanged frame metadata) as a host numpy [ranks] array."""
    return mesh.run(
        lambda c, *sh: distributed_join_segmented_local(
            *sh, c[axis], num_segments, first_bit, slack, method, chunk,
            split_heavy, sort_impl, return_loads),
        r_keys, r_pay, s_keys, s_pay)[0]


# ---- materialization ---------------------------------------------------------

def _received(f, comm, cap: int, pad: int):
    """Exchange sort-based frames with their (start, count) and mask the
    received pad rows to the non-matching key `pad`, payload 0."""
    gk, gp = all_to_all_exchange(f.keys, f.pays, comm)
    st, ct = all_to_all_meta(f.start, f.count, comm)
    valid = frames_valid_mask(st, ct, frame_rows(cap)).reshape(-1)
    return (torch.where(valid, gk.reshape(-1), pad),
            torch.where(valid, gp.reshape(-1), 0))


def _local_materialize(rk, rp, sk, sp, comm, first_bit: int, cap_r: int,
                       cap_s: int, capacity: int, wrap: bool, sort_impl: str):
    """Exchange both sides with sort-based frames + (start, count), mask the
    received pad rows to non-matching keys, then run the banded
    materializer on the rank's key range.

    Pad masking makes materialization exact: aggregates only need pads to
    carry payload 0, but a materialized (Pr, 0) row would be a spurious
    output. R pads become key -1 (sortval 0x7FFFFFFF, the engine's R-side
    pad) and S pads key -2 (sortval 0x7FFFFFFE): both sort after every real
    key (>= 0) and never equal each other. The compare kernels mask invalid
    R window slots to sortval 0x7FFFFFFF, so an S row with that sortval
    would match every masked slot; S pads sit one below. Reference analog:
    the materializing probe of join_partitioned_results
    (src/hash_join_clustered_probe.cu:1947-1961), whose output order is
    nondeterministic: parity is on the (Pr, Ps) multiset. Returns
    (out_r [capacity], out_s, this rank's match total, overflow)."""
    nd = comm.size
    with _span("exchange"):
        fr = partition_to_buckets(rk, rp, nd, cap_r, first_bit)
        fs = partition_to_buckets(sk, sp, nd, cap_s, first_bit)
        rk2, rp2 = _received(fr, comm, cap_r, -1)
        sk2, sp2 = _received(fs, comm, cap_s, -2)
    with _span("probe"):
        out_r, out_s, total = banded_materialize(
            rk2, rp2, sk2, sp2, capacity=capacity, wrap=wrap,
            sort_impl=sort_impl)
    overflow = comm.psum_u32(fr.overflow + fs.overflow)
    return out_r, out_s, total, overflow


def _local_materialize_heavy(rk, rp, sk, sp, comm, first_bit: int,
                             fbits: int, heavy_ids, cap_r: int, cap_s: int,
                             cap_rh: int, capacity: int, wrap: bool,
                             sort_impl: str):
    """PRPD heavy-split materialization (the split argument of
    _local_heavy_segmented: each pair comes out once): normal rows ride the
    valid-masked exchange with received pads masked to -1 / -2; heavy R
    rows are packed with constant -1 pads (a spread pad could equal a real S
    key and emit a phantom pair) and replicated; heavy S rows materialize
    on their home rank."""
    nd = comm.size
    with _span("exchange"):
        hm_r = _is_heavy_mask(rk, fbits, first_bit, heavy_ids)
        hm_s = _is_heavy_mask(sk, fbits, first_bit, heavy_ids)
        fr = partition_to_buckets(rk, rp, nd, cap_r, first_bit, valid=~hm_r)
        fs = partition_to_buckets(sk, sp, nd, cap_s, first_bit, valid=~hm_s)
        rk2, rp2 = _received(fr, comm, cap_r, -1)
        sk2, sp2 = _received(fs, comm, cap_s, -2)
        hk, hp, ov_h = _pack_heavy(rk, rp, hm_r, cap_rh, first_bit,
                                   pad_key=-1)
        ghk, ghp = comm.all_gather(hk), comm.all_gather(hp)
    with _span("probe"):
        lk = torch.where(hm_s, sk, -2)
        lp = torch.where(hm_s, sp, 0)
        out_r, out_s, total = banded_materialize(
            torch.cat([rk2, ghk]), torch.cat([rp2, ghp]),
            torch.cat([sk2, lk]), torch.cat([sp2, lp]),
            capacity=capacity, wrap=wrap, sort_impl=sort_impl)
    overflow = comm.psum_u32(fr.overflow + fs.overflow + ov_h)
    return out_r, out_s, total, overflow


def distributed_join_materialize_local(
    rk: torch.Tensor, rp: torch.Tensor, sk: torch.Tensor, sp: torch.Tensor,
    comm,
    capacity_per_chip: int,
    first_bit: int = 0,
    wrap: bool = True,
    sort_impl: Optional[str] = None,
    split_heavy: Optional[bool] = None,
):
    """One rank of `distributed_join_materialize`: returns this rank's
    (out_r [capacity], out_s [capacity], match total) and the global
    overflow."""
    impl = resolve_sort_impl(sort_impl)
    with _span("plan"):
        _check_shards(comm, rk, sk)
        # the key-domain contract (keys >= 0), decided on every rank from a
        # sum over the ranks: pads are keys -1 / -2, so a negative real key
        # would emit phantom pairs
        negative = torch.stack([(rk < 0).any(), (sk < 0).any()]).to(torch.int32)
        if int(comm.psum_u32(negative).sum()) > 0:
            raise ValueError(
                "distributed_join_materialize: negative keys violate the "
                "engine key-domain contract (keys >= 0; -1/-2 are reserved "
                "pad sentinels) — see PARITY.md deviations")
        hplan = _heavy_plan(rk, sk, comm, first_bit, split_heavy, True)
        if hplan is None:
            cap_r, cap_s = _exact_caps(rk, sk, comm, first_bit, "sort", 0)
    if hplan is not None:
        return _local_materialize_heavy(
            rk, rp, sk, sp, comm, first_bit, hplan.fbits, hplan.heavy_ids,
            hplan.cap_r, hplan.cap_s, hplan.cap_rh, int(capacity_per_chip),
            bool(wrap), impl)
    return _local_materialize(rk, rp, sk, sp, comm, first_bit, cap_r, cap_s,
                              int(capacity_per_chip), bool(wrap), impl)


def distributed_join_materialize(
    r_keys, r_pay, s_keys, s_pay,
    mesh,
    capacity_per_chip: int,
    axis: str = "x",
    first_bit: int = 0,
    wrap: bool = True,
    sort_impl: Optional[str] = None,
    split_heavy: Optional[bool] = None,
):
    """Distributed materializing join over a 1-D mesh: every matched
    (Pr, Ps) pair lands in the output buffer of the rank owning its key's
    radix range. Returns (out_r [ranks*cap], out_s [ranks*cap], totals
    [ranks], overflow): rank d's rows live in out_*[d*cap:(d+1)*cap], its
    true match count in totals[d] (slots >= total are 0; with wrap=True
    excess matches wrap the rank's ring, the FOLD semantics of
    src/join-primitives.cu:1371-1373; wrap=False truncates). Caps come from
    the exact histogram pre-pass, so exchange overflow is 0.

    split_heavy (None = auto, as in distributed_join_segmented): when some
    destination would receive over 2x its fair share of S, heavy-bucket S
    rows materialize where they live against the all-gathered heavy R rows.
    The output multiset over the ranks is unchanged; only the placement of
    heavy keys' pairs differs, so no rank's ring absorbs a whole hot key.

    Enforces the key-domain contract (keys >= 0) loudly: the received
    frames are padded with keys -1 / -2."""
    outs = mesh.run(
        lambda c, *sh: distributed_join_materialize_local(
            *sh, c[axis], capacity_per_chip, first_bit, wrap, sort_impl,
            split_heavy),
        r_keys, r_pay, s_keys, s_pay)
    out_r, out_s, totals, overflow = zip(*outs)
    return (torch.cat(out_r), torch.cat(out_s),
            torch.stack([t.reshape(()) for t in totals]), overflow[0])


# ---- the two-level exchange ----------------------------------------------------

def _two_level_side(keys, pays, host_comm, chip_comm, first_bit: int,
                    cap_h: int, cap_c: int, valid=None):
    """Both exchange levels of one side: across hosts on bits [first_bit,
    +hbits), then across the chips of the host on the next bits, with the
    level-1 pad rows masked out of every level-2 bucket. Returns (keys,
    pays, overflow, real rows received)."""
    nh, nc = host_comm.size, chip_comm.size
    hbits = (nh - 1).bit_length()   # 0 when nh == 1 (a single-bucket level)
    with _span("exchange"):
        f1 = partition_to_buckets(keys, pays, nh, cap_h, first_bit,
                                  valid=valid)
        gk, gp = all_to_all_exchange(f1.keys, f1.pays, host_comm)
        st, ct = all_to_all_meta(f1.start, f1.count, host_comm)
        valid1 = frames_valid_mask(st, ct, frame_rows(cap_h)).reshape(-1)
        f2 = partition_to_buckets(gk.reshape(-1), gp.reshape(-1), nc, cap_c,
                                  first_bit + hbits, valid=valid1)
        gk2, gp2 = all_to_all_exchange(f2.keys, f2.pays, chip_comm)
        # executed balance: the real rows this rank received
        _, ct2 = all_to_all_meta(f2.start, f2.count, chip_comm)
    return (gk2.reshape(-1), gp2.reshape(-1), f1.overflow + f2.overflow,
            ct2.sum())


def _psum2_2d(host_comm, chip_comm, a, b):
    return _psum2(host_comm, *_psum2(chip_comm, a, b))


def _two_level_local(rk, rp, sk, sp, host_comm, chip_comm, first_bit: int,
                     caps, sort_impl: str):
    """Two-level exchange: hosts exchange first (outer radix bits), then the
    chips of a host (next bits), which keeps the all-to-all fan-in
    hierarchical, as a slice's links are. Level 1 is sort-based and ships
    (start, count); level 2 masks the received pads out before
    re-bucketing, so level-2 caps cover real rows only."""
    cap_r_h, cap_s_h, cap_r_c, cap_s_c = caps
    rk2, rp2, ov_r, _ = _two_level_side(rk, rp, host_comm, chip_comm,
                                        first_bit, cap_r_h, cap_r_c)
    sk2, sp2, ov_s, recv_s = _two_level_side(sk, sp, host_comm, chip_comm,
                                             first_bit, cap_s_h, cap_s_c)
    with _span("probe"):
        agg = banded_join_aggregate(rk2, rp2, sk2, sp2, sort_impl=sort_impl)
    agg, overflow = _psum2_2d(host_comm, chip_comm, agg, ov_r + ov_s)
    return agg, overflow, recv_s


def _two_level_heavy_local(rk, rp, sk, sp, host_comm, chip_comm,
                           first_bit: int, fbits: int, heavy_ids, caps,
                           cap_rh: int, sort_impl: str):
    """PRPD heavy split composed with the two-level exchange: heavy-bucket
    rows skip both levels (heavy R is all-gathered over the chips, then the
    hosts: every rank of the mesh; heavy S joins where it lives); normal
    rows ride the valid-masked two levels. Exactly once as in
    _local_heavy_segmented."""
    cap_r_h, cap_s_h, cap_r_c, cap_s_c = caps
    hm_r = _is_heavy_mask(rk, fbits, first_bit, heavy_ids)
    hm_s = _is_heavy_mask(sk, fbits, first_bit, heavy_ids)
    rk2, rp2, ov_r, _ = _two_level_side(rk, rp, host_comm, chip_comm,
                                        first_bit, cap_r_h, cap_r_c, ~hm_r)
    sk2, sp2, ov_s, recv_s = _two_level_side(sk, sp, host_comm, chip_comm,
                                             first_bit, cap_s_h, cap_s_c,
                                             ~hm_s)
    with _span("exchange"):
        hk, hp, ov_h = _pack_heavy(rk, rp, hm_r, cap_rh, first_bit)
        ghk = host_comm.all_gather(chip_comm.all_gather(hk))
        ghp = host_comm.all_gather(chip_comm.all_gather(hp))
    with _span("probe"):
        idx = torch.arange(sk.shape[0], dtype=torch.int32, device=sk.device)
        lk = torch.where(hm_s, sk, _spread_pad_keys(idx))
        lp = torch.where(hm_s, sp, 0)
        agg = banded_join_aggregate(
            torch.cat([rk2, ghk]), torch.cat([rp2, ghp]),
            torch.cat([sk2, lk]), torch.cat([sp2, lp]), sort_impl=sort_impl)
    agg, overflow = _psum2_2d(host_comm, chip_comm, agg, ov_r + ov_s + ov_h)
    return agg, overflow, recv_s + hm_s.sum()


def distributed_join_aggregate_2level_local(
    rk: torch.Tensor, rp: torch.Tensor, sk: torch.Tensor, sp: torch.Tensor,
    host_comm, chip_comm,
    first_bit: int = 0,
    slack: Optional[float] = None,
    sort_impl: Optional[str] = None,
    split_heavy: Optional[bool] = None,
    return_loads: bool = False,
):
    """One rank of `distributed_join_aggregate_2level`: this rank's shards
    and its host-axis and chip-axis communicators. Returns (aggregate,
    overflow) and with return_loads every rank's executed probe load,
    [nh*nc] host-major numpy."""
    nh, nc = host_comm.size, chip_comm.size
    nd = nh * nc
    impl = resolve_sort_impl(sort_impl)

    def ret(agg, ov, recv):
        if return_loads:
            row = chip_comm.all_gather(recv.reshape(1))
            return agg, ov, host_comm.all_gather(row).cpu().numpy()
        return agg, ov

    def run(caps):
        return _two_level_local(rk, rp, sk, sp, host_comm, chip_comm,
                                first_bit, caps, impl)

    def exact():
        cr_h, cr_c = xplan.plan_caps_2level(rk, host_comm, chip_comm,
                                            first_bit)
        cs_h, cs_c = xplan.plan_caps_2level(sk, host_comm, chip_comm,
                                            first_bit)
        return (cr_h, cs_h, cr_c, cs_c)

    with _span("plan"):
        for comm in (chip_comm, host_comm):
            _check_shards(comm, rk, sk)
        hplan = None
        if split_heavy is not False and slack is None and nd > 1:
            probe_fine = split_heavy is True
            if not probe_fine:
                coarse = xplan.fine_histograms_2d(
                    sk, host_comm, chip_comm,
                    (nh - 1).bit_length() + (nc - 1).bit_length(), first_bit)
                probe_fine = coarse.sum(axis=0).max() > 2.0 * sk.shape[0]
            if probe_fine:
                hplan = xplan.plan_heavy_split_2level(rk, sk, host_comm,
                                                      chip_comm, first_bit)
        if hplan is None or not hplan.split:
            hplan = None
            if slack is None:
                caps = exact()
            else:
                shard_r, shard_s = rk.shape[0], sk.shape[0]
                caps = (_round128(int(slack * shard_r / nh) + 1),
                        _round128(int(slack * shard_s / nh) + 1),
                        # level 2 sees about a shard of real rows per chip
                        # (pads are masked): no slack^2 compounding
                        _round128(int(slack * shard_r / nc) + 1),
                        _round128(int(slack * shard_s / nc) + 1))
    if hplan is not None:
        return ret(*_two_level_heavy_local(
            rk, rp, sk, sp, host_comm, chip_comm, first_bit, hplan.fbits,
            hplan.heavy_ids, (hplan.cap_r_h, hplan.cap_s_h, hplan.cap_r_c,
                              hplan.cap_s_c), hplan.cap_rh, impl))
    out = run(caps)
    if slack is not None and int(out[1]) > 0:
        warnings.warn(f"2-level exchange overflow ({int(out[1])} rows); "
                      "replanning")
        with _span("plan"):
            caps = exact()
        out = run(caps)
    return ret(*out)


def distributed_join_aggregate_2level(
    r_keys, r_pay, s_keys, s_pay,
    mesh,
    host_axis: str = "host",
    chip_axis: str = "chip",
    first_bit: int = 0,
    slack: Optional[float] = None,
    sort_impl: Optional[str] = None,
    split_heavy: Optional[bool] = None,
    return_loads: bool = False,
):
    """Two-level (hosts, then the chips of a host) distributed join over a
    2-D mesh. slack=None derives exact per-level caps from one
    joint-histogram pre-pass; an explicit slack skips it, with auto-replan.

    split_heavy (None = auto): when some destination of the nh*nc mesh
    would receive over 2x its fair share of S, the PRPD heavy split composes
    with both levels (_two_level_heavy_local). return_loads=True appends
    the executed per-rank probe load [nh*nc] (host-major)."""
    return mesh.run(
        lambda c, *sh: distributed_join_aggregate_2level_local(
            *sh, c[host_axis], c[chip_axis], first_bit, slack, sort_impl,
            split_heavy, return_loads),
        r_keys, r_pay, s_keys, s_pay)[0]
