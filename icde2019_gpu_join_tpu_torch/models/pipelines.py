"""Fused relational pipelines.

Port of `icde2019_gpu_join_tpu/models/pipelines.py`. BASELINE.json config 3:
filter -> hash join probe -> group-by aggregate (count/sum), fused. The
reference's analog is the late-materialization probe summing extra columns
inside the probe kernel (join_partitioned_varpayload,
src/join-primitives.cu:1420-1557).

Semantics of `filter_probe_groupby`:
    SELECT s.group_id, COUNT(*), SUM(r.payload)
    FROM S JOIN R ON S.key = R.key
    WHERE lo <= S.filter_col < hi
    GROUP BY s.group_id
with group ids in [0, num_groups) (rows with other ids count nowhere). R may
hold duplicate keys (COUNT and SUM run over all matching pairs). Keys must
be >= 0 (engine sentinel contract).

Filtered-out S rows are masked to a never-matching sentinel key (-2) before
the sort, the group id rides as the sort payload, the per-S banded probe
(`banded_probe_per_s`) gives (match count h, matched-R-payload sum t), and
the group-by sums (h, t) per group exactly mod 2^32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from icde2019_gpu_join_tpu_torch.models.joins import ClusteredJoin
from icde2019_gpu_join_tpu_torch.ops.band_join import banded_probe_per_s, sort_by_key
from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32
from icde2019_gpu_join_tpu_torch.ops.filter import filter_by_mask
from icde2019_gpu_join_tpu_torch.relation import Relation

_FILTERED_KEY = -2  # sv 0x7FFFFFFE: sorts to the end, matches nothing


def _groupby_sums2_exact(gids: torch.Tensor, vals1: torch.Tensor,
                         vals2: torch.Tensor, num_groups: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(SUM(vals1), SUM(vals2)) per group, int32 wraparound.

    int64 scatter-add into num_groups + 1 bins, where the last bin takes the
    rows whose id lies outside [0, num_groups) and is dropped. Row i adds
    into copy i mod `copies` of the bins, so that neighbouring rows, which
    the card adds at the same time, rarely hit one address: with a single
    copy the atomic adds of 2^29 rows queue on 65 addresses (246 ms on an
    H100, PERF.md). Integer sums are exact (|sum| < 2^63 for fewer than
    2^32 int32 rows) and do not depend on the order the adds land in."""
    n = gids.shape[0]
    copies = min(1024, n & -n) if n else 1  # a power of two dividing n
    g = torch.where((gids >= 0) & (gids < num_groups), gids,
                    num_groups).long().view(-1, copies)
    out = []
    for vals in (vals1, vals2):
        sums = torch.zeros((num_groups + 1, copies), dtype=torch.int64,
                           device=gids.device)
        sums.scatter_add_(0, g, vals.long().view(-1, copies))
        out.append(wrap_i32(sums[:num_groups].sum(1)))
    return out[0], out[1]


def _fpg_segment(r_sv, r_p, s_keys, s_filter_col, s_group_id, lo, hi,
                 num_groups: int, window_blocks: int, sort_impl: str):
    """Filter -> probe -> group-by of one probe-side segment against sorted
    R: the segment's per-group (COUNT, SUM) partials."""
    keep = (s_filter_col >= lo) & (s_filter_col < hi)
    s_sv, s_gid = sort_by_key(torch.where(keep, s_keys, _FILTERED_KEY),
                              s_group_id, sort_impl)
    del keep
    h, t = banded_probe_per_s(r_sv, r_p, s_sv, window_blocks)
    # S sentinel padding rows sit at the end of the sorted order and may
    # carry garbage h (pad-vs-pad key equality): drop them
    n = s_keys.shape[0]
    return _groupby_sums2_exact(s_gid[:n], h[:n], t[:n], num_groups)


def filter_probe_groupby(r_keys, r_pay, s_keys, s_filter_col, s_group_id,
                         lo, hi, num_groups: int, window_blocks: int = 1,
                         sort_impl: str = "lax"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (per-group match COUNT, per-group SUM(r_pay)), int32 [G]
    tensors with wraparound. Non-matching / filtered-out rows contribute
    nothing. Both sorts run under `sort_impl`."""
    r_sv, r_p = sort_by_key(r_keys, r_pay, sort_impl)
    return _fpg_segment(r_sv, r_p, s_keys, s_filter_col, s_group_id, lo, hi,
                        num_groups, window_blocks, sort_impl)


def filter_probe_groupby_streamed(r_keys, r_pay, s_keys, s_filter_col,
                                  s_group_id, lo, hi, num_groups: int,
                                  segments: int, window_blocks: int = 1,
                                  sort_impl: str = "lax"
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """filter_probe_groupby with the probe side in `segments` equal slices,
    R sorted once: each segment's temporaries are 1/segments of the fused
    pipeline's. The same COUNT/SUM mod 2^32, as int32 tensors on the inputs'
    device."""
    n = s_keys.shape[0]
    if n % segments:
        raise ValueError(f"segments={segments} must divide n_s={n}")
    r_sv, r_p = sort_by_key(r_keys, r_pay, sort_impl)
    seg = n // segments
    acc = torch.zeros((2, num_groups), dtype=torch.int64, device=s_keys.device)
    for i in range(segments):
        sl = slice(i * seg, (i + 1) * seg)
        cnt, sums = _fpg_segment(r_sv, r_p, s_keys[sl], s_filter_col[sl],
                                 s_group_id[sl], lo, hi, num_groups,
                                 window_blocks, sort_impl)
        acc[0] += cnt
        acc[1] += sums
    out = wrap_i32(acc)
    return out[0], out[1]


def filter_groupby(keys, vals, group_id, lo, hi, num_groups: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filter on key range then group-by count/sum (no join)."""
    keep = (keys >= lo) & (keys < hi)
    gids = torch.where(keep, group_id, num_groups)
    return _groupby_sums2_exact(gids, keep.to(torch.int32),
                                torch.where(keep, vals, 0), num_groups)


def filter_then_join_aggregate(r, s, s_filter_col, lo, hi, config=None):
    """Filter S, then the full clustered join aggregate on the relations'
    device: the composed (non-fused) strategy, for comparison with the fused
    path. Returns the engine's JoinResult."""
    keep = (s_filter_col >= lo) & (s_filter_col < hi)
    keys_c, pays_c, count = filter_by_mask(s.keys, s.payload, keep)
    # keep the full length; rows past the count carry payload 0
    pays_c = torch.where(
        torch.arange(keys_c.shape[0], device=keys_c.device) < count, pays_c, 0)
    engine = ClusteredJoin(config, device=s.device)
    return engine.aggregate(r, Relation(keys_c, pays_c))
