"""Join execution strategies on one device and the size-based dispatcher.

Port of `icde2019_gpu_join_tpu/models/joins.py`, the analog of the
reference's orchestrator layer (src/hash_join_clustered_probe.cu):
  * ClusteredJoin            <- outOfGPU_Join1_payload (:802-994), in-memory
  * models/streaming.py      <- outOfGPU_Join3_payload (:1684-1984)
  * models/coprocess.py      <- outOfGPU_Join2_payload (:1000-1680)
  * clustered_probe_join     <- hj_ClusteredProbe dispatcher (:1990-2011)

`ClusteredJoin` has `aggregate`, `count`, `materialize` and
`late_aggregate`, with every `probe_mode` routed as the JAX engine routes
it (each call one `queries` in `ops/_launches.EVENTS`, its counts on the
result, and its read of the answer a `tpujoin.sync` span):

  * "auto" / "banded": the banded sort-merge probe (ops/band_join.py);
  * "pallas": radix-partition both sides, plan each R tile's S range on the
    host, and aggregate on the stream-range probe kernel
    (ops/probe_ranges.py); count, materialize and late aggregate take the
    blocked probe;
  * "blocked": radix-partition at `default_bits_for(max(n_r, n_s),
    probe_tile_r)` bits, plan work items from the histograms, and probe with
    the blocked compare (ops/probe.py);
  * "sort_merge": aggregate and count by binary search (ops/join_sorted.py);
    materialize and late aggregate take the blocked probe;
  * "perfect": the JAX engine never routes it to ops/perfect_hash.py; it
    falls through to the blocked probe at `radix.total_bits` bits, and so
    does the port.

The non-banded modes partition at `radix.total_bits` unless the mode is
"blocked". Every sort of (sortval, payload) pairs, the banded modes' two and
the partitions' two, runs under `config.sort_impl` ("lax" when unset; see
`band_join.sort_pairs`); "sort_merge" keeps its own stable sort, as in JAX.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from icde2019_gpu_join_tpu_torch.config import EngineConfig, default_bits_for
from icde2019_gpu_join_tpu_torch.ops import _launches
from icde2019_gpu_join_tpu_torch.ops import probe as probe_ops
from icde2019_gpu_join_tpu_torch.ops import probe_ranges, row_colsums
from icde2019_gpu_join_tpu_torch.ops.band_join import (
    SORT_IMPLS,
    banded_join_aggregate,
    banded_join_count,
    banded_join_late_aggregate,
    banded_materialize,
)
from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32
from icde2019_gpu_join_tpu_torch.ops.join_sorted import (
    sort_merge_aggregate,
    sort_merge_count,
)
from icde2019_gpu_join_tpu_torch.ops.partition import radix_partition
from icde2019_gpu_join_tpu_torch.relation import Relation
from icde2019_gpu_join_tpu_torch.utils import profiling
from icde2019_gpu_join_tpu_torch.utils.timing import PhaseTimer

PROBE_MODES = ("auto", "banded", "pallas", "blocked", "sort_merge", "perfect")
_BANDED = ("auto", "banded")


@dataclasses.dataclass
class JoinResult:
    aggregate: Optional[int] = None
    count: Optional[int] = None
    pairs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    timer: Optional[PhaseTimer] = None
    # what the call counted (`ClusteredJoin`): every table of the registry
    # in `ops/_launches.py`, its events and kernel launches, by name
    counts: Optional[Dict[str, int]] = None


def _counted(method):
    """A public call of the engine: one more `queries`, and the call's
    counts on its result, the difference of the counters across the call.
    Calls on other threads meanwhile would add theirs."""
    @functools.wraps(method)
    def call(self, *args, **kwargs):
        before = _launches.snapshot()
        _launches.count(_launches.EVENTS, "queries")
        res = method(self, *args, **kwargs)
        after = _launches.snapshot()
        res.counts = {name: n - before[name] for name, n in after.items()}
        return res
    return call


def _read(answer: torch.Tensor) -> int:
    """The host's read of a 0-d answer: a wait on the device."""
    with profiling.host_wait():
        return int(answer)


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def _colsums(r_cols: torch.Tensor, r_ids: torch.Tensor, s_cols: torch.Tensor,
             s_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both sides' column sums at their row ids (`ops/row_colsums.py`), in
    one `tpujoin.colsums` span."""
    with profiling.annotate("tpujoin.colsums"):
        return (row_colsums.row_colsums(r_cols, r_ids),
                row_colsums.row_colsums(s_cols, s_ids))


class ClusteredJoin:
    """In-memory join of two relations that lie on `device`."""

    def __init__(self, config: Optional[EngineConfig] = None, device="cuda"):
        self.config = config or EngineConfig()
        self.device = torch.device(device)
        mode = self.config.probe_mode
        if mode not in PROBE_MODES:
            raise ValueError(f"unknown probe_mode {mode!r}")
        # the engine's two hot sorts; there is no process-wide default
        self.sort_impl = self.config.sort_impl or "lax"
        if self.sort_impl not in SORT_IMPLS:
            raise ValueError(f"unknown sort_impl {self.sort_impl!r}")

    def _check(self, r: Relation, s: Relation, **cols: torch.Tensor):
        for name, dev in (("r", r.device), ("s", s.device),
                          *((k, v.device) for k, v in cols.items())):
            if not _same_device(dev, self.device):
                raise ValueError(f"{name} is on {dev}, the engine on "
                                 f"{self.device}")

    def _bits(self, n_r: int, n_s: int) -> int:
        cfg = self.config
        if cfg.probe_mode in ("blocked", "auto"):
            return default_bits_for(max(n_r, n_s), cfg.probe_tile_r)
        return cfg.radix.total_bits

    def _partition(self, r: Relation, s: Relation, timer: PhaseTimer):
        bits = self._bits(r.num_rows, s.num_rows)
        first_bit = self.config.radix.first_bit
        nrows = r.num_rows + s.num_rows
        with timer.phase("partition", bytes_moved=16 * nrows,
                         rows=nrows) as out:
            pr = radix_partition(r.keys, r.payload, bits, first_bit,
                                 self.sort_impl)
            ps = radix_partition(s.keys, s.payload, bits, first_bit,
                                 self.sort_impl)
            out["result"] = (pr.keys, ps.keys)
        return pr, ps

    def _partition_and_plan(self, r: Relation, s: Relation, timer: PhaseTimer):
        """Both sides partitioned, and the blocked probe's work items on
        the engine's device."""
        cfg = self.config
        pr, ps = self._partition(r, s, timer)
        with timer.phase("plan"):
            plan = probe_ops.plan_probe(
                pr.counts.cpu().numpy(), pr.offsets[:-1].cpu().numpy(),
                ps.counts.cpu().numpy(), ps.offsets[:-1].cpu().numpy(),
                cfg.probe_tile_r, cfg.probe_tile_s)
        return pr, ps, plan, plan.as_device(self.device)

    @_counted
    def aggregate(self, r: Relation, s: Relation) -> JoinResult:
        """SUM(Pr*Ps) over matches, int32 wraparound."""
        self._check(r, s)
        mode = self.config.probe_mode
        timer = PhaseTimer()
        nrows = r.num_rows + s.num_rows
        if mode in _BANDED:
            with timer.phase("join", bytes_moved=8 * nrows, rows=nrows) as out:
                agg = banded_join_aggregate(
                    r.keys, r.payload, s.keys, s.payload,
                    window_blocks=self.config.band_window_blocks,
                    sort_impl=self.sort_impl)
                out["result"] = agg
            return JoinResult(aggregate=_read(agg), timer=timer)
        if mode == "sort_merge":
            with timer.phase("join", bytes_moved=8 * nrows, rows=nrows) as out:
                agg = sort_merge_aggregate(r.keys, r.payload, s.keys, s.payload)
                out["result"] = agg
            return JoinResult(aggregate=_read(agg), timer=timer)
        if mode == "pallas":
            return self._aggregate_ranges(r, s, timer)
        pr, ps, plan, dev_plan = self._partition_and_plan(r, s, timer)
        with timer.phase("join", bytes_moved=8 * nrows, rows=nrows) as out:
            agg = probe_ops.blocked_probe_aggregate(
                pr.keys, pr.payload, ps.keys, ps.payload, *dev_plan,
                tile_r=plan.tile_r, tile_s=plan.tile_s)
            out["result"] = agg
        return JoinResult(aggregate=_read(agg), timer=timer)

    def _aggregate_ranges(self, r: Relation, s: Relation,
                          timer: PhaseTimer) -> JoinResult:
        """probe_mode "pallas": the stream-range probe kernel over the
        partitioned relations, its plan O(R tiles) numpy."""
        cfg = self.config
        tile_r = max(1024, cfg.probe_tile_r)
        tile_s = max(1024, cfg.probe_tile_s)
        pr, ps = self._partition(r, s, timer)
        with timer.phase("plan"):
            s_start, s_nch = probe_ranges.plan_ranges(
                pr.offsets.cpu().numpy(), ps.offsets.cpu().numpy(),
                r.num_rows, tile_r, tile_s)
        nrows = r.num_rows + s.num_rows
        with timer.phase("join", bytes_moved=8 * nrows, rows=nrows) as out:
            rk, rp = probe_ranges.pad_for_probe(pr.keys, pr.payload, tile_r)
            sk, sp = probe_ranges.pad_for_probe(ps.keys, ps.payload, tile_s)
            agg = probe_ranges.probe_aggregate_ranges(
                rk, rp, sk, sp, s_start, s_nch, tile_r=tile_r, tile_s=tile_s)
            out["result"] = agg
        return JoinResult(aggregate=_read(agg), timer=timer)

    @_counted
    def count(self, r: Relation, s: Relation) -> JoinResult:
        """Number of matching pairs. The banded modes return it mod 2^32 as
        an unsigned value; the others return JAX's int32 sum (x64 off) as
        it is, negative past 2^31 - 1."""
        self._check(r, s)
        mode = self.config.probe_mode
        timer = PhaseTimer()
        if mode in _BANDED:
            with timer.phase("join") as out:
                c = banded_join_count(
                    r.keys, s.keys, window_blocks=self.config.band_window_blocks,
                    sort_impl=self.sort_impl)
                out["result"] = c
            return JoinResult(count=_read(c) & 0xFFFFFFFF, timer=timer)
        if mode == "sort_merge":
            with timer.phase("join") as out:
                c = sort_merge_count(r.keys, s.keys)
                out["result"] = c
            return JoinResult(count=_read(c), timer=timer)
        pr, ps, plan, dev_plan = self._partition_and_plan(r, s, timer)
        with timer.phase("join") as out:
            c = probe_ops.blocked_probe_count(
                pr.keys, ps.keys, *dev_plan,
                tile_r=plan.tile_r, tile_s=plan.tile_s)
            out["result"] = c
        return JoinResult(count=_read(c), timer=timer)

    @_counted
    def materialize(self, r: Relation, s: Relation,
                    capacity: Optional[int] = None) -> JoinResult:
        """Matched (Pr, Ps) pairs in a ring buffer of `capacity` pairs
        (default `config.out_capacity`), plus the total match count
        (join_partitioned_results analog): mod 2^32 unsigned for the banded
        modes, JAX's int32 sum for the blocked probe that the others take."""
        self._check(r, s)
        capacity = capacity or self.config.out_capacity
        timer = PhaseTimer()
        if self.config.probe_mode in _BANDED:
            with timer.phase("join") as out:
                out_r, out_s, total = banded_materialize(
                    r.keys, r.payload, s.keys, s.payload, capacity=capacity,
                    window_blocks=self.config.band_window_blocks,
                    sort_impl=self.sort_impl)
                out["result"] = (out_r, out_s)
            return JoinResult(count=_read(total) & 0xFFFFFFFF,
                              pairs=(out_r, out_s), timer=timer)
        pr, ps, plan, dev_plan = self._partition_and_plan(r, s, timer)
        with timer.phase("join") as out:
            item_counts = probe_ops.blocked_probe_item_counts(
                pr.keys, ps.keys, *dev_plan,
                tile_r=plan.tile_r, tile_s=plan.tile_s)
            csum = torch.cumsum(item_counts, 0)
            base = wrap_i32(csum - item_counts)
            total = _read(wrap_i32(csum[-1]))
            out_r, out_s = probe_ops.blocked_probe_materialize(
                pr.keys, pr.payload, ps.keys, ps.payload, *dev_plan,
                base, capacity, tile_r=plan.tile_r, tile_s=plan.tile_s)
            out["result"] = (out_r, out_s)
        return JoinResult(count=total, pairs=(out_r, out_s), timer=timer)

    @_counted
    def late_aggregate(self, r: Relation, s: Relation, r_cols: torch.Tensor,
                       s_cols: torch.Tensor) -> JoinResult:
        """Late materialization: payloads are row ids; the extra int32
        columns r_cols [n_r, c1] and s_cols [n_s, c2] are summed per row and
        the probe sums (Rcolsum + Scolsum) over matches, int32 wraparound
        (outOfGPU_Join_payload_var analog,
        src/hash_join_clustered_probe.cu:542-708)."""
        self._check(r, s, r_cols=r_cols, s_cols=s_cols)
        timer = PhaseTimer()
        if self.config.probe_mode in _BANDED:
            with timer.phase("join") as out:
                r_sum, s_sum = _colsums(r_cols, r.payload, s_cols, s.payload)
                agg = banded_join_late_aggregate(
                    r.keys, r_sum, s.keys, s_sum,
                    window_blocks=self.config.band_window_blocks,
                    sort_impl=self.sort_impl)
                out["result"] = agg
            return JoinResult(aggregate=_read(agg), timer=timer)
        pr, ps, plan, dev_plan = self._partition_and_plan(r, s, timer)
        with timer.phase("join") as out:
            # column sums aligned to the partitioned order
            r_sum, s_sum = _colsums(r_cols, pr.payload, s_cols, ps.payload)
            agg = probe_ops.blocked_probe_late_aggregate(
                pr.keys, r_sum, ps.keys, s_sum, *dev_plan,
                tile_r=plan.tile_r, tile_s=plan.tile_s)
            out["result"] = agg
        return JoinResult(aggregate=_read(agg), timer=timer)


_HOST_PLACEMENTS = ("host", "pinned_host", "unpinned_host")


def dispatch_regime(n_r: int, n_s: int,
                    config: Optional[EngineConfig] = None) -> str:
    """Which regime the dispatcher will pick: "join1" (in-memory),
    "streaming" (Join3 analog) or "coprocess" (Join2 analog).
    hj_ClusteredProbe's size test (src/hash_join_clustered_probe.cu:
    2001-2009) plus the placement policy (MEM_TYPE analog): a side placed in
    host memory routes through the streamed regimes even if it would fit on
    the device."""
    config = config or EngineConfig()
    limit = config.resident_limit_rows
    s_resident = n_s <= limit and config.probe_placement not in _HOST_PLACEMENTS
    r_resident = n_r <= limit and config.build_placement not in _HOST_PLACEMENTS
    if r_resident and s_resident:
        return "join1"
    if r_resident:
        return "streaming"
    return "coprocess"


def _on(rel: Relation, device: torch.device) -> Relation:
    if _same_device(rel.device, device):
        return rel
    return Relation(rel.keys.to(device), rel.payload.to(device))


def clustered_probe_join(r: Relation, s: Relation,
                         config: Optional[EngineConfig] = None,
                         materialize: bool = False,
                         device="cuda") -> JoinResult:
    """Size-based dispatcher (hj_ClusteredProbe analog,
    src/hash_join_clustered_probe.cu:1990-2011): both sides resident ->
    `ClusteredJoin` on `device` (relations elsewhere are moved there); probe
    side over the resident limit -> streamed segments; build side over it ->
    host co-partitioning. The streamed regimes return the aggregate and
    ignore `materialize`, as in JAX: there is no streaming materialize."""
    config = config or EngineConfig()
    device = torch.device(device)
    regime = dispatch_regime(r.num_rows, s.num_rows, config)
    if regime == "join1":
        engine = ClusteredJoin(config, device)
        r, s = _on(r, device), _on(s, device)
        return engine.materialize(r, s) if materialize else engine.aggregate(r, s)
    if regime == "streaming":
        from icde2019_gpu_join_tpu_torch.models.streaming import (
            streaming_join_aggregate)
        return streaming_join_aggregate(r, s, config, device)
    from icde2019_gpu_join_tpu_torch.models.coprocess import (
        coprocess_join_aggregate)
    return coprocess_join_aggregate(r, s, config, device)
