"""The in-memory join engine on one device (outOfGPU_Join1_payload analog,
src/hash_join_clustered_probe.cu:802-994), on the banded sort-merge probe.

Port of `icde2019_gpu_join_tpu/models/joins.py` `ClusteredJoin.aggregate`,
`.count`, `.materialize` and `.late_aggregate` with `probe_mode` "auto" /
"banded". The other probe modes raise `NotImplementedError` naming their
ROADMAP.md item; the size-based dispatcher is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from icde2019_gpu_join_tpu_torch.config import EngineConfig
from icde2019_gpu_join_tpu_torch.ops.band_join import (
    banded_join_aggregate,
    banded_join_count,
    banded_join_late_aggregate,
    banded_materialize,
)
from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32
from icde2019_gpu_join_tpu_torch.relation import Relation
from icde2019_gpu_join_tpu_torch.utils.timing import PhaseTimer

# probe modes of the JAX engine that the port does not run yet
_NOT_PORTED = {
    "blocked": "queue 1, item 7",
    "pallas": "queue 1, item 7 (kernel: queue 2, item 5)",
    "sort_merge": "queue 1, item 7",
    "perfect": "queue 1, item 7",
}


@dataclasses.dataclass
class JoinResult:
    aggregate: Optional[int] = None
    count: Optional[int] = None
    pairs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    timer: Optional[PhaseTimer] = None


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def _row_colsums(cols: torch.Tensor, rowid: torch.Tensor) -> torch.Tensor:
    """Per-row sum of `cols` [n, c] mod 2^32, gathered at the row ids; 0s
    when there are no columns. Row ids are read as JAX indexes: negative
    ones count from the end, then every id is clamped into range."""
    if cols.numel() == 0:
        return torch.zeros_like(rowid)
    n = cols.shape[0]
    idx = torch.where(rowid < 0, rowid.long() + n, rowid.long()).clamp_(0, n - 1)
    return wrap_i32(cols.sum(1))[idx]


class ClusteredJoin:
    """In-memory join of two relations that lie on `device`."""

    def __init__(self, config: Optional[EngineConfig] = None, device="cpu"):
        self.config = config or EngineConfig()
        self.device = torch.device(device)
        mode = self.config.probe_mode
        if mode in _NOT_PORTED:
            raise NotImplementedError(
                f"probe_mode={mode!r} is not ported yet: ROADMAP.md "
                f"{_NOT_PORTED[mode]}")
        if mode not in ("auto", "banded"):
            raise ValueError(f"unknown probe_mode {mode!r}")
        if self.config.sort_impl not in (None, "lax"):
            raise NotImplementedError(
                f"sort_impl={self.config.sort_impl!r} is not ported yet: "
                "ROADMAP.md queue 1, item 10")

    def _check(self, r: Relation, s: Relation, **cols: torch.Tensor):
        for name, dev in (("r", r.device), ("s", s.device),
                          *((k, v.device) for k, v in cols.items())):
            if not _same_device(dev, self.device):
                raise ValueError(f"{name} is on {dev}, the engine on "
                                 f"{self.device}")

    def aggregate(self, r: Relation, s: Relation) -> JoinResult:
        """SUM(Pr*Ps) over matches, int32 wraparound."""
        self._check(r, s)
        timer = PhaseTimer()
        nrows = r.num_rows + s.num_rows
        with timer.phase("join", bytes_moved=8 * nrows, rows=nrows) as out:
            agg = banded_join_aggregate(
                r.keys, r.payload, s.keys, s.payload,
                window_blocks=self.config.band_window_blocks,
            )
            out["result"] = agg
        return JoinResult(aggregate=int(agg), timer=timer)

    def count(self, r: Relation, s: Relation) -> JoinResult:
        """Number of matching pairs, mod 2^32."""
        self._check(r, s)
        timer = PhaseTimer()
        with timer.phase("join") as out:
            c = banded_join_count(r.keys, s.keys,
                                  window_blocks=self.config.band_window_blocks)
            out["result"] = c
        return JoinResult(count=int(c) & 0xFFFFFFFF, timer=timer)

    def materialize(self, r: Relation, s: Relation,
                    capacity: Optional[int] = None) -> JoinResult:
        """Matched (Pr, Ps) pairs in a ring buffer of `capacity` pairs
        (default `config.out_capacity`), plus the total match count mod 2^32
        (join_partitioned_results analog)."""
        self._check(r, s)
        capacity = capacity or self.config.out_capacity
        timer = PhaseTimer()
        with timer.phase("join") as out:
            out_r, out_s, total = banded_materialize(
                r.keys, r.payload, s.keys, s.payload, capacity=capacity,
                window_blocks=self.config.band_window_blocks)
            out["result"] = (out_r, out_s)
        return JoinResult(count=int(total) & 0xFFFFFFFF, pairs=(out_r, out_s),
                          timer=timer)

    def late_aggregate(self, r: Relation, s: Relation, r_cols: torch.Tensor,
                       s_cols: torch.Tensor) -> JoinResult:
        """Late materialization: payloads are row ids; the extra int32
        columns r_cols [n_r, c1] and s_cols [n_s, c2] are summed per row and
        the probe sums (Rcolsum + Scolsum) over matches, int32 wraparound
        (outOfGPU_Join_payload_var analog,
        src/hash_join_clustered_probe.cu:542-708)."""
        self._check(r, s, r_cols=r_cols, s_cols=s_cols)
        timer = PhaseTimer()
        with timer.phase("join") as out:
            agg = banded_join_late_aggregate(
                r.keys, _row_colsums(r_cols, r.payload),
                s.keys, _row_colsums(s_cols, s.payload),
                window_blocks=self.config.band_window_blocks)
            out["result"] = agg
        return JoinResult(aggregate=int(agg), timer=timer)
