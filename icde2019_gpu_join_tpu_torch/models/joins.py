"""The in-memory join engine on one device (outOfGPU_Join1_payload analog,
src/hash_join_clustered_probe.cu:802-994), on the banded sort-merge probe.

Port of `icde2019_gpu_join_tpu/models/joins.py` `ClusteredJoin.aggregate`
and `.count` with `probe_mode` "auto" / "banded". The other probe modes,
materialization, late materialization and the size-based dispatcher are not
ported yet and raise `NotImplementedError` naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from icde2019_gpu_join_tpu_torch.config import EngineConfig
from icde2019_gpu_join_tpu_torch.ops.band_join import (
    banded_join_aggregate,
    banded_join_count,
)
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
    timer: Optional[PhaseTimer] = None


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


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

    def _check(self, r: Relation, s: Relation):
        for name, rel in (("r", r), ("s", s)):
            if not _same_device(rel.device, self.device):
                raise ValueError(f"relation {name} is on {rel.device}, the "
                                 f"engine on {self.device}")

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
