"""Phase timing and throughput metrics (reference C21 analog).

The reference reports per-phase MB/s as 2*(|R|+|S|)*4B / t
(src/hash_join_clustered_probe.cu:937-940). A phase's clock stops only
after the device has finished the phase's result: CUDA work is enqueued
asynchronously, so the timer synchronises when the result lies on a card.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch


@dataclass
class Phase:
    name: str
    seconds: float
    bytes_moved: int = 0
    rows: int = 0


def cuda_device_of(result) -> Optional[torch.device]:
    """The device of the first CUDA tensor in `result` (a tensor, or a tuple
    or list of them), None when it holds none."""
    items = result if isinstance(result, (tuple, list)) else (result,)
    for x in items:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            return x.device
    return None


@dataclass
class PhaseTimer:
    """Collects named phases; a phase that sets `out["result"]` to CUDA
    tensors is closed by synchronising the card of the first of them."""

    phases: List[Phase] = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, name: str, bytes_moved: int = 0, rows: int = 0):
        t0 = time.perf_counter()
        out = {}
        try:
            with torch.profiler.record_function(f"tpujoin.{name}"):
                yield out
        finally:
            dev = cuda_device_of(out.get("result"))
            if dev is not None:
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            self.phases.append(Phase(name, t1 - t0, bytes_moved, rows))

    def seconds(self, name: str) -> float:
        return sum(p.seconds for p in self.phases if p.name == name)

    def total_seconds(self) -> float:
        return sum(p.seconds for p in self.phases)

    def report(self, extra: Optional[Dict] = None) -> Dict:
        out = {"phases": {}}
        for p in self.phases:
            d = out["phases"].setdefault(
                p.name, {"seconds": 0.0, "bytes": 0, "rows": 0}
            )
            d["seconds"] += p.seconds
            d["bytes"] += p.bytes_moved
            d["rows"] += p.rows
        for d in out["phases"].values():
            if d["seconds"] > 0:
                d["gbps"] = d["bytes"] / d["seconds"] / 1e9
                d["mrows_per_s"] = d["rows"] / d["seconds"] / 1e6
        if extra:
            out.update(extra)
        return out

    def print_report(self, extra: Optional[Dict] = None):
        print(json.dumps(self.report(extra)))


def best_ms(fn, device, reps: int = 5) -> float:
    """Best time of one call of fn in milliseconds over `reps` calls, after
    one warm-up call: by CUDA events when `device` is a card (the call's
    device work), else by the host clock."""
    if torch.device(device).type != "cuda":
        fn()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best * 1e3
    fn()
    torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        best = min(best, start.elapsed_time(end))
    return best


def ref_throughput_mbps(n_r: int, n_s: int, seconds: float) -> float:
    """The reference's headline metric: 2*(|R|+|S|)*4 bytes / t in MB/s
    (src/hash_join_clustered_probe.cu:938-940)."""
    if seconds <= 0:
        return float("inf")
    return 2.0 * (n_r + n_s) * 4.0 / seconds / 1e6
