"""Phase timing, throughput metrics and the card's rates (reference C21
analog).

The reference reports per-phase MB/s as 2*(|R|+|S|)*4B / t
(src/hash_join_clustered_probe.cu:937-940). A phase's clock stops only
after the device has finished the phase's result: CUDA work is enqueued
asynchronously, so the timer synchronises when the result lies on a card.
Its report adds each phase's share of the device's memory rate
(`roofline_frac`), as the JAX package's does.

The card's rates live here and nowhere else: `detect_hbm_gbps` (the data
sheet's memory rate, looked up by the card's name) and `int_ops_per_s` (SMs
x 128 integer operations a clock x the maximum SM clock). The bench's
shares, the timer's
roofline fractions and `chip_smoke.py`'s bounds all read them.
"""

from __future__ import annotations

import contextlib
import functools
import json
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from icde2019_gpu_join_tpu_torch.utils import profiling

# Device memory rate (GB/s) by name, NVIDIA's data sheets; matched as a
# case-insensitive substring of `torch.cuda.get_device_name`. "cpu" is the
# JAX package's own figure for the host, kept so that both packages report
# the same keys and values on the CPU.
DEFAULT_HBM_GBPS = {
    "H100 80GB HBM3": 3350.0,   # the SXM part's name as the driver gives it
    "H100 SXM": 3350.0,
    "H100 PCIe": 2000.0,
    "H100 NVL": 3900.0,
    "cpu": 50.0,
}
# Integer operations an SM issues a clock: four schedulers, one warp
# instruction of 32 lanes each. The INT32 pipe takes 64 lanes of them;
# adds, moves and selects that compile to IMAD issue on the FMA pipe, the
# other 64 (on an H100, kernel 1's predicated adds ran at 80 a clock).
INT32_OPS_PER_SM_CLOCK = 128
COPY_BYTES = 1 << 28        # the buffer an unknown card's copy rate is read on


def datasheet_hbm_gbps(name: str) -> Optional[float]:
    """The table's memory rate for a device name, None when it has none."""
    for key, gbps in DEFAULT_HBM_GBPS.items():
        if key.lower() in name.lower():
            return gbps
    return None


@functools.lru_cache(maxsize=None)
def _copy_gbps(index: int) -> float:
    """Measured device-to-device copy rate of card `index` in GB/s (bytes
    read plus bytes written), best of 5 after a warm-up; once per card."""
    device = torch.device("cuda", index)
    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    ms = best_ms(lambda: dst.copy_(src), device)
    return 2 * COPY_BYTES / ms / 1e6


def detect_hbm_gbps(device=None) -> float:
    """Device memory rate in GB/s for `device` (default: the card).

    The CPU: 50.0, as the JAX package reports it. A card the table names:
    its data-sheet figure, a dictionary lookup and no device work, so that a
    caller may ask inside a timed window. Any other card: its measured
    device-to-device copy rate, taken once per card."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return DEFAULT_HBM_GBPS["cpu"]
    index = torch.cuda.current_device() if device.index is None else device.index
    gbps = datasheet_hbm_gbps(torch.cuda.get_device_name(index))
    return gbps if gbps is not None else _copy_gbps(index)


def int_ops_per_s(device="cuda") -> float:
    """The card's int32 operation rate: SMs x INT32_OPS_PER_SM_CLOCK x the
    maximum SM clock that `nvidia-smi --query-gpu=clocks.max.sm` reports
    (its line of the card's index: cards numbered as `nvidia-smi` numbers
    them)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"int_ops_per_s needs a card, not {device}")
    index = torch.cuda.current_device() if device.index is None else device.index
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * INT32_OPS_PER_SM_CLOCK * float(clocks[index]) * 1e6


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
    tensors is closed by synchronising the card of the first of them, and
    that card's memory rate is the report's `hbm_gbps` (the CPU's when no
    phase synchronised one). A phase is the span `tpujoin.<name>`, and its
    synchronisation a `tpujoin.sync` (`utils/profiling`)."""

    phases: List[Phase] = field(default_factory=list)
    device: Optional[torch.device] = None

    @contextlib.contextmanager
    def phase(self, name: str, bytes_moved: int = 0, rows: int = 0):
        t0 = time.perf_counter()
        out = {}
        try:
            with profiling.annotate(f"tpujoin.{name}"):
                yield out
        finally:
            dev = cuda_device_of(out.get("result"))
            if dev is not None:
                with profiling.host_wait():
                    torch.cuda.synchronize(dev)
                self.device = dev
            t1 = time.perf_counter()
            self.phases.append(Phase(name, t1 - t0, bytes_moved, rows))

    def seconds(self, name: str) -> float:
        return sum(p.seconds for p in self.phases if p.name == name)

    def total_seconds(self) -> float:
        return sum(p.seconds for p in self.phases)

    def report(self, extra: Optional[Dict] = None) -> Dict:
        hbm_gbps = detect_hbm_gbps(self.device or "cpu")
        out = {"phases": {}, "hbm_gbps": hbm_gbps}
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
                d["roofline_frac"] = d["gbps"] / hbm_gbps
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


# device clock cycles the card sleeps while the host queues timed calls:
# 10 ms at 2 GHz
HOLD_CYCLES = 20_000_000


def queued_ms(fn, device, reps: int) -> float:
    """Mean time of one call of fn over `reps` calls queued back to back
    after a warm-up, by two events around them all. On a card the card first
    sleeps HOLD_CYCLES while the host queues the calls, so that a call
    shorter than its launch's host work is timed on the card and not by the
    host; on the CPU the host clock times them."""
    fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def ref_throughput_mbps(n_r: int, n_s: int, seconds: float) -> float:
    """The reference's headline metric: 2*(|R|+|S|)*4 bytes / t in MB/s
    (src/hash_join_clustered_probe.cu:938-940)."""
    if seconds <= 0:
        return float("inf")
    return 2.0 * (n_r + n_s) * 4.0 / seconds / 1e6
