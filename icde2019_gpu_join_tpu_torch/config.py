"""Engine configuration: radix geometry, tile sizes, placement policy.

The same knobs as the JAX package's `icde2019_gpu_join_tpu/config.py`, as
frozen dataclasses. The engine reads `probe_mode`, `band_window_blocks`,
`radix`, `probe_tile_r` / `probe_tile_s` and `out_capacity`; the placement,
segment and skew-splitting fields are kept so a JAX engine's configuration
carries across unchanged (`EngineConfig.from_dict(dataclasses.asdict(jax_cfg))`).

Reference geometry (src/common.h:45-71): identity hash, partition id
`(uint32(key) >> first_bit) & (2^bits - 1)`, default radix width 13 bits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# --- Reference radix constants (src/common.h:51-52) ---
LOG_PARTS1 = 8
LOG_PARTS2 = 5
REF_RADIX_BITS = LOG_PARTS1 + LOG_PARTS2  # 13: the reference's final fanout


def hasht(x):
    """Identity hash, as in the reference (src/common.h:45-47)."""
    return x


@dataclasses.dataclass(frozen=True)
class RadixConfig:
    """Radix-partitioning geometry.

    total_bits: total radix width; 2^total_bits final partitions.
    first_bit:  low bit of the radix field.
    bits_per_pass: fanout per partition pass (multi-pass plan).
    """

    total_bits: int = REF_RADIX_BITS
    first_bit: int = 0
    bits_per_pass: int = 8

    @property
    def num_partitions(self) -> int:
        return 1 << self.total_bits

    @property
    def mask(self) -> int:
        return self.num_partitions - 1

    def pass_plan(self) -> Tuple[Tuple[int, int], ...]:
        """MSB-first multi-pass plan: tuples of (shift, bits)."""
        plan = []
        remaining = self.total_bits
        hi = self.first_bit + self.total_bits
        while remaining > 0:
            b = min(self.bits_per_pass, remaining)
            hi -= b
            plan.append((hi, b))
            remaining -= b
        return tuple(plan)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level engine knobs (the reference's `args` struct analog,
    src/common-host.h:39-52)."""

    radix: RadixConfig = dataclasses.field(default_factory=RadixConfig)
    probe_tile_r: int = 256
    probe_tile_s: int = 256
    max_tiles_per_item: int = 1
    # "auto" | "banded" (the banded sort-merge probe, ops/band_join.py) |
    # "pallas" (radix partition + the stream-range probe kernel,
    # ops/probe_ranges.py) | "blocked" (radix partition + ops/probe.py) |
    # "sort_merge" (ops/join_sorted.py) | "perfect" (routed as the JAX
    # engine routes it: to the blocked probe at radix.total_bits).
    probe_mode: str = "auto"
    # Banded probe: R-blocks (x128 rows) gathered per round per S block.
    band_window_blocks: int = 1
    segment_rows: Optional[int] = None
    build_placement: str = "hbm"
    probe_placement: str = "hbm"
    out_capacity: int = 1 << 24
    resident_limit_rows: int = 128_000_001
    # None or "lax" (torch.sort), "merge" (the merge-tree cascade) or
    # "packed" (one sort of packed words): `ops.band_join.sort_pairs`.
    sort_impl: Optional[str] = None

    @classmethod
    def from_dict(cls, d: dict) -> "EngineConfig":
        """Build from `dataclasses.asdict` of a JAX `EngineConfig`."""
        d = dict(d)
        radix = d.pop("radix", None)
        if isinstance(radix, dict):
            radix = RadixConfig(**radix)
        return cls(radix=radix or RadixConfig(), **d)

    def with_bits(self, total_bits: int) -> "EngineConfig":
        return dataclasses.replace(
            self, radix=dataclasses.replace(self.radix, total_bits=total_bits))


def default_bits_for(n_rows: int, tile: int = 256) -> int:
    """Radix width so the average partition fits one probe tile, in [4, 22]."""
    bits = max(4, (max(n_rows, 1) // max(tile, 1)).bit_length())
    return min(bits, 22)
