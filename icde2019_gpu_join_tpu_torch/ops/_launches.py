"""The port's counters: launches of the kernel wrappers and the engine's
events.

Each wrapper module keeps a dict of counts by kernel (`LAUNCHES`) and adds
to it where it launches its kernel. `EVENTS` counts what a query does
around its kernels. Ranks of a thread world launch kernels from several
threads, and `+=` on a dict entry is a read-modify-write that threads can
interleave, so every count changes under one lock. Every table is
cumulative since its last `reset` and costs integer adds whether or not a
profiler records.
"""

from __future__ import annotations

import threading
from typing import Dict

_LOCK = threading.Lock()

# Engine events: public `ClusteredJoin` calls ("queries"), the rounds the
# banded probe's schedule walks ("probe_rounds"), and the host's waits on
# the device inside a query ("host_syncs", each one `tpujoin.sync` span of
# `utils/profiling.host_wait`).
EVENTS: Dict[str, int] = {"queries": 0, "probe_rounds": 0, "host_syncs": 0}


def count(counts: Dict[str, int], name: str, n: int = 1):
    """Add n to counts[name]."""
    with _LOCK:
        counts[name] += n


def reset(*counts: Dict[str, int]):
    """Zero every entry of every dict given."""
    with _LOCK:
        for table in counts:
            for name in table:
                table[name] = 0


def snapshot(*counts: Dict[str, int]) -> Dict[str, int]:
    """Every entry of every dict given, as one dict read under the lock."""
    out: Dict[str, int] = {}
    with _LOCK:
        for table in counts:
            out.update(table)
    return out
