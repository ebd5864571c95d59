"""Launch counters of the kernel wrappers.

Each wrapper module keeps a dict of counts by kernel (`LAUNCHES`) and adds
to it where it launches its kernel. Ranks of a thread world launch kernels
from several threads, and `+=` on a dict entry is a read-modify-write that
threads can interleave, so every count changes under one lock.
"""

from __future__ import annotations

import threading
from typing import Dict

_LOCK = threading.Lock()


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
