"""The seam between Python and the hand kernels: the checked launch, and the
registry of the port's counters.

`launch` calls a C entry point `tj_<name>` (bound by `_build.entry`, its
argument types taken from the call) on a stream, raises on a non-zero CUDA
error code, and adds one to the caller's table. A wrapper module makes its
table of launch counts (`LAUNCHES`) through `table`, which registers it,
with the C entry points the module launches; `EVENTS` counts what a query
does around its kernels. `snapshot()` and `reset()` with no argument cover
every registered table, so a new kernel's counts reach `JoinResult.counts`
with no edit outside its module.

Ranks of a thread world launch kernels from several threads, and `+=` on a
dict entry is a read-modify-write that threads can interleave, so every
count changes under one lock. Every table is cumulative since its last
`reset` and costs integer adds whether or not a profiler records.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch

from icde2019_gpu_join_tpu_torch.ops import _build

_LOCK = threading.Lock()

# Every registered table: (its module, the table, the C entry points the
# module launches with their (pointers, int64 values)).
_TABLES: List[Tuple[str, Dict[str, int], Mapping[str, Tuple[int, int]]]] = []


def table(module: str, names: Iterable[str],
          entries: Optional[Mapping[str, Tuple[int, int]]] = None
          ) -> Dict[str, int]:
    """A new table of counts, each of `names` at 0, registered under
    `module` with the entry points it launches. A name is counted in one
    table only."""
    counts = dict.fromkeys(names, 0)
    with _LOCK:
        taken = {n for _, t, _ in _TABLES for n in t}.intersection(counts)
        if taken:
            raise ValueError(f"{module}: {sorted(taken)} counted already")
        _TABLES.append((module, counts, dict(entries or {})))
    return counts


def tables() -> List[Tuple[str, Dict[str, int]]]:
    """Every registered table with its module, in the order made."""
    return [(module, counts) for module, counts, _ in _TABLES]


def entries() -> Dict[str, Tuple[int, int]]:
    """Every registered module's entry points: name -> (pointers, int64
    values), the form `_build.entry` binds."""
    return {name: sig for _, _, named in _TABLES for name, sig in named.items()}


# Engine events: public `ClusteredJoin` calls ("queries"), the rounds the
# banded probe's schedule walks ("probe_rounds"), and the host's waits on
# the device inside a query ("host_syncs", each one `tpujoin.sync` span of
# `utils/profiling.host_wait`).
EVENTS = table(__name__, ("queries", "probe_rounds", "host_syncs"))


def count(counts: Dict[str, int], name: str, n: int = 1):
    """Add n to counts[name]."""
    with _LOCK:
        counts[name] += n


def _all(counts) -> Sequence[Dict[str, int]]:
    return counts or [t for _, t, _ in _TABLES]


def reset(*counts: Dict[str, int]):
    """Zero every entry of every dict given; of every registered table when
    none is."""
    with _LOCK:
        for t in _all(counts):
            for name in t:
                t[name] = 0


def snapshot(*counts: Dict[str, int]) -> Dict[str, int]:
    """Every entry of every dict given (of every registered table when none
    is), as one dict read under the lock."""
    out: Dict[str, int] = {}
    with _LOCK:
        for t in _all(counts):
            out.update(t)
    return out


class Address(int):
    """A raw device address among a launch's pointers (0: a null pointer)."""

    def data_ptr(self) -> int:
        return int(self)


def launch(counts: Optional[Dict[str, int]], name: str, pointers: Sequence,
           *ints: int, counter: Optional[str] = None,
           stream: Optional[int] = None, context: str = ""):
    """Launch `tj_<name>` with the data pointers of `pointers` (tensors or
    `Address`es), then `ints`, on `stream`: by default the current stream of
    the first pointer's device, entered for the call. On a non-zero code
    raise `RuntimeError`, with `context` after the code; else add one to
    counts[counter] (`counter` defaults to name; no `counts`, no count)."""
    fn = _build.entry(name, len(pointers), len(ints))
    if stream is None:
        with torch.cuda.device(pointers[0].device):
            err = fn(*(x.data_ptr() for x in pointers), *ints,
                     torch.cuda.current_stream().cuda_stream)
    else:
        err = fn(*(x.data_ptr() for x in pointers), *ints, stream)
    if err != 0:
        raise RuntimeError(f"tj_{name} launch failed: CUDA error {err}"
                           + (f" {context}" if context else ""))
    if counts is not None:
        count(counts, counter or name)
