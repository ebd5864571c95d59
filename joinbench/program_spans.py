"""The program's own spans and counters, for the per-layer metrics that read
them.

The port opens `record_function` spans named `tpujoin.*` where a query
crosses a layer (its `utils/profiling.py` lists them) and counts engine
calls, probe rounds, host waits and kernel launches in tables of its own
(`ops/_launches.EVENTS`, each kernel wrapper's `LAUNCHES`).

Spans: the traced run's trace file is read once more, here. The program's
spans are handed to `trace.summarize` as spans of their own, each renamed
with the names of the program spans around it
("joinbench.tpujoin.join/tpujoin.probe"), and the benchmark's function
wrappers are left out. So every device operation goes to the chain of
program spans open when it was launched, and every idle gap of the device
to the chain open on the host at the gap's midpoint, the rule
`trace.summarize` applies to its innermost span. The parse is cached by the
file's path, size and modification time: the readers of one run share it.
A reader finds the file from its own path, so that a copy of the benchmark
reads its own trace.

Counters: the port's tables in this process, cumulative since the process
began, so they include the two warm-up queries. Those run on the same two
input pairs that the window alternates, so a count's mean a query moves by
less than 1/(n + 2) of the difference between the two pairs.

A reader returns None where its source is absent: a program without these
spans or tables, the control, or device time on the CPU.
"""

from __future__ import annotations

import functools
import json
import os
import sys
from collections import Counter, defaultdict
from typing import Dict, FrozenSet, List, Optional

from joinbench import harness, trace

PROGRAM = "tpujoin."
NEST = "/"
PORT = "icde2019_gpu_join_tpu_torch."
# the harness's spans that `trace.summarize` needs; every other span of the
# benchmark is a function wrapper
OWN = (trace.WINDOW, trace.QUERY, trace.CHECK)


class Program:
    """What a trace says of the program's spans, in microseconds.

    device[names]: device time launched inside exactly the program spans
    `names`; idle[names]: idle time of the device inside the window while
    the host was inside exactly `names` (empty: in none); spans[name]: the
    program spans of that name that began inside the window; busy: as
    `trace.Summary` has it."""

    def __init__(self, summary: trace.Summary, spans: Counter):
        self.device: Dict[FrozenSet[str], float] = defaultdict(float)
        self.idle: Dict[FrozenSet[str], float] = defaultdict(float)
        for chain, t in summary.chains.items():
            self.device[_names(*chain)] += t
        for where, t in summary.gaps.items():
            self.idle[_names(where.split(":", 1)[0])] += t
        self.spans = spans
        self.busy = summary.busy


def _names(*nested: str) -> FrozenSet[str]:
    """The program span names in renamed spans' names."""
    return frozenset(n for name in nested for n in name.split(NEST)
                     if n.startswith(PROGRAM))


def program_events(events: List[Dict]):
    """(events, spans): the trace's events with the benchmark's function
    wrappers left out and each program span renamed with its chain, and the
    count of program spans by name that began inside the window on its
    thread."""
    kept, spans = [], []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            name = e.get("name", "")
            if name.startswith(PROGRAM):
                spans.append(e)
                continue
            if name.startswith(trace.PREFIX) and name not in OWN:
                continue
        kept.append(e)
    window = next((e for e in kept if e.get("name") == trace.WINDOW
                   and e.get("cat") == "user_annotation"), None)
    count: Counter = Counter()
    stacks: Dict[object, List] = defaultdict(list)
    for e in sorted(spans, key=lambda e: (float(e["ts"]),
                                          -float(e.get("dur", 0.0)))):
        ts = float(e["ts"])
        end = ts + float(e.get("dur", 0.0))
        stack = stacks[e.get("tid")]
        while stack and stack[-1][0] < end:
            stack.pop()
        path = (stack[-1][1] + NEST if stack else "") + e["name"]
        stack.append((end, path))
        kept.append(dict(e, name=trace.PREFIX + path))
        if (window is not None and e.get("tid") == window.get("tid")
                and float(window["ts"]) <= ts
                < float(window["ts"]) + float(window.get("dur", 0.0))):
            count[e["name"]] += 1
    return kept, count


@functools.lru_cache(maxsize=1)
def _load(path: str, size: int, mtime_ns: int) -> Program:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kept, spans = program_events(events)
    del events
    return Program(trace.summarize(kept), spans)


def load(path: str) -> Optional[Program]:
    """The program's spans in the trace file at `path`; None without one."""
    try:
        st = os.stat(path)
    except FileNotFoundError:
        return None
    return _load(path, st.st_size, st.st_mtime_ns)


def trace_path(reader_file: str) -> str:
    """The trace file of the benchmark that holds `metrics/<name>.py`."""
    bench_dir = os.path.dirname(os.path.dirname(os.path.abspath(reader_file)))
    return os.path.join(bench_dir, harness.TRACE_FILE)


def device_ms(reader_file: str, view, name: str) -> Optional[float]:
    """Device ms a query launched inside the program span `name`, spans
    inside it included; None where there is none."""
    program = load(trace_path(reader_file))
    if program is None or not view.queries:
        return None
    us = sum(t for names, t in program.device.items() if name in names)
    return us / 1e3 / view.queries or None


def idle_ms(reader_file: str, view, name: str) -> Optional[float]:
    """Device-idle ms a query of the gaps that fall while the host is
    inside the program span `name`; None without a device trace or without
    such spans."""
    program = load(trace_path(reader_file))
    if (program is None or not view.queries or program.busy <= 0
            or not program.spans[name]):
        return None
    us = sum(t for names, t in program.idle.items() if name in names)
    return us / 1e3 / view.queries


def port_table(module: str, table: str) -> Optional[Dict[str, int]]:
    """A counter table of the port, as loaded in this process; None where
    the port has no such table."""
    return getattr(sys.modules.get(PORT + module), table, None)


def per_query(table: Optional[Dict[str, int]], prefix: str) -> Optional[float]:
    """The entries of a port counter table whose names begin with `prefix`,
    summed, over the port's count of public engine calls (the warm-up
    queries included); None without the tables or without a call."""
    events = port_table("ops._launches", "EVENTS")
    if not table or not events or not events.get("queries"):
        return None
    return sum(n for k, n in table.items()
               if k.startswith(prefix)) / events["queries"]
