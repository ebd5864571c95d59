"""Spans from the benchmark's own files, and the reading of the profiler's
trace into per-span device time, busy time and idle gaps.

A span is a file `spans/<name>.json`: {"module", "function", "layer"}. In a
traced run every function so named is wrapped in `record_function(
"joinbench.<name>")`, in its own module and in every loaded module of the
program that holds the same object under that name (`from m import f`),
and put back when the window closes. "function" may name a method as
"Class.method".

The trace is `torch.profiler`'s Chrome trace. Each device operation (a
kernel, a copy or a fill) is given to the spans open on the host when it
was launched: its launch is the runtime or driver call with the same
correlation id, or else the host operation with the same external id. A
span's time is the device time of everything launched inside it; a reader
may leave out what named spans inside it launched. The harness's own
check span (the window's clock stopped) is cut out of the window: what it
launched, its length and its idle time.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import importlib
import json
import os
import sys
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch

PREFIX = "joinbench."
WINDOW = PREFIX + "window"
QUERY = PREFIX + "query"
CHECK = PREFIX + "check"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


def load_spans(bench_dir: str) -> Dict[str, Dict]:
    """Every span file, by name."""
    spans = {}
    for path in sorted(glob.glob(os.path.join(bench_dir, "spans", "*.json"))):
        with open(path) as f:
            spans[os.path.splitext(os.path.basename(path))[0]] = json.load(f)
    return spans


def _wrap(fn, label: str):
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return spanned


@contextlib.contextmanager
def installed(spans: Dict[str, Dict]) -> Iterator[None]:
    """Wrap every span's function for the duration of the block."""
    undo: List[Tuple[object, str, object]] = []
    try:
        for name, spec in spans.items():
            module = importlib.import_module(spec["module"])
            *owner_path, attr = spec["function"].split(".")
            owner = module
            for part in owner_path:
                owner = getattr(owner, part)
            fn = getattr(owner, attr)
            wrapped = _wrap(fn, PREFIX + name)
            holders = [owner]
            if not owner_path:   # a module-level function: its importers too
                top = spec["module"].split(".")[0]
                holders += [m for key, m in list(sys.modules.items())
                            if key.split(".")[0] == top and m is not module
                            and getattr(m, attr, None) is fn]
            for holder in holders:
                undo.append((holder, attr, fn))
                setattr(holder, attr, wrapped)
        yield
    finally:
        for holder, attr, fn in reversed(undo):
            setattr(holder, attr, fn)


class Summary:
    """What a trace says, in microseconds on the trace's clock.

    chains[names]: device time launched inside exactly the spans named
    "joinbench.<name>" for each name of the frozenset `names`;
    busy / window: device busy time inside the window span, and the window's
    length, the check spans cut out of both; ops: device time by operation
    name; gaps: idle time inside the window by what the host was in when it
    began; unattributed: device operations whose launch was not found."""

    def __init__(self):
        self.chains: Dict[frozenset, float] = defaultdict(float)
        self.busy = 0.0
        self.window = 0.0
        self.ops: Dict[str, float] = defaultdict(float)
        self.gaps: Dict[str, float] = defaultdict(float)
        self.unattributed = 0

    def breakdown(self) -> Dict[str, List]:
        def top(d):
            return [[k, v / 1e6] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.ops), "idle_gaps": top(self.gaps)}


def _chains(points: List[float], spans: List[Tuple[float, float, str]]
            ) -> List[Tuple[str, ...]]:
    """For each time in `points` (ascending), the names of the spans that
    contain it, outermost first. Spans are properly nested intervals."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, k = [], [], 0
    for t in points:
        while k < len(spans) and spans[k][0] <= t:
            while stack and stack[-1][1] < spans[k][0]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(tuple(s[2] for s in stack if s[0] <= t <= s[1]))
    return out


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _minus(intervals: List[Tuple[float, float]],
           cuts: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The parts of disjoint ascending `intervals` outside every cut, in one
    pass over both."""
    cuts = _union(cuts)
    out, k = [], 0
    for a, b in intervals:
        while k < len(cuts) and cuts[k][1] <= a:
            k += 1
        j = k
        while j < len(cuts) and cuts[j][0] < b:
            c, d = cuts[j]
            if c > a:
                out.append((a, c))
            a = max(a, d)
            j += 1
        if a < b:
            out.append((a, b))
    return out


def summarize(events: List[Dict]) -> Summary:
    """Read a Chrome trace's events (the "traceEvents" list)."""
    out = Summary()
    spans, host_ops, device = [], [], []
    launch_at: Dict[int, float] = {}
    external_at: Dict[int, float] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        ts, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((ts, end, e.get("name", ""), args))
        elif cat in LAUNCH_CATS:
            if "correlation" in args:
                launch_at[args["correlation"]] = ts
            host_ops.append((ts, end, e.get("name", ""), e.get("tid")))
        elif cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            spans.append((ts, end, e["name"], e.get("tid")))
        elif cat == "cpu_op":
            if "External id" in args:
                external_at.setdefault(args["External id"], ts)
            host_ops.append((ts, end, e.get("name", ""), e.get("tid")))
    windows = [(a, b, tid) for a, b, n, tid in spans if n == WINDOW]
    if not windows:
        return out
    w0, w1, main = windows[0]
    # the host thread that ran the window: spans and host operations of
    # other threads do not nest with its own
    spans = [(a, b, n) for a, b, n, tid in spans if tid == main]
    host_ops = [(a, b, n) for a, b, n, tid in host_ops if tid == main]
    checks = [(max(a, w0), min(b, w1)) for a, b, n in spans
              if n == CHECK and b > w0 and a < w1]
    out.window = (w1 - w0) - sum(b - a for a, b in _union(checks))

    launched = []
    for ts, end, name, args in device:
        if end <= w0 or ts >= w1:
            continue
        at = launch_at.get(args.get("correlation"))
        if at is None:
            at = external_at.get(args.get("External id"))
        launched.append((-1.0 if at is None else at, ts, end, name))
    launched.sort()
    named = [(a, b, n[len(PREFIX):]) for a, b, n in spans
             if n not in (WINDOW, QUERY)]
    kept = []
    for (at, ts, end, name), chain in zip(
            launched, _chains([at for at, _, _, _ in launched], named)):
        if CHECK[len(PREFIX):] in chain:
            continue
        out.ops[name] += end - ts
        kept.append((ts, end))
        if at < 0:
            out.unattributed += 1
        else:
            out.chains[frozenset(chain)] += end - ts

    busy = _union([(max(ts, w0), min(end, w1)) for ts, end in kept])
    out.busy = sum(b - a for a, b in busy)
    idle, prev = [], w0
    for a, b in busy:
        if a > prev:
            idle.append((prev, a))
        prev = max(prev, b)
    if prev < w1:
        idle.append((prev, w1))
    idle = _minus(idle, checks)
    mids = [(a + b) / 2 for a, b in idle]
    span_chain = _chains(mids, [(a, b, n) for a, b, n in spans if n != WINDOW])
    op_chain = _chains(mids, host_ops)
    for (a, b), sc, oc in zip(idle, span_chain, op_chain):
        where = sc[-1][len(PREFIX):] if sc else "between queries"
        if oc:
            where += ":" + oc[-1]
        out.gaps[where] += b - a
    return out


def read(path: str) -> Summary:
    with open(path) as f:
        return summarize(json.load(f)["traceEvents"])


class LayerView:
    """What a per-layer metric's reader sees: the trace's summary and the
    run's sizes. Times per query in ms; 0.0 where the trace has nothing."""

    def __init__(self, summary: Summary, queries: int, n_r: int, n_s: int,
                 hbm_gbps: Optional[float]):
        self.summary = summary
        self.queries = queries
        self.n_r, self.n_s = n_r, n_s
        self.hbm_gbps = hbm_gbps
        self.busy_s = summary.busy / 1e6
        self.window_s = summary.window / 1e6

    def span_ms(self, *names: str, outside: Tuple[str, ...] = ()) -> float:
        """Device ms a query launched inside any of the spans `names` and
        inside none of the spans `outside`."""
        if not self.queries:
            return 0.0
        total = sum(t for chain, t in self.summary.chains.items()
                    if chain & set(names) and not chain & set(outside))
        return total / 1e3 / self.queries

    def bytes_ms(self, n_bytes: float) -> Optional[float]:
        """The least time n_bytes take at the card's data-sheet memory
        rate, in ms; None without a rate."""
        if not self.hbm_gbps:
            return None
        return n_bytes / (self.hbm_gbps * 1e9) * 1e3
