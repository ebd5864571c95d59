"""Profiler hooks on `torch.profiler` (the reference's nvprof / nvToolsExt
analog, Makefile:6,34).

Port of `icde2019_gpu_join_tpu/utils/profiling.py`:

  * `trace(logdir)`: a profile of everything run inside, host activity and,
    on a card, its kernels and copies, written to `logdir` as a Chrome
    trace (`chrome://tracing`, Perfetto). `maybe_trace` does the same only
    when given a directory or when `TPUJOIN_PROFILE_DIR` is set, the
    variable the JAX package reads.
  * `annotate(name)`: a named span in the trace (`record_function`) and, on
    a card, an NVTX range, entered only while a torch profiler records;
  * `host_wait()`: the span of a wait of the host on the device,
    `tpujoin.sync`, counted whether or not a profiler records.

The engine's spans, one each where a query crosses a layer:

    tpujoin.join          the whole banded call (a `utils/timing.PhaseTimer`
                          phase; every phase is `tpujoin.<phase>`)
    tpujoin.sort          one side's sort (`ops/band_join.sort_by_key`)
    tpujoin.probe         one probe call: schedule, read-back, round loop
    tpujoin.windows       the probe's block windows, under `tpujoin.probe`
    tpujoin.reduce        the "add" probe's sum of its per-S counts and
                          sums, after its `tpujoin.probe`
    tpujoin.colsums       a late aggregate's column sums of both sides,
                          gathered at their row ids (`models/joins.py`)
    tpujoin.extract       materialize's extraction, after its descriptors
    tpujoin.sync          each host wait on the device inside a query

A span's device time is that of the kernels, copies and fills launched
inside it; in the profiler's trace they lie on one clock with the spans, so
an idle gap of the device can be put down to the spans open on the host at
that moment. There are no spans per chunk or per round. The counters
beside them are the tables of the registry in `ops/_launches.py`: its
`EVENTS` and each kernel wrapper's `LAUNCHES`.

Streamed and co-processed overlap shows in such a trace as the copy
stream's uploads of segment k + 1 beside the compute stream's kernels of
segment k.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from icde2019_gpu_join_tpu_torch.ops import _launches

ENV_VAR = "TPUJOIN_PROFILE_DIR"


def _activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """Profile the enclosed block into `logdir`/trace_<time>_<pid>.json,
    the card's activity included when `device` is a card."""
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=_activities(device)) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"))


@contextlib.contextmanager
def maybe_trace(tag: str, logdir: Optional[str] = None, device="cuda"):
    """Trace the block iff a log dir is given or TPUJOIN_PROFILE_DIR is
    set; the trace lands in <dir>/<tag>/."""
    logdir = logdir or os.environ.get(ENV_VAR)
    if not logdir:
        yield None
        return
    with trace(os.path.join(logdir, tag), device) as prof:
        yield prof


# the no-op span: shared, since it holds no state
_OFF = contextlib.nullcontext()


def annotate(name: str, device="cuda"):
    """A named span of the trace and, on a card in use, an NVTX range,
    while a torch profiler records. Otherwise a shared no-op context, for
    the cost of one flag check: `record_function` costs microseconds even
    with no profiler."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return _span(name, device)


@contextlib.contextmanager
def _span(name: str, device):
    with torch.profiler.record_function(name):
        if (torch.device(device).type != "cuda"
                or not torch.cuda.is_initialized()):
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def host_wait():
    """Mark a wait of the host on the device inside a query: a
    `tpujoin.sync` span, whose host length is the wait, and one more
    `host_syncs` in `ops/_launches.EVENTS`."""
    _launches.count(_launches.EVENTS, "host_syncs")
    return annotate("tpujoin.sync")
