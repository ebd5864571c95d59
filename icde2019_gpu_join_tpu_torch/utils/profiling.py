"""Profiler hooks on `torch.profiler` (the reference's nvprof / nvToolsExt
analog, Makefile:6,34).

Port of `icde2019_gpu_join_tpu/utils/profiling.py`:

  * `trace(logdir)`: a profile of everything run inside, host activity and,
    on a card, its kernels and copies, written to `logdir` as a Chrome
    trace (`chrome://tracing`, Perfetto). `maybe_trace` does the same only
    when given a directory or when `TPUJOIN_PROFILE_DIR` is set, the
    variable the JAX package reads.
  * `annotate(name)`: a named span in the trace (`record_function`) and, on
    a card, an NVTX range.

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


@contextlib.contextmanager
def annotate(name: str, device="cuda"):
    """A named span of the trace; on a card also an NVTX range."""
    with torch.profiler.record_function(name):
        if torch.device(device).type != "cuda":
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()
