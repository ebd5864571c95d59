"""Transfer / compute overlap of the out-of-memory pipelines.

Counterpart of `benchmarks/overlap_bench.py`, both legs. Each leg times the
pipeline's parts apart and then the pipeline itself:

  t_transfer  every segment (streaming) or partition pair (co-processing)
              uploaded from pinned host memory on the copy stream, no
              compute: CUDA events on the copy stream;
  t_compute   every segment or pair sorted and probed from device memory,
              no transfer: CUDA events on the compute stream (the probe's
              host read per round histogram falls inside);
  t_pipeline  the real pipeline: the "stream" phase of
              `streaming_join_aggregate`, the "pairs" phase of
              `coprocess_join_aggregate` (host clock to a synchronised end);

  overlap_fraction = (t_transfer + t_compute - t_pipeline)
                     / min(t_transfer, t_compute), clipped to [0, 1]:
  1 = the smaller part fully hidden, 0 = serialized.

The streaming leg also times `t_staging_s`, the threaded staging copy of every
segment into pinned memory on the host (the pipeline's host work, in neither
part above), and reports `lower_bound_ratio` = t_pipeline / the largest of
the three parts. The co-processing leg reports `t_host_partition_s` (the
pipeline's two host phases), the batches and pairs of its schedule, and
`lower_bound_ratio` = t_pipeline / max(t_transfer, t_compute). On the CPU
(`--device cpu`) every time is the host clock's, and no copy overlaps.

Usage: python -m icde2019_gpu_join_tpu_torch.benchmarks.overlap_bench
           [streaming|coprocess] [--log2-r 20] [--log2-s 24] [--segments 8]
           [--device cpu]
(the co-processing leg joins 2^log2-s rows per side). Prints one JSON line;
exits 1 if the aggregate is not the oracle's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from icde2019_gpu_join_tpu_torch import datagen
from icde2019_gpu_join_tpu_torch.config import EngineConfig
from icde2019_gpu_join_tpu_torch.models import coprocess as cp
from icde2019_gpu_join_tpu_torch.models.streaming import (
    streaming_join_aggregate)
from icde2019_gpu_join_tpu_torch.ops.band_join import (banded_join_aggregate,
                                                       banded_probe,
                                                       sort_by_key)
from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32
from icde2019_gpu_join_tpu_torch.relation import Relation
from icde2019_gpu_join_tpu_torch.utils.placement import Uploader, pinned_empty


def _seconds(fn, up: Uploader, on_copy_stream: bool = False):
    """(seconds of fn's device work, fn's result): CUDA events around fn on
    the copy or the compute stream of `up`, then a synchronise; the host
    clock on the CPU."""
    if not up.on_card:
        t0 = time.perf_counter()
        out = fn()
        return time.perf_counter() - t0, out
    stream = up.copy_stream if on_copy_stream else up.compute_stream
    torch.cuda.synchronize(up.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    out = fn()
    end.record(stream)
    torch.cuda.synchronize(up.device)
    return start.elapsed_time(end) / 1e3, out


def _overlap(t_transfer: float, t_compute: float, t_pipe: float) -> float:
    return min(1.0, max(0.0, (t_transfer + t_compute - t_pipe)
                        / max(1e-9, min(t_transfer, t_compute))))


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def _oracle(rk, rp, sk, sp, expect: Optional[int]) -> int:
    return datagen.host_oracle_aggregate(rk, rp, sk, sp) if expect is None \
        else expect


def streaming_leg(rk: np.ndarray, rp: np.ndarray, sk: np.ndarray,
                  sp: np.ndarray, segments: int = 8, window_blocks: int = 1,
                  expect: Optional[int] = None, device="cuda") -> dict:
    """The streaming pipeline's parts and the pipeline, S in `segments`
    segments; `expect` is the aggregate (None: the host oracle's)."""
    device = torch.device(device)
    n_s = sk.size
    seg = max(1, -(-n_s // segments))
    bounds = [(lo, min(lo + seg, n_s)) for lo in range(0, n_s, seg)]
    up = Uploader(device)
    r_sv, r_p = sort_by_key(torch.from_numpy(rk).to(device),
                            torch.from_numpy(rp).to(device))

    host = [(pinned_empty(hi - lo, device), pinned_empty(hi - lo, device))
            for lo, hi in bounds]
    t0 = time.perf_counter()
    for (k, p), (lo, hi) in zip(host, bounds):
        datagen.staging_copy(k.numpy(), sk[lo:hi])
        datagen.staging_copy(p.numpy(), sp[lo:hi])
    t_staging = time.perf_counter() - t0

    def probe_all(staged):
        total = torch.zeros((), dtype=torch.int64, device=device)
        for k, p in staged:
            total += banded_probe(r_sv, r_p, *sort_by_key(k, p), window_blocks)
        return total

    probe_all([up.put(*host[0])[0]])   # warm-up: first launches, allocator
    t_transfer, staged = _seconds(
        lambda: [up.put(k, p)[0] for k, p in host], up, on_copy_stream=True)
    t_compute, total = _seconds(lambda: probe_all(staged), up)
    agg_compute = int(wrap_i32(total))
    del staged, host

    res = streaming_join_aggregate(
        Relation.from_numpy(rk, rp, device="cpu"),
        Relation.from_numpy(sk, sp, device="cpu"),
        EngineConfig(segment_rows=seg, band_window_blocks=window_blocks),
        device=device)
    t_pipe = res.timer.seconds("stream")
    expect = _oracle(rk, rp, sk, sp, expect)
    return {
        "pipeline": "streaming", "device": _device_name(device),
        "n_r": int(rk.size), "n_s": int(n_s), "segments": len(bounds),
        "segment_rows": seg,
        "t_staging_s": t_staging, "t_transfer_s": t_transfer,
        "t_compute_s": t_compute, "t_pipeline_s": t_pipe,
        "t_build_sort_s": res.timer.seconds("build_sort"),
        "overlap_fraction": _overlap(t_transfer, t_compute, t_pipe),
        "lower_bound_ratio": t_pipe / max(t_staging, t_transfer, t_compute,
                                          1e-9),
        "aggregate": res.aggregate,
        "correct": res.aggregate == agg_compute == expect,
    }


def coprocess_leg(rk: np.ndarray, rp: np.ndarray, sk: np.ndarray,
                  sp: np.ndarray, config: Optional[EngineConfig] = None,
                  expect: Optional[int] = None, device="cuda") -> dict:
    """The co-processing pipeline's parts and the pipeline; `expect` is the
    aggregate (None: the host oracle's)."""
    config = config or EngineConfig()
    device = torch.device(device)
    fb = config.radix.first_bit
    w = config.band_window_blocks
    impl = config.sort_impl
    up = Uploader(device)
    rk_p, rp_p, cnt_r, off_r = cp.host_partition_pinned(rk, rp, fb, device)
    sk_p, sp_p, _, off_s = cp.host_partition_pinned(sk, sp, fb, device)
    batch_of = cp.build_batches(cnt_r, rk.size)
    schedule = cp.pair_schedule(batch_of, off_r, off_s)
    host = [(rk_p[off_r[p]:off_r[p + 1]], rp_p[off_r[p]:off_r[p + 1]],
             sk_p[s_lo:s_hi], sp_p[s_lo:s_hi])
            for _, p, s_lo, s_hi in schedule]

    def join_all(staged):
        total = torch.zeros((), dtype=torch.int64, device=device)
        for quad in staged:
            total += banded_join_aggregate(*quad, window_blocks=w,
                                           sort_impl=impl)
        return total

    if host:   # warm-up: first launches, allocator
        join_all([up.put(*host[0])[0]])
    t_transfer, staged = _seconds(
        lambda: [up.put(*quad)[0] for quad in host], up, on_copy_stream=True)
    t_compute, total = _seconds(lambda: join_all(staged), up)
    agg_compute = int(wrap_i32(total))
    del staged, host, rk_p, rp_p, sk_p, sp_p

    res = cp.coprocess_join_aggregate(
        Relation.from_numpy(rk, rp, device="cpu"),
        Relation.from_numpy(sk, sp, device="cpu"), config, device=device)
    t_pipe = res.timer.seconds("pairs")
    expect = _oracle(rk, rp, sk, sp, expect)
    return {
        "pipeline": "coprocess", "device": _device_name(device),
        "n_r": int(rk.size), "n_s": int(sk.size),
        "batches": int(batch_of.max()) + 1, "pairs": len(schedule),
        "t_transfer_s": t_transfer, "t_compute_s": t_compute,
        "t_pipeline_s": t_pipe,
        "t_host_partition_s": (res.timer.seconds("host_partition_R")
                               + res.timer.seconds("host_partition_S")),
        "overlap_fraction": _overlap(t_transfer, t_compute, t_pipe),
        "lower_bound_ratio": t_pipe / max(t_transfer, t_compute, 1e-9),
        "aggregate": res.aggregate,
        "correct": res.aggregate == agg_compute == expect,
    }


def main(argv: Optional[List[str]] = None) -> int:
    from icde2019_gpu_join_tpu_torch.utils import datasets, oracle

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("leg", nargs="?", default="streaming",
                        choices=("streaming", "coprocess"))
    parser.add_argument("--log2-r", type=int, default=20)
    parser.add_argument("--log2-s", type=int, default=24)
    parser.add_argument("--segments", type=int, default=8)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.leg == "streaming":
        n_r, n_s = 1 << args.log2_r, 1 << args.log2_s
        seed = 11
    else:
        n_r = n_s = 1 << args.log2_s
        seed = 13
    rk, sk = datasets.make_pk_fk(n_r, n_s, seed=seed)
    rp, sp = np.ones(n_r, np.int32), np.ones(n_s, np.int32)
    expect = oracle.join_count(rk, sk)
    if args.leg == "streaming":
        line = streaming_leg(rk, rp, sk, sp, args.segments, window_blocks=2,
                             expect=expect, device=args.device)
    else:
        line = coprocess_leg(rk, rp, sk, sp, expect=expect,
                             device=args.device)
    print(json.dumps(line))
    return 0 if line["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
