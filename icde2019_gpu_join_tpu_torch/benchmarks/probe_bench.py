"""Where the banded probe's time goes on the card, and kernels 1 and 3 in
situ and alone.

  steps     the 2^n x 2^n aggregate (uniform PK-FK, payloads 1, the bench's
            workload): `ClusteredJoin.aggregate` best of `reps`; then its
            steps one call at a time, CUDA events between them: both sorts,
            the block windows, the probe (`banded_probe`, its own windows
            included) and, inside the probe, the device time of every
            launch of kernel 1; the best call of `reps` by total. Then the
            materialize descriptors of the same relations (the 2^27 ring
            leg's, `banded_match_descriptors`) with kernel 3's launches;
  cli       the reference's CLI join (`cli -b 7 -a HJC -R 1000000 -S
            16000000`) with kernel 1's launches by (CH, W), and one rank's
            descriptors of the 8-rank materialize leg (2^19 x 2^19 sorted,
            one chunk of 4096 blocks) with kernel 3's;
  isolated  kernels 1 and 3 alone at (CH, W) = (32768, 1), (7812, 1) and
            (4096, 1), every entry point the tree has, 20 calls queued
            behind a device sleep after a warm-up (the mean), beside their
            bounds
            (`utils/timing`'s rates: the bytes each call must move, or its
            compared pairs at 2 and 3 integer operations);
  bench     `benchmarks/bench.run` at 2^n, its line as it is.

Kernels 1 and 3 are timed through whichever wrappers `ops/band_join` calls
(`banded_window_*`, reading their windows; or `banded_compare_*`, on
gathered chunks), so that one copy of this script times a tree of either
kind. Every device time comes from CUDA events; on the CPU the host clock
stands in and the lines say "cpu". One JSON line a measurement, then the
card's name and power limit. A wrong result raises.

Usage: python -m icde2019_gpu_join_tpu_torch.benchmarks.probe_bench
           [steps|cli|isolated|bench|all] [--log2n 27] [--reps 3]
           [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from icde2019_gpu_join_tpu_torch import cli
from icde2019_gpu_join_tpu_torch.benchmarks import bench
from icde2019_gpu_join_tpu_torch.models import ClusteredJoin
from icde2019_gpu_join_tpu_torch.ops import band_compare, band_join
from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32
from icde2019_gpu_join_tpu_torch.relation import Relation
from icde2019_gpu_join_tpu_torch.utils import datasets, timing

SEED = 12345
LANES = 128
# kernels 1 and 3 by their wrappers' names, and the (CH, W) of a call
SHAPE_OF = {
    "banded_window_sum": lambda a: (a[4].numel(), a[8]),
    "banded_window_first": lambda a: (a[2].numel(), a[6]),
    "banded_compare_sum": lambda a: (a[2].shape[0], a[2].shape[1] // LANES),
    "banded_compare_first": lambda a: (a[1].shape[0], a[1].shape[1] // LANES),
}
KERNEL_OPS = {"sum": 2, "first": 3}   # integer operations a compared pair
SHAPES = [(32768, 1), (7812, 1), (4096, 1)]
CLI_ARGS = ["-b", "7", "-a", "HJC", "-R", "1000000", "-S", "16000000"]


class _HostEvent:
    """The host clock where there is no card."""

    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def _event(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return _HostEvent()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def kernel_events(device):
    """While the block runs, every call `band_join` makes to kernels 1 and
    3 is bracketed by two events: yields a list that gets (name, (CH, W),
    start, end) a call. Read the events after a synchronise."""
    calls = []
    real = {name: getattr(band_join, name) for name in SHAPE_OF
            if hasattr(band_join, name)}

    def timed(name):
        def call(*args):
            start, end = _event(device), _event(device)
            start.record()
            out = real[name](*args)
            end.record()
            calls.append((name, SHAPE_OF[name](args), start, end))
            return out
        return call

    for name in real:
        setattr(band_join, name, timed(name))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(band_join, name, fn)


def _summary(calls) -> dict:
    """Per kernel: its launches, their device ms, and per (CH, W) the
    launches and the mean ms a launch."""
    out = {}
    for name, shape, start, end in calls:
        ms = start.elapsed_time(end)
        k = out.setdefault(name, {"launches": 0, "ms": 0.0, "by_shape": {}})
        k["launches"] += 1
        k["ms"] += ms
        s = k["by_shape"].setdefault(str(list(shape)), {"launches": 0,
                                                         "ms": 0.0})
        s["launches"] += 1
        s["ms"] += ms
    for k in out.values():
        for s in k["by_shape"].values():
            s["ms_per_launch"] = s["ms"] / s["launches"]
    return out


def _relations(log2n: int, device):
    n = 1 << log2n
    rk, sk = datasets.make_pk_fk(n, n, seed=SEED)
    ones = np.ones(n, np.int32)
    want = bench.oracle_expect_cached(rk, ones, sk, ones, log2n, 0.0)
    return (Relation.from_numpy(rk, ones, device=device),
            Relation.from_numpy(sk, ones, device=device), want)


def _u32(x: int) -> int:
    return x & 0xFFFFFFFF


def steps(log2n: int, reps: int, device) -> List[dict]:
    r, s, want = _relations(log2n, device)
    engine = ClusteredJoin(device=device)
    w = engine.config.band_window_blocks
    engine.aggregate(r, s)   # warm-up: builds, allocator
    wall = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        got = engine.aggregate(r, s).aggregate   # a host int: synchronised
        wall = min(wall, time.perf_counter() - t0)
        if _u32(got) != _u32(want):
            raise AssertionError(f"aggregate {got} != oracle {want}")

    best = None
    for _ in range(reps):
        ev = [_event(device) for _ in range(4)]
        with kernel_events(device) as calls:
            ev[0].record()
            r_sv, r_p = band_join.sort_by_key(r.keys, r.payload)
            s_sv, s_p = band_join.sort_by_key(s.keys, s.payload)
            ev[1].record()
            band_join.block_windows(r_sv, s_sv)
            ev[2].record()
            agg = band_join.banded_probe(r_sv, r_p, s_sv, s_p, w, "mul")
            ev[3].record()
            _sync(device)
        if _u32(int(agg)) != _u32(want):
            raise AssertionError(f"probe {int(agg)} != oracle {want}")
        run = {"sorts_ms": ev[0].elapsed_time(ev[1]),
               "block_windows_ms": ev[1].elapsed_time(ev[2]),
               "probe_ms": ev[2].elapsed_time(ev[3]),
               "total_ms": ev[0].elapsed_time(ev[3]),
               "kernels": _summary(calls)}
        if best is None or run["total_ms"] < best["total_ms"]:
            best = run
    lines = [{"tool": "probe_bench", "op": "aggregate_steps", "n": 1 << log2n,
              "w": w, "reps": reps, "device": str(device),
              "aggregate_best_ms": wall * 1e3, **best}]

    desc = None
    for _ in range(reps):
        e0, e1 = _event(device), _event(device)
        with kernel_events(device) as calls:
            e0.record()
            h, _fm = band_join.banded_match_descriptors(r_sv, s_sv, w)
            e1.record()
            _sync(device)
        total = int(h[:s.num_rows].long().sum())
        if _u32(total) != _u32(want):   # payloads 1: the match count
            raise AssertionError(f"descriptors count {total} != {want}")
        run = {"descriptors_ms": e0.elapsed_time(e1),
               "kernels": _summary(calls)}
        if desc is None or run["descriptors_ms"] < desc["descriptors_ms"]:
            desc = run
    lines.append({"tool": "probe_bench", "op": "descriptors",
                  "n": 1 << log2n, "w": w, "reps": reps,
                  "device": str(device), **desc})
    return lines


def cli_join(reps: int, device, cli_args=CLI_ARGS, rank_log2n: int = 19
             ) -> List[dict]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), kernel_events(device) as calls:
        rc = cli.main(cli_args, device=device)
        _sync(device)
    if rc != 0:
        raise AssertionError(f"cli {cli_args}: exit {rc}")
    lines = [{"tool": "probe_bench", "op": "cli_join", "argv": cli_args,
              "device": str(device),
              "result": [ln for ln in out.getvalue().splitlines()
                         if ln.endswith(" results")],
              "kernels": _summary(calls)}]

    r, s, want = _relations(rank_log2n, device)
    r_sv, _ = band_join.sort_by_key(r.keys, r.payload)
    s_sv, _ = band_join.sort_by_key(s.keys, s.payload)
    band_join.banded_match_descriptors(r_sv, s_sv, 1)   # warm-up
    best = None
    for _ in range(reps):
        with kernel_events(device) as calls:
            h, _fm = band_join.banded_match_descriptors(r_sv, s_sv, 1)
            _sync(device)
        if _u32(int(h[:s.num_rows].long().sum())) != _u32(want):
            raise AssertionError("rank descriptors: count != oracle")
        run = _summary(calls)
        key = sum(k["ms"] for k in run.values())
        if best is None or key < best[0]:
            best = (key, run)
    lines.append({"tool": "probe_bench", "op": "rank_descriptors",
                  "n": 1 << rank_log2n, "device": str(device),
                  "kernels": best[1]})
    return lines


def _chunk_args(gen, ch: int, w: int, which: str, device):
    """A gathered chunk: keys in [0, 16), full-range payloads or a
    permutation for gidx."""
    ints = lambda hi, shape: torch.randint(0, hi, shape, generator=gen,
                                           dtype=torch.int64).to(torch.int32)
    sk = ints(16, (ch, LANES)).to(device)
    rk = ints(16, (ch, w * LANES)).to(device)
    if which == "sum":
        full = lambda shape: wrap_i32(torch.randint(0, 1 << 32, shape,
                                                    generator=gen)).to(device)
        return (sk, full((ch, LANES)), rk, full((ch, w * LANES)))
    gidx = torch.randperm(ch * w * LANES, generator=gen).to(torch.int32)
    return (sk, rk, gidx.view(ch, w * LANES).to(device))


def _window_args(gen, ch: int, w: int, which: str, device):
    """A round-0 chunk as the probe gives it: CH permuted ids among about
    CH + CH/8 S blocks, windows of W whole blocks along about CH/2 R
    blocks."""
    nsb, nrb = ch + ch // 8 + 1, ch // 2 + w + 1
    ints = lambda hi, shape: torch.randint(0, hi, shape, generator=gen,
                                           dtype=torch.int64).to(torch.int32)
    s_svb, r_svb = ints(16, (nsb, LANES)), ints(16, (nrb, LANES))
    ids = torch.randperm(nsb, generator=gen)[:ch]
    lo = (torch.arange(nsb) * (nrb - w) // nsb).to(torch.int32)
    tail = (ids, lo, lo + w, 0, w)
    if which == "sum":
        full = lambda shape: wrap_i32(torch.randint(0, 1 << 32, shape,
                                                    generator=gen))
        args = (s_svb, full(s_svb.shape), r_svb, full(r_svb.shape), *tail,
                torch.zeros(1, dtype=torch.int32))
    else:
        args = (s_svb, r_svb, *tail, torch.zeros(s_svb.shape, dtype=torch.int32),
                torch.full(s_svb.shape, 0x7FFFFFFF, dtype=torch.int32))
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a
                 for a in args)


HOLD_CYCLES = 20_000_000   # 10 ms of device clock at 2 GHz


def _mean_ms(fn, device, reps: int) -> float:
    """Mean time of one call over `reps` calls queued back to back after a
    warm-up, by two events around them all. On a card, the card sleeps
    HOLD_CYCLES while the host queues the calls, so that a kernel shorter
    than its launch's host work is timed on the card (as `chip_smoke.py`
    times a kernel)."""
    fn()
    _sync(device)
    start, end = _event(device), _event(device)
    if torch.device(device).type == "cuda":
        torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    _sync(device)
    return start.elapsed_time(end) / reps


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def isolated(device, shapes=None, reps: int = 20) -> List[dict]:
    shapes = SHAPES if shapes is None else shapes
    gbps = timing.detect_hbm_gbps(device)
    int_rate = (timing.int_ops_per_s(device)
                if torch.device(device).type == "cuda" else None)
    gen = torch.Generator()
    gen.manual_seed(SEED)
    lines = []
    for name in sorted(SHAPE_OF):
        fn = getattr(band_compare, name, None)
        if fn is None:
            continue
        which = name.rsplit("_", 1)[1]
        windowed = name.startswith("banded_window")
        for ch, w in shapes:
            make = _window_args if windowed else _chunk_args
            args = make(gen, ch, w, which, device)
            ms = _mean_ms(lambda: fn(*args), device, reps)
            pairs = ch * LANES * w * LANES
            if windowed:   # S rows, R rows, ids, lo, hi; outputs in and out
                s_rows = 2 if which == "sum" else 1
                outs = 8 if which == "sum" else 4 * ch * LANES * 4
                nbytes = (ch * (1 + w) * s_rows * LANES * 4 + ch * 16 + outs)
            else:
                out = fn(*args)
                nbytes = _nbytes(*args, *(out if isinstance(out, tuple)
                                          else (out,)))
            by_bytes = nbytes / (gbps * 1e9) * 1e3
            by_ops = (pairs * KERNEL_OPS[which] / int_rate * 1e3
                      if int_rate else None)
            bound = max(by_bytes, by_ops or 0.0)
            lines.append({"tool": "probe_bench", "op": "isolated",
                          "kernel": name, "shape": [ch, w], "ms": ms,
                          "bound_ms": bound if int_rate else None,
                          "bound_by": ("operations" if by_ops and by_ops
                                       >= by_bytes else "bytes"),
                          "device": str(device)})
    return lines


def run(what: str, log2n: int, reps: int, device) -> List[dict]:
    lines = []
    if what in ("steps", "all"):
        lines += steps(log2n, reps, device)
    if what in ("cli", "all"):
        lines += cli_join(reps, device)
    if what in ("isolated", "all"):
        lines += isolated(device)
    if what in ("bench", "all"):
        line = bench.run(scale=log2n, reps=reps, device=device)
        if not line["correct"]:
            raise AssertionError(f"bench: {line}")
        lines.append({"tool": "probe_bench", "op": "bench", **line})
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("what", nargs="?", default="all",
                        choices=("steps", "cli", "isolated", "bench", "all"))
    parser.add_argument("--log2n", type=int, default=27)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    for line in run(args.what, args.log2n, args.reps, args.device):
        print(json.dumps(line), flush=True)
    print(bench.card_line(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
