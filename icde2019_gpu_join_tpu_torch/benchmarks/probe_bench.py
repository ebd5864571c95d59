"""Where the probes' time goes on the card, and kernels 1, 2, 3 and 5 in
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
  per_s     BASELINE.json config 3's per-S probe (2^24 R x 2^29 S, filter
            [100, 600), 64 groups): `filter_probe_groupby` best of `reps`;
            then its steps, CUDA events between them: R's sort, the filter
            and S's sort, the block windows, the probe (`banded_probe_per_s`,
            its own windows included) with every launch of kernel 2; the
            best call by total. h and t are checked against R's payloads by
            key;
  late      the late aggregate at 2^24 per side (4 R + 2 S columns, row-id
            payloads): `ClusteredJoin.late_aggregate` best of `reps`, then
            its steps: the column sums, both sorts, the block windows, the
            probe (`banded_probe(..., "add")`) with kernel 2's launches;
  ranges    kernel 5 alone (its C entry point on items made once:
            `kernel5_launch`) and through its wrapper
            (`probe_aggregate_ranges`, which makes the items on the host and
            uploads them each call), the mean of 10 calls behind a device
            sleep, at the plans of the "pallas" joins of config 1 (2^20 x
            2^24, full-range payloads), config 2 (2^27 x 2^27 at 18 bits)
            and the 2^22 Zipf z=1.05 relations, each join's call best of
            `reps` beside it; and at a plan whose every R tile
            holds one key (2^20 R rows, 2^24 S rows sorted, 16 chunks a
            tile): the table's most skewed build. Each with its work items,
            its rows and its bound (its columns' bytes over the memory
            rate);
  isolated  kernels 1, 2 and 3 alone at (CH, W) = (32768, 1), (7812, 1) and
            (4096, 1), kernel 2 also at (4096, 6) and (125000, 6), every
            entry point the tree has, 20 calls queued
            behind a device sleep after a warm-up (the mean), beside their
            bounds
            (`utils/timing`'s rates: the bytes each call must move, or its
            compared pairs at 2 and 3 integer operations);
  bench     `benchmarks/bench.run` at 2^n, its line as it is.

Kernels 1, 2 and 3 are timed through whichever wrappers `ops/band_join`
calls (`banded_window_*`, reading their windows; or `banded_compare_*`, on
gathered chunks), so that one copy of this script times a tree of either
kind. Every device time comes from CUDA events; on the CPU the host clock
stands in and the lines say "cpu". One JSON line a measurement, then the
card's name and power limit. A wrong result raises.

Usage: python -m icde2019_gpu_join_tpu_torch.benchmarks.probe_bench
           [steps|cli|per_s|late|ranges|isolated|bench|all] [--log2n 27]
           [--reps 3] [--device cpu]
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

from icde2019_gpu_join_tpu_torch import cli, datagen
from icde2019_gpu_join_tpu_torch.benchmarks import bench
from icde2019_gpu_join_tpu_torch.config import EngineConfig, default_bits_for
from icde2019_gpu_join_tpu_torch.models import ClusteredJoin, pipelines
from icde2019_gpu_join_tpu_torch.ops import (_launches, band_compare,
                                             band_join, probe_ranges,
                                             row_colsums)
from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32
from icde2019_gpu_join_tpu_torch.ops.partition import radix_partition
from icde2019_gpu_join_tpu_torch.relation import Relation
from icde2019_gpu_join_tpu_torch.utils import datasets, oracle, timing

SEED = 12345
LANES = 128
# kernels 1, 2 and 3 by their wrappers' names, and the (CH, W) of a call
SHAPE_OF = {
    "banded_window_sum": lambda a: (a[4].numel(), a[8]),
    "banded_window_per_s": lambda a: (a[3].numel(), a[7]),
    "banded_window_first": lambda a: (a[2].numel(), a[6]),
    "banded_compare_sum": lambda a: (a[2].shape[0], a[2].shape[1] // LANES),
    "banded_compare_per_s": lambda a: (a[1].shape[0], a[1].shape[1] // LANES),
    "banded_compare_first": lambda a: (a[1].shape[0], a[1].shape[1] // LANES),
}
# each kernel's function: integer operations a compared pair
KIND = {name: name.split("_", 2)[2] for name in SHAPE_OF}
KERNEL_OPS = {"sum": 2, "per_s": 3, "first": 3}
SHAPES = [(32768, 1), (7812, 1), (4096, 1)]
# kernel 2 also at the extraction's R side: one rank of the 8-rank
# materialize and `cli --materialize`
WIDE_SHAPES = [(4096, 6), (125000, 6)]
# config 3 (BASELINE.json): R rows, S rows, groups, filter [lo, hi)
CONFIG3 = (1 << 24, 1 << 29, 64, 100, 600)
CONFIG1 = (1 << 20, 1 << 24)
CONFIG2_BITS = 18
RANGE_TILE = 1024
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


def _best_call(fn, reps: int):
    """(best wall seconds of `reps` synchronised calls after a warm-up, the
    last result); fn returns a host value or synchronises itself."""
    fn()
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def _best_steps(run, reps: int) -> dict:
    """The run of `reps` (each returns a dict with "total_ms") that took
    least in all."""
    best = None
    for _ in range(reps):
        out = run()
        if best is None or out["total_ms"] < best["total_ms"]:
            best = out
    return best


def per_s_steps(reps: int, device, config3=CONFIG3) -> List[dict]:
    n_r, n_s, groups, lo, hi = config3
    t0 = time.perf_counter()
    cols = [torch.from_numpy(a).to(device)
            for a in datasets.make_config3(n_r, n_s, groups)]
    rk, rp, sk, s_filter, s_gid = cols
    data_s = time.perf_counter() - t0

    def fused():
        out = pipelines.filter_probe_groupby(*cols, lo, hi, groups)
        _sync(device)
        return out
    wall, _ = _best_call(fused, reps)
    keep = (s_filter >= lo) & (s_filter < hi)
    pay_of_key = torch.zeros(n_r, dtype=torch.int64, device=device)
    pay_of_key[rk.long()] = rp.long()   # R keys are a permutation
    want_h = int(keep.sum())
    want_t = int(pay_of_key[sk.long()][keep].sum()) & 0xFFFFFFFF

    def run():
        ev = [_event(device) for _ in range(5)]
        with kernel_events(device) as calls:
            ev[0].record()
            r_sv, r_p = band_join.sort_by_key(rk, rp)
            ev[1].record()
            s_sv, _ = band_join.sort_by_key(
                torch.where(keep, sk, pipelines._FILTERED_KEY), s_gid)
            ev[2].record()
            band_join.block_windows(r_sv, s_sv)
            ev[3].record()
            h, t = band_join.banded_probe_per_s(r_sv, r_p, s_sv, 1)
            ev[4].record()
            _sync(device)
        got = (int(h[:n_s].long().sum()), int(t[:n_s].long().sum()) & 0xFFFFFFFF)
        if got != (want_h, want_t):
            raise AssertionError(f"config 3 per-S probe (h, t) sums {got}, "
                                 f"want {(want_h, want_t)}")
        return {"sort_r_ms": ev[0].elapsed_time(ev[1]),
                "filter_sort_s_ms": ev[1].elapsed_time(ev[2]),
                "block_windows_ms": ev[2].elapsed_time(ev[3]),
                "probe_ms": ev[3].elapsed_time(ev[4]),
                "total_ms": ev[0].elapsed_time(ev[4]),
                "kernels": _summary(calls)}
    return [{"tool": "probe_bench", "op": "per_s_steps", "n_r": n_r,
             "n_s": n_s, "reps": reps, "device": str(device),
             "data_s": data_s, "pipeline_best_ms": wall * 1e3,
             **_best_steps(run, reps)}]


def late_steps(log2n: int, reps: int, device) -> List[dict]:
    n = 1 << log2n
    rk, sk = datasets.make_pk_fk(n, n, seed=SEED)
    rs = np.random.RandomState(SEED + 2)
    r_cols = rs.randint(-2**31, 2**31, (n, 4), dtype=np.int64).astype(np.int32)
    s_cols = rs.randint(-2**31, 2**31, (n, 2), dtype=np.int64).astype(np.int32)
    ids = np.arange(n, dtype=np.int32)
    want = oracle.join_late_materialize_sum(rk, ids, sk, ids, r_cols, s_cols)
    r = Relation.from_numpy(rk, device=device)   # payloads: row ids
    s = Relation.from_numpy(sk, device=device)
    rc, sc = (torch.from_numpy(c).to(device) for c in (r_cols, s_cols))
    engine = ClusteredJoin(device=device)
    w = engine.config.band_window_blocks
    wall, got = _best_call(
        lambda: engine.late_aggregate(r, s, rc, sc).aggregate, reps)
    if _u32(got) != _u32(want):
        raise AssertionError(f"late aggregate {got} != oracle {want}")

    def run():
        ev = [_event(device) for _ in range(5)]
        with kernel_events(device) as calls:
            ev[0].record()
            r_c = row_colsums.row_colsums(rc, r.payload)
            s_c = row_colsums.row_colsums(sc, s.payload)
            ev[1].record()
            r_sv, r_p = band_join.sort_by_key(r.keys, r_c)
            s_sv, s_p = band_join.sort_by_key(s.keys, s_c)
            ev[2].record()
            band_join.block_windows(r_sv, s_sv)
            ev[3].record()
            agg = band_join.banded_probe(r_sv, r_p, s_sv, s_p, w, "add")
            ev[4].record()
            _sync(device)
        if _u32(int(agg)) != _u32(want):
            raise AssertionError(f"late probe {int(agg)} != oracle {want}")
        return {"colsums_ms": ev[0].elapsed_time(ev[1]),
                "sorts_ms": ev[1].elapsed_time(ev[2]),
                "block_windows_ms": ev[2].elapsed_time(ev[3]),
                "probe_ms": ev[3].elapsed_time(ev[4]),
                "total_ms": ev[0].elapsed_time(ev[4]),
                "kernels": _summary(calls)}
    return [{"tool": "probe_bench", "op": "late_steps", "n": n, "w": w,
             "reps": reps, "device": str(device),
             "late_aggregate_best_ms": wall * 1e3, **_best_steps(run, reps)}]


def _full_np(rs, n: int) -> np.ndarray:
    return rs.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)


def _range_plan(r: Relation, s: Relation, bits: int):
    """Both sides partitioned, padded to RANGE_TILE, and the range plan."""
    pr = radix_partition(r.keys, r.payload, bits)
    ps = radix_partition(s.keys, s.payload, bits)
    s_start, s_nch = probe_ranges.plan_ranges(
        pr.offsets.cpu().numpy(), ps.offsets.cpu().numpy(), r.num_rows,
        RANGE_TILE, RANGE_TILE)
    cols = (*probe_ranges.pad_for_probe(pr.keys, pr.payload, RANGE_TILE),
            *probe_ranges.pad_for_probe(ps.keys, ps.payload, RANGE_TILE))
    return cols, s_start, s_nch


def _one_key_plan(device, n_r: int = 1 << 20, n_s: int = 1 << 24):
    """Every R tile one key (tile t holds key t), S sorted over those keys:
    (cols, s_start, s_nch, the sum mod 2^32)."""
    rs = np.random.RandomState(SEED + 5)
    tiles = n_r // RANGE_TILE
    rk = np.repeat(np.arange(tiles, dtype=np.int32), RANGE_TILE)
    sk = np.sort(rs.randint(0, tiles, n_s)).astype(np.int32)
    rp, sp = _full_np(rs, n_r), _full_np(rs, n_s)
    first = np.searchsorted(sk, np.arange(tiles), side="left")
    end = np.searchsorted(sk, np.arange(tiles), side="right")
    s_start = (first // RANGE_TILE * RANGE_TILE).astype(np.int32)
    s_nch = (-(-(end - s_start) // RANGE_TILE)).astype(np.int32)
    r_sum = np.bincount(rk, rp.astype(np.int64) & 0xFFFFFFFF, tiles)
    s_sum = np.bincount(sk, sp.astype(np.int64) & 0xFFFFFFFF, tiles)
    want = sum((int(a) & 0xFFFFFFFF) * (int(b) & 0xFFFFFFFF)
               for a, b in zip(r_sum.astype(np.int64), s_sum.astype(np.int64)))
    cols = tuple(torch.from_numpy(a).to(device) for a in (rk, rp, sk, sp))
    return cols, s_start, s_nch, want & 0xFFFFFFFF


def kernel5_launch(cols, s_start, s_nch, tile_r: int = RANGE_TILE,
                   tile_s: int = RANGE_TILE):
    """A function that launches kernel 5 once on `cols` and the plan, with
    the wrapper's host work (`_items` and the items' upload) done once,
    here: it calls the C entry point, whose signature every version of the
    kernel keeps, and returns its accumulator (which adds up over calls).
    On the CPU, the wrapper (its plain version)."""
    if not cols[0].is_cuda:
        return lambda: probe_ranges.probe_aggregate_ranges(
            *cols, s_start, s_nch, tile_r=tile_r, tile_s=tile_s)
    dev = cols[0].device
    tile, s0 = probe_ranges._items(s_start, s_nch, cols[2].shape[0], tile_s)
    tile_d, s0_d = (torch.from_numpy(a).to(dev) for a in (tile, s0))
    out = torch.zeros(1, dtype=torch.int32, device=dev)

    def launch():
        _launches.launch(None, "probe_aggregate_ranges",
                         (*cols, tile_d, s0_d, out), tile.size, tile_r, tile_s,
                         stream=torch.cuda.current_stream(dev).cuda_stream)
        return out
    return launch


def ranges(reps: int, device, config1=CONFIG1, zipf_log2n: int = 22,
           config2_log2n: int = 27, one_key=(1 << 20, 1 << 24)) -> List[dict]:
    gbps = timing.detect_hbm_gbps(device)
    lines = []

    def kernel_line(name, cols, s_start, s_nch, want, **extra):
        fn = lambda: probe_ranges.probe_aggregate_ranges(
            *cols, s_start, s_nch, tile_r=RANGE_TILE, tile_s=RANGE_TILE)
        got = int(fn())
        if _u32(got) != _u32(want):
            raise AssertionError(f"kernel 5 at {name}: {got} != {want}")
        tile, _ = probe_ranges._items(s_start, s_nch, cols[2].shape[0],
                                      RANGE_TILE)
        nbytes = sum(c.numel() * 4 for c in cols) + 4
        lines.append({"tool": "probe_bench", "op": "ranges", "plan": name,
                      "items": int(tile.size),
                      "rows": int(np.unique(tile).size * RANGE_TILE
                                  + tile.size * RANGE_TILE),
                      "max_chunks": int(s_nch.max()),
                      "kernel_ms": timing.queued_ms(
                          kernel5_launch(cols, s_start, s_nch), device, 10),
                      "wrapper_ms": timing.queued_ms(fn, device, 10),
                      "bound_ms": nbytes / (gbps * 1e9) * 1e3,
                      "bound_by": "bytes", "device": str(device), **extra})

    rs = np.random.RandomState(SEED + 3)
    rk, sk = datasets.make_pk_fk(*config1, seed=SEED)
    c1 = (rk, _full_np(rs, rk.size), sk, _full_np(rs, sk.size))
    nz = 1 << zipf_log2n
    zk_r, zk_s = datasets.make_pk_fk(nz, nz, skew=1.05, seed=SEED)
    zipf = (zk_r, _full_np(rs, zk_r.size), zk_s, _full_np(rs, zk_s.size))
    n2 = 1 << config2_log2n
    k2_r, k2_s = datasets.make_pk_fk(n2, n2, seed=SEED)
    ones = np.ones(n2, np.int32)
    want2 = bench.oracle_expect_cached(k2_r, ones, k2_s, ones, config2_log2n,
                                       0.0)
    for name, tables, want, bits in (
            ("config 1", c1, None, None),
            (f"zipf 1.05 2^{zipf_log2n}", zipf, None, None),
            ("config 2", (k2_r, ones, k2_s, ones), want2, CONFIG2_BITS)):
        if want is None:
            want = datagen.oracle_join_aggregate(*tables)
        r = Relation.from_numpy(tables[0], tables[1], device=device)
        s = Relation.from_numpy(tables[2], tables[3], device=device)
        cfg = EngineConfig(probe_mode="pallas")
        if bits is None:
            bits = default_bits_for(max(r.num_rows, s.num_rows),
                                    cfg.probe_tile_r)
        engine = ClusteredJoin(cfg.with_bits(bits), device=device)
        wall, got = _best_call(lambda: engine.aggregate(r, s).aggregate, reps)
        if _u32(got) != _u32(want):
            raise AssertionError(f"pallas {name}: {got} != oracle {want}")
        kernel_line(name, *_range_plan(r, s, bits), want, bits=bits,
                    join_best_ms=wall * 1e3)
        del r, s
    del k2_r, k2_s, ones
    cols, s_start, s_nch, want = _one_key_plan(device, *one_key)
    kernel_line("one key a tile", cols, s_start, s_nch, want)
    return lines


def _chunk_args(gen, ch: int, w: int, which: str, device):
    """A gathered chunk: keys in [0, 16), full-range payloads or a
    permutation for gidx."""
    ints = lambda hi, shape: torch.randint(0, hi, shape, generator=gen,
                                           dtype=torch.int64).to(torch.int32)
    full = lambda shape: wrap_i32(torch.randint(0, 1 << 32, shape,
                                                generator=gen)).to(device)
    sk = ints(16, (ch, LANES)).to(device)
    rk = ints(16, (ch, w * LANES)).to(device)
    if which == "sum":
        return (sk, full((ch, LANES)), rk, full((ch, w * LANES)))
    if which == "per_s":
        return (sk, rk, full((ch, w * LANES)))
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
    full = lambda shape: wrap_i32(torch.randint(0, 1 << 32, shape,
                                                generator=gen))
    if which == "sum":
        args = (s_svb, full(s_svb.shape), r_svb, full(r_svb.shape), *tail,
                torch.zeros(1, dtype=torch.int32))
    elif which == "per_s":
        args = (s_svb, r_svb, full(r_svb.shape), *tail,
                torch.zeros(s_svb.shape, dtype=torch.int32),
                torch.zeros(s_svb.shape, dtype=torch.int32))
    else:
        args = (s_svb, r_svb, *tail, torch.zeros(s_svb.shape, dtype=torch.int32),
                torch.full(s_svb.shape, 0x7FFFFFFF, dtype=torch.int32))
    return tuple(a.to(device) if isinstance(a, torch.Tensor) else a
                 for a in args)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def isolated(device, shapes=None, reps: int = 20) -> List[dict]:
    """Each entry point at `shapes`, or by default at SHAPES and kernel 2's
    also at WIDE_SHAPES."""
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
        which = KIND[name]
        windowed = name.startswith("banded_window")
        at = shapes
        if at is None:
            at = SHAPES + (WIDE_SHAPES if which == "per_s" else [])
        for ch, w in at:
            make = _window_args if windowed else _chunk_args
            args = make(gen, ch, w, which, device)
            ms = timing.queued_ms(lambda: fn(*args), device, reps)
            pairs = ch * LANES * w * LANES
            if windowed:   # S rows, R rows, ids, lo, hi; outputs in and out
                s_rows = 2 if which == "sum" else 1
                r_rows = 1 if which == "first" else 2
                outs = 8 if which == "sum" else 4 * ch * LANES * 4
                nbytes = ((ch * s_rows + ch * w * r_rows) * LANES * 4
                          + ch * 16 + outs)
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
    if what in ("per_s", "all"):
        lines += per_s_steps(reps, device)
    if what in ("late", "all"):
        lines += late_steps(24, reps, device)
    if what in ("ranges", "all"):
        lines += ranges(reps, device)
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
                        choices=("steps", "cli", "per_s", "late", "ranges",
                                 "isolated", "bench", "all"))
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
