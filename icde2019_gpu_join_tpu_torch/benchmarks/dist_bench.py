"""Where the time of the distributed layer's calls goes.

Three legs, each checked against its oracle (the C++ aggregate oracle, the
numpy materialize oracle) and timed as best of 3 after a warm-up, by the
host clock to a synchronised end:

  scaling      the segmented join (4 segments) in thread worlds of 1, 2, 4
               and 8 ranks at 2^log2-rank rows a rank a side, full-range
               payloads (the 8-rank world is `chip_smoke.py`'s); a call of
               the 8-rank world that runs one all-gather of one value a rank
               (the world's floor); and the device's busy share of one more
               8-rank segmented call under `torch.profiler`;
  materialize  the 8-rank materializing join into twice its pairs a rank (as
               `dryrun_multichip` sizes it), as `banded_materialize` routes
               it and with its slot path forced, timed in the order routed,
               slot, slot, routed; both equal to the oracle as multisets,
               with the launches of the extraction kernel (the routed
               path's on the card) in each and
               the device's busy time of one more call of each under
               `torch.profiler`;
  process      a 1-rank `torch.distributed` world (NCCL on the card, gloo on
               the CPU, over a `file://` store) at 2^log2-process rows a side,
               payloads 1: the segmented join under `torch.profiler`, with
               the host time and the device range of the "plan", "exchange"
               and "probe" spans of `parallel/dist_join.py`, and the
               device's busy share.

The busy share is the device time of the call's kernels, copies and sets
over its wall time (span annotations left out). The profiler records the
host spans of the thread that starts it only, so the thread world shows its
busy share alone. On the CPU (`--device cpu`) there is no device time.

Usage: python -m icde2019_gpu_join_tpu_torch.benchmarks.dist_bench
           [scaling] [materialize] [process] (default: all three)
           [--log2-rank 19] [--log2-process 24] [--device cpu]
Prints one JSON line; exits 1 if a result is not its oracle's.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from icde2019_gpu_join_tpu_torch import datagen
from icde2019_gpu_join_tpu_torch.ops import band_join, extract_pairs
from icde2019_gpu_join_tpu_torch.parallel import dist_join
from icde2019_gpu_join_tpu_torch.parallel.mesh import group_mesh, make_mesh
from icde2019_gpu_join_tpu_torch.utils import datasets, oracle

SEED = 12345
RANKS = 8


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _best_ms(fn, device, reps: int = 3):
    """(best wall ms of `reps` synchronised calls after a warm-up, the last
    result)."""
    out = fn()
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best, out


def _device_ms(event, self_only=False) -> float:
    """A profiler average's device time in ms (the attribute's name moved
    between torch versions)."""
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for name in names:
        if hasattr(event, name):
            return getattr(event, name) / 1e3
    return 0.0


def _profiled(fn, device) -> dict:
    """One call under `torch.profiler`: its wall ms, the device's busy ms
    and, per span of `dist_join` on this thread, [host ms, device ms,
    count]."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    busy, spans = 0.0, {}
    for e in prof.key_averages():
        on_device = e.device_type == cuda
        if e.key.startswith("dist_join."):
            host, dev, count = spans.get(e.key[len("dist_join."):],
                                         (0.0, 0.0, 0))
            spans[e.key[len("dist_join."):]] = (
                (host, dev + _device_ms(e), count) if on_device
                else (host + e.cpu_time_total / 1e3, dev, e.count))
        elif on_device:
            busy += _device_ms(e, self_only=True)
    return {"wall_ms": wall, "busy_ms": busy, "busy_share": busy / wall,
            "spans": {k: list(v) for k, v in sorted(spans.items())}}


def _relations(n: int):
    """2^k PK-FK keys a side (seed 12345) with full-range payloads, as
    `chip_smoke.py`'s thread world makes them."""
    rk, sk = datasets.make_pk_fk(n, n, seed=SEED)
    rng = np.random.RandomState(SEED + 9)
    rp = rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    sp = rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    return rk, rp, sk, sp


def scaling_leg(rows_per_rank: int, device) -> dict:
    rk, rp, sk, sp = _relations(rows_per_rank * RANKS)
    r, p_r, s, p_s = (torch.from_numpy(a).to(device) for a in (rk, rp, sk, sp))
    out = {"rows_per_rank": rows_per_rank, "segmented_ms": {}, "correct": True}
    for ranks in (1, 2, 4, RANKS):
        m = rows_per_rank * ranks
        mesh = make_mesh(ranks, device=device)
        want = datagen.oracle_join_aggregate(rk[:m], rp[:m], sk[:m], sp[:m])
        call = functools.partial(dist_join.distributed_join_segmented,
                                 r[:m], p_r[:m], s[:m], p_s[:m], mesh,
                                 num_segments=4)
        ms, (agg, ov) = _best_ms(call, device)
        out["correct"] &= int(agg) == want and int(ov) == 0
        out["segmented_ms"][ranks] = ms
    one = torch.ones(RANKS, dtype=torch.int32, device=device)
    out["all_gather_call_ms"], _ = _best_ms(
        lambda: mesh.run(lambda c, v: c["x"].all_gather(v), one), device)
    out["profiled"] = _profiled(call, device)
    return out


def materialize_leg(rows_per_rank: int, device) -> dict:
    rk, rp, sk, sp = _relations(rows_per_rank * RANKS)
    pairs = oracle.join_materialize(rk, rp, sk, sp)
    cap = max(128, -(-2 * max(pairs.shape[0], 1) // 128) * 128)
    r, p_r, s, p_s = (torch.from_numpy(a).to(device) for a in (rk, rp, sk, sp))
    mesh = make_mesh(RANKS, device=device)
    call = functools.partial(dist_join.distributed_join_materialize,
                             r, p_r, s, p_s, mesh, capacity_per_chip=cap)
    routed = dist_join.banded_materialize
    slot = functools.partial(band_join.banded_materialize, debug_force="slow")

    def equal(res) -> bool:
        out_r, out_s, totals, ov = res
        totals = totals.cpu().numpy()
        out_r, out_s = out_r.cpu().numpy(), out_s.cpu().numpy()
        got = np.concatenate([np.stack([out_r[d * cap:d * cap + t],
                                        out_s[d * cap:d * cap + t]], axis=1)
                              for d, t in enumerate(totals)])
        return int(ov) == 0 and np.array_equal(
            got[np.lexsort((got[:, 1], got[:, 0]))], pairs)

    times = {"routed": [], "slot": []}
    busy = {"routed": [], "slot": []}
    # the extraction kernel runs on the card's routed path only
    extracts = {"routed": 0, "slot": 0}
    correct = True
    for path in ("routed", "slot", "slot", "routed"):
        dist_join.banded_materialize = routed if path == "routed" else slot
        before = extract_pairs.LAUNCHES["extract_pairs"]
        try:
            ms, res = _best_ms(call, device)
            busy[path].append(_profiled(call, device)["busy_ms"])
        finally:
            dist_join.banded_materialize = routed
        extracts[path] += extract_pairs.LAUNCHES["extract_pairs"] - before
        correct &= equal(res)
        times[path].append(ms)
    return {"pairs": int(pairs.shape[0]), "capacity_per_chip": cap,
            "routed_ms": times["routed"], "slot_ms": times["slot"],
            "routed_busy_ms": busy["routed"], "slot_busy_ms": busy["slot"],
            "extract_launches": extracts, "correct": bool(correct)}


def process_leg(rows: int, device) -> dict:
    rk, sk = datasets.make_pk_fk(rows, rows, seed=SEED)
    ones = np.ones(rows, np.int32)
    want = datagen.oracle_join_aggregate(rk, ones, sk, ones)
    cuda = torch.device(device).type == "cuda"
    store = tempfile.mkdtemp(prefix="dist_bench_")
    if cuda:
        torch.cuda.set_device(torch.device(device).index or 0)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{os.path.join(store, 'store')}",
                            rank=0, world_size=1)
    try:
        comm = group_mesh().comm("x")
        one = torch.ones(rows, dtype=torch.int32, device=device)
        r, s = (torch.from_numpy(a).to(device) for a in (rk, sk))
        call = functools.partial(dist_join.distributed_join_segmented_local,
                                 r, one, s, one, comm, num_segments=4)
        ms, (agg, ov) = _best_ms(call, device)
        prof = _profiled(call, device)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return {"backend": "nccl" if cuda else "gloo", "rows": rows,
            "segmented_ms": ms, "profiled": prof,
            "correct": int(agg) == want and int(ov) == 0}


LEGS = {"scaling": scaling_leg, "materialize": materialize_leg,
        "process": process_leg}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--log2-rank", type=int, default=19)
    parser.add_argument("--log2-process", type=int, default=24)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("legs", nargs="*", default=list(LEGS))
    args = parser.parse_args(argv)
    unknown = set(args.legs) - set(LEGS)
    if unknown:
        parser.error(f"unknown legs {sorted(unknown)}; the legs are {list(LEGS)}")
    log2 = {"scaling": args.log2_rank, "materialize": args.log2_rank,
            "process": args.log2_process}
    line = {leg: LEGS[leg](1 << log2[leg], args.device) for leg in args.legs}
    if torch.device(args.device).type == "cuda":
        line["device"] = torch.cuda.get_device_name()
    print(json.dumps(line))
    return 0 if all(leg["correct"] for leg in line.values()
                    if isinstance(leg, dict)) else 1


if __name__ == "__main__":
    sys.exit(main())
