"""The headline benchmark on the card: one JSON line.

Counterpart of the repository's `bench.py`. The workload is the same:
`ClusteredJoin.aggregate` on a 2^BENCH_SCALE x 2^BENCH_SCALE PK-FK join
(BASELINE.json config 2), payloads 1, generator_ETHZ datasets, inputs on
the card before the clock starts; one warm-up, then the best of
BENCH_REPS calls. The result must equal the C++ host oracle, read from
`data/oracle_agg_pkfk_s{scale}_z{skew}_seed12345_g{generator}.json` where
that is checked in, else computed and cached there.

Keys: `bench.py`'s (metric, value in Mrows/s, unit, vs_baseline,
vs_sort_frontier, vs_scatter_sol, sol_model, correct, aggregate,
elapsed_s, phases, hbm_gbps, sort_impl, device: the card's name and power
limit as `nvidia-smi` gives them), and sort_frontier_rows_s.

The shares are the time of a speed-of-light model over the measured
elapsed time, with the card's own rates (`utils/timing`): its data-sheet
memory rate BW (`detect_hbm_gbps`) and its integer rate (`int_ops_per_s`),
read after the timed calls:

  sort SOL per side = 4 passes x 16 B/row / BW
  probe SOL         = max(16 B/row x (|R| + |S|) / BW,
                          256 ops x |S| / integer rate)
  vs_baseline       = (sort SOL(R) + sort SOL(S) + probe SOL) / elapsed

The sort's 4 passes of 16 B a row are `bench.py`'s bytes term, and what an
LSD radix pair sort with 8-bit digits moves. `bench.py` also bounds each
sort by a bitonic compare network (0.5 lg (lg + 1) stages x 6 ops a row),
because a TPU has no scatter and sorts by comparing; a card scatters, and
`torch.sort` is a radix sort there, so that term is dropped: with the
card's integer rate it is 18.2 ms a side at 2^27, and the share would read
above 1. The probe's 256 ops a row are 128 window slots at 2 ops each, the
banded kernel's count. vs_sort_frontier is both sides at the sort rate
measured in the same run (one sort of 2^scale (sort value, payload) pairs
by the engine's "lax" sort, `radix_sort_pairs`, best of 3 by CUDA events)
plus the probe SOL. vs_scatter_sol is the reference's radix-hash-join bound, 40 B a
row over BW: on a card that scatters it is a real bound. On the CPU there
is no card to take rates from: the shares and the sort rate are null, and
hbm_gbps is the CPU's 50.0.

Env knobs: BENCH_SCALE (default 27), BENCH_SKEW (Zipf z, default 0),
BENCH_REPS (default 3), TPUJOIN_SORT_IMPL ("lax", "merge" or "packed";
default "lax"), passed to the engine as `EngineConfig.sort_impl`.

    python -m icde2019_gpu_join_tpu_torch.benchmarks.bench
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from icde2019_gpu_join_tpu_torch import datagen
from icde2019_gpu_join_tpu_torch.config import EngineConfig
from icde2019_gpu_join_tpu_torch.models.joins import ClusteredJoin
from icde2019_gpu_join_tpu_torch.ops.radix_pairs import radix_sort_pairs
from icde2019_gpu_join_tpu_torch.relation import Relation
from icde2019_gpu_join_tpu_torch.utils import datasets
from icde2019_gpu_join_tpu_torch.utils.timing import (best_ms, detect_hbm_gbps,
                                                      int_ops_per_s)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA_DIR = os.path.join(REPO, "data")
SEED = 12345
SORT_PASSES = 4
SORT_BYTES_PER_ROW = 16
PROBE_BYTES_PER_ROW = 16
PROBE_OPS_PER_S_ROW = 256     # 128 window slots x 2 ops (compare, add)
SCATTER_BYTES_PER_ROW = 40
SHARES = ("vs_baseline", "vs_sort_frontier", "vs_scatter_sol")
SOL_MODEL = ("sort 4 passes x 16 B/row / BW a side; probe max(16 B/row "
             "x (|R|+|S|) / BW, 256 ops x |S| / int rate); frontier: both "
             "sides at the measured sort rate + probe; scatter: 40 B/row / "
             "BW; BW and int rate the card's")


def card_line(device) -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card for a
    CUDA device; "cpu" for the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def generator_tag() -> str:
    """Which generator made the datasets: the oracle caches are keyed by it."""
    return "native" if datagen.native_lib() is not None else "numpy"


def oracle_expect_cached(rk, rp, sk, sp, scale: int, skew: float,
                         seed: int = SEED,
                         cache_dir: Optional[str] = None) -> int:
    """Host-oracle SUM(Pr*Ps) of a `make_pk_fk` dataset, cached in
    `cache_dir` (default the repository's `data/`) under `bench.py`'s name,
    keyed by (scale, skew, seed) and the generator."""
    cache_dir = cache_dir or DATA_DIR
    os.makedirs(cache_dir, exist_ok=True)
    gen = generator_tag()
    path = os.path.join(
        cache_dir, f"oracle_agg_pkfk_s{scale}_z{skew}_seed{seed}_g{gen}.json")
    if os.path.exists(path):
        with open(path) as f:
            return int(json.load(f)["aggregate"])
    agg = datagen.host_oracle_aggregate(rk, rp, sk, sp)
    with open(path, "w") as f:
        json.dump({"aggregate": agg, "n_r": int(rk.size), "n_s": int(sk.size),
                   "skew": skew, "seed": seed, "generator": gen}, f)
    return agg


def sort_sol_s(n: int, hbm_gbps: float) -> float:
    """One side's sort at its speed of light: SORT_PASSES passes of
    SORT_BYTES_PER_ROW a row over the memory rate."""
    return SORT_PASSES * SORT_BYTES_PER_ROW * n / (hbm_gbps * 1e9)


def probe_sol_s(n_r: int, n_s: int, hbm_gbps: float,
                int_ops: float) -> float:
    """The banded probe at its speed of light: both sides read once, or
    PROBE_OPS_PER_S_ROW operations an S row, whichever takes longer."""
    return max(PROBE_BYTES_PER_ROW * (n_r + n_s) / (hbm_gbps * 1e9),
               PROBE_OPS_PER_S_ROW * n_s / int_ops)


def shares(n_r: int, n_s: int, elapsed: float, hbm_gbps: float,
           int_ops: float, sort_rows_s: float) -> dict:
    """`bench.py`'s three shares of the speed-of-light model (module
    docstring), from the card's memory rate, integer rate and measured sort
    rate."""
    probe = probe_sol_s(n_r, n_s, hbm_gbps, int_ops)
    t_sol = sort_sol_s(n_r, hbm_gbps) + sort_sol_s(n_s, hbm_gbps) + probe
    t_frontier = (n_r + n_s) / sort_rows_s + probe
    t_scatter = SCATTER_BYTES_PER_ROW * (n_r + n_s) / (hbm_gbps * 1e9)
    return dict(zip(SHARES, (t_sol / elapsed, t_frontier / elapsed,
                             t_scatter / elapsed)))


def sort_frontier_rows_s(keys: torch.Tensor, pays: torch.Tensor) -> float:
    """Rows a second of the engine's "lax" sort on the card, the radix pair
    sort of the keys as sort values and their payloads, best of 3 by CUDA
    events."""
    ms = best_ms(lambda: radix_sort_pairs(keys, pays), keys.device, reps=3)
    return keys.shape[0] / ms * 1e3


def card_rates(device, keys: torch.Tensor, pays: torch.Tensor) -> dict:
    """The model's rates on `device`: its memory rate and, on a card, its
    integer rate and the "lax" sort's rate on (keys, pays); those two are
    None on the CPU."""
    rates = {"hbm_gbps": detect_hbm_gbps(device), "int_ops": None,
             "sort_rows_s": None}
    if torch.device(device).type == "cuda":
        rates["int_ops"] = int_ops_per_s(device)
        rates["sort_rows_s"] = sort_frontier_rows_s(keys, pays)
    return rates


def run(scale: int = 27, skew: float = 0.0, reps: int = 3,
        sort_impl: str = "lax", device="cuda",
        cache_dir: Optional[str] = None) -> dict:
    """The benchmark's line as a dict."""
    n_r = n_s = 1 << scale
    rk, sk = datasets.make_pk_fk(n_r, n_s, skew=skew, seed=SEED)
    rp = np.ones(n_r, np.int32)
    sp = np.ones(n_s, np.int32)
    r = Relation.from_numpy(rk, rp, device=device)
    s = Relation.from_numpy(sk, sp, device=device)
    engine = ClusteredJoin(EngineConfig(sort_impl=sort_impl), device=device)

    res = engine.aggregate(r, s)   # warm-up: kernel builds, allocator
    elapsed = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        res = engine.aggregate(r, s)   # returns a host int: synchronised
        elapsed = min(elapsed, time.perf_counter() - t0)

    rates = card_rates(device, s.keys, s.payload)   # after the timed calls
    share = dict.fromkeys(SHARES)
    if rates["int_ops"] is not None:
        share = shares(n_r, n_s, elapsed, **rates)
    expect = oracle_expect_cached(rk, rp, sk, sp, scale, skew,
                                  cache_dir=cache_dir)
    return {
        "metric": f"join_throughput_{n_r >> 20}Mx{n_s >> 20}M"
                  + (f"_zipf{skew}" if skew else ""),
        "value": (n_r + n_s) / elapsed / 1e6,
        "unit": "Mrows/s",
        **share,
        "sol_model": SOL_MODEL,
        "correct": res.aggregate == expect,
        "aggregate": res.aggregate,
        "elapsed_s": elapsed,
        "phases": {p.name: p.seconds for p in res.timer.phases},
        "hbm_gbps": rates["hbm_gbps"],
        "sort_frontier_rows_s": rates["sort_rows_s"],
        "sort_impl": sort_impl,
        "device": card_line(device),
    }


def main() -> int:
    line = run(scale=int(os.environ.get("BENCH_SCALE", "27")),
               skew=float(os.environ.get("BENCH_SKEW", "0")),
               reps=int(os.environ.get("BENCH_REPS", "3")),
               sort_impl=os.environ.get("TPUJOIN_SORT_IMPL", "lax"))
    print(json.dumps(line))
    return 0 if line["correct"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
