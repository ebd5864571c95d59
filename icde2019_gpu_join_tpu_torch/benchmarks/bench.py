"""The headline benchmark on the card: one JSON line.

Counterpart of the repository's `bench.py`. The workload is the same:
`ClusteredJoin.aggregate` on a 2^BENCH_SCALE x 2^BENCH_SCALE PK-FK join
(BASELINE.json config 2), payloads 1, generator_ETHZ datasets, inputs on
the card before the clock starts; one warm-up, then the best of
BENCH_REPS calls. The result must equal the C++ host oracle, read from
`data/oracle_agg_pkfk_s{scale}_z{skew}_seed12345_g{generator}.json` where
that is checked in, else computed and cached there.

Keys: metric (`join_throughput_{R}Mx{S}M[_zipf{z}]`), value (Mrows/s), unit,
correct, aggregate, elapsed_s, phases, sort_impl, and device (the card's
name and power limit as `nvidia-smi` gives them). `bench.py`'s shares of a
speed-of-light model (vs_baseline, vs_sort_frontier, vs_scatter_sol,
hbm_gbps) are left out: their rates are a TPU's.

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
from icde2019_gpu_join_tpu_torch.relation import Relation
from icde2019_gpu_join_tpu_torch.utils import datasets

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA_DIR = os.path.join(REPO, "data")
SEED = 12345


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

    expect = oracle_expect_cached(rk, rp, sk, sp, scale, skew,
                                  cache_dir=cache_dir)
    return {
        "metric": f"join_throughput_{n_r >> 20}Mx{n_s >> 20}M"
                  + (f"_zipf{skew}" if skew else ""),
        "value": (n_r + n_s) / elapsed / 1e6,
        "unit": "Mrows/s",
        "correct": res.aggregate == expect,
        "aggregate": res.aggregate,
        "elapsed_s": elapsed,
        "phases": {p.name: p.seconds for p in res.timer.phases},
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
