"""Compute the oracle values that `run_configs` gates on, before a chip run.

Counterpart of the repository's `benchmarks/precache_oracles.py`. At the
--full sizes (2^29 group-by, 2^30 Zipf, 2^31 streaming) each gate costs
minutes of host time; this script builds the exact datasets the
configurations build and fills `data/oracle_*.json` under the same keys
(a tag and a fingerprint of the datasets' content, so a changed recipe is
a cache miss, never a wrong gate), so that a run on the card only measures.
numpy and the C++ host engine only; no device is touched.

    python -m icde2019_gpu_join_tpu_torch.benchmarks.precache_oracles [--full]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

from icde2019_gpu_join_tpu_torch.benchmarks import run_configs as rc
from icde2019_gpu_join_tpu_torch.utils import datasets


def log(msg):
    print(f"[precache {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def c3(scale: int, n_r: int = 1 << 24, cache_dir: Optional[str] = None):
    log(f"c3 s{scale}: dataset")
    cols = datasets.make_config3(n_r, 1 << scale, rc.C3_GROUPS, seed=rc.C3_SEED)
    log(f"c3 s{scale}: oracle")
    rc._oracle_groupby_cached(f"c3_s{scale}_seed{rc.C3_SEED}", *cols,
                              rc.C3_LO, rc.C3_HI, rc.C3_GROUPS, cache_dir)
    log(f"c3 s{scale}: done")


def c4(scale: int, cache_dir: Optional[str] = None):
    n = 1 << scale
    log(f"c4 s{scale}: dataset (zipf 1.05)")
    rk, sk = datasets.make_pk_fk(n, n, skew=1.05, seed=rc.SEED)
    log(f"c4 s{scale}: oracle")
    rc._oracle_agg_cached(f"c4_pkfk_s{scale}_z1.05_seed{rc.SEED}", rk, sk,
                          cache_dir)
    log(f"c4 s{scale}: done")


def c6(scale_s: int, cache_dir: Optional[str] = None):
    n_r, n_s = min(1 << 29, 1 << (scale_s - 2)), 1 << scale_s
    log(f"c6 s{scale_s}: dataset")
    rk, sk = datasets.make_pk_fk(n_r, n_s, seed=rc.SEED)
    log(f"c6 s{scale_s}: oracle")
    rc._oracle_agg_cached(f"c6_r{n_r}_s{n_s}_seed{rc.SEED}", rk, sk, cache_dir)
    log(f"c6 s{scale_s}: done")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    # small to large, so that a partial run still helps
    c3(26)
    c4(26)
    c6(26)
    if args.full:
        c3(29)
        c4(30)
        c6(31)
    log("ALL DONE")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
