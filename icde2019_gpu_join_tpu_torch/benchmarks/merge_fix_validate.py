"""Validation of the merge cascade on the card.

Counterpart of `benchmarks/merge_fix_validate.py`. It runs no kernel of its
own: `merge_sort_pairs` goes through the in-block merge kernel and the
merge-path kernel (`ops/merge.py`). Two steps, one JSON line each:

  1. correctness: `merge_sort_pairs` at 2^log2n against `torch.sort` +
     gather on the same device: the sorted keys equal, the (key, payload)
     multiset equal. Keys lie in (INT32_MIN, INT32_MAX), so that no sort
     value is a masking sentinel and the cascade runs, not the fallback;
  2. timing: the best of 5 calls of both after a warm-up, by CUDA events on
     the card (`utils/timing.best_ms`). The cascade's time there is its
     kernels': the base-run sort, one in-block launch and two launches (plan
     and merge) a merge-path level, with one host read before them, the
     sentinel check.

Usage: python -m icde2019_gpu_join_tpu_torch.benchmarks.merge_fix_validate
           [log2n] [--device cpu]
Exits 1 if the keys or the pairs differ.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from icde2019_gpu_join_tpu_torch.ops import merge
from icde2019_gpu_join_tpu_torch.ops.radix_pairs import torch_sort_pairs
from icde2019_gpu_join_tpu_torch.utils.timing import best_ms


def _words(sv: torch.Tensor, pv: torch.Tensor) -> torch.Tensor:
    """(key, payload) pairs as sortable int64 words."""
    return torch.sort((sv.long() << 32) | (pv.long() & 0xFFFFFFFF)).values


def validate(lg: int, device="cuda") -> Tuple[dict, Optional[dict]]:
    """The correctness line and, if it holds, the timing line."""
    n = 1 << lg
    on_card = torch.device(device).type == "cuda"
    rng = np.random.RandomState(7)
    sv = torch.from_numpy(rng.randint(-(2**31) + 1, 2**31 - 1, n,
                                      dtype=np.int64).astype(np.int32)).to(device)
    pv = torch.from_numpy(rng.randint(-(2**31), 2**31, n,
                                      dtype=np.int64).astype(np.int32)).to(device)

    routes = dict(merge.ROUTES)
    t0 = time.perf_counter()
    gs, gp = merge.merge_sort_pairs(sv, pv)
    if on_card:
        torch.cuda.synchronize(device)
    t_first = time.perf_counter() - t0
    took_cascade = merge.ROUTES["cascade"] == routes["cascade"] + 1

    es, ep = torch_sort_pairs(sv, pv)
    keys_ok = bool(torch.equal(gs, es))
    pairs_ok = bool(torch.equal(_words(gs, gp), _words(es, ep)))
    check = {"check": "merge_fix_correct", "n": n, "keys_ok": keys_ok,
             "pairs_ok": pairs_ok, "cascade": took_cascade,
             "build_plus_first_run_s": t_first}
    print(json.dumps(check), flush=True)
    if not (keys_ok and pairs_ok):
        return check, None

    t_merge = best_ms(lambda: merge.merge_sort_pairs(sv, pv), device)
    t_lax = best_ms(lambda: torch_sort_pairs(sv, pv), device)
    speed = {"check": "merge_fix_speed", "n": n,
             "merge_ms": t_merge, "lax_ms": t_lax,
             "merge_Mrows_s": n / t_merge / 1e3,
             "lax_Mrows_s": n / t_lax / 1e3,
             "speedup_vs_lax": t_lax / t_merge}
    print(json.dumps(speed), flush=True)
    return check, speed


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("log2n", nargs="?", type=int, default=18)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    check, _ = validate(args.log2n, args.device)
    return 0 if check["keys_ok"] and check["pairs_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
