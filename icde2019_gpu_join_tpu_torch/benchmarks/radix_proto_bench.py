"""The radix-grouping prototype against a flat sort.

Counterpart of `benchmarks/radix_proto_bench.py`, the measurement behind
the JAX package's "radix vs sort" decision, on the card: a flat unstable
`torch.sort` of (key, payload) + the payload gather; the port's
`ops/partition_radix.radix_group` at (bits, chunk) = (3, 4096) and
(5, 16384); `radix_sort_via_grouping` at (5, 4096) and (5, 16384). Keys
from `RandomState(0)` in [0, 2^31), payloads the row ids.

`radix_group` groups by a sort of each chunk along dim 1 and a block
gather, so this measures grouping by sort, as the port does it; a grouping
by scatter is not here. Each call is timed by `utils/timing.best_ms` (CUDA
events after a warm-up, best of 5) and checked once: its output holds the
input's (key, payload) pairs as a multiset, plus (0x7FFFFFFF, 0) sentinel
rows, with every input row counted and, for the sort, every key row in
order and no partition over its frame. One JSON line a call, then the
card's name and power limit; exit 1 if a check fails.

Usage: python -m icde2019_gpu_join_tpu_torch.benchmarks.radix_proto_bench
           [log2_n] [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from typing import List, Optional

import numpy as np
import torch

from icde2019_gpu_join_tpu_torch.benchmarks.bench import card_line
from icde2019_gpu_join_tpu_torch.ops.partition_radix import (
    _SENT, radix_group, radix_sort_via_grouping)
from icde2019_gpu_join_tpu_torch.utils.timing import best_ms

GROUPS = [(3, 4096), (5, 16384)]   # radix_group (bits, chunk)
SORTS = [(5, 4096), (5, 16384)]    # radix_sort_via_grouping (bits, chunk)


def flat_sort(k: torch.Tensor, v: torch.Tensor):
    ks, idx = torch.sort(k)
    return ks, v[idx]


def _words(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sorted (key, payload) pairs as int64 words."""
    return torch.sort((k.reshape(-1).long() << 32)
                      | (v.reshape(-1).long() & 0xFFFFFFFF)).values


def same_rows(k, v, out_k, out_v) -> bool:
    """out holds the rows (k, v) and only sentinel rows besides."""
    pad = out_k.numel() - k.numel()
    if pad < 0:
        return False
    return torch.equal(
        _words(out_k, out_v),
        _words(torch.cat([k, k.new_full((pad,), _SENT)]),
               torch.cat([v, v.new_zeros(pad)])))


def run(lg: int = 24, device="cuda") -> List[dict]:
    """One line a call, printed as it is measured."""
    n = 1 << lg
    rng = np.random.RandomState(0)
    k = torch.from_numpy(rng.randint(0, 1 << 31, n, dtype=np.int32)).to(device)
    v = torch.arange(n, dtype=torch.int32, device=device)

    calls = [("flat_sort", None, None, flat_sort)]
    calls += [("radix_group", b, c, functools.partial(radix_group, bits=b,
                                                      chunk=c))
              for b, c in GROUPS]
    calls += [("radix_sort_via_grouping", b, c,
               functools.partial(radix_sort_via_grouping, bits=b, chunk=c))
              for b, c in SORTS]
    lines = []
    for op, bits, chunk, fn in calls:
        out = fn(k, v)
        if op == "flat_sort":
            ok = bool((out[0][1:] >= out[0][:-1]).all()) and same_rows(k, v, *out)
        elif op == "radix_group":
            ok = int(out.counts.sum()) == n and same_rows(k, v, out.keys,
                                                          out.pays)
        else:
            ks, vs, valid, overflow = out
            ok = (int(valid) == n and int(overflow) == 0
                  and bool((ks[:, 1:] >= ks[:, :-1]).all())
                  and same_rows(k, v, ks, vs))
        ms = best_ms(lambda: fn(k, v), device)
        line = {"tool": "radix_proto_bench", "op": op, "bits": bits,
                "chunk": chunk, "n": n, "ms": ms, "mrows_s": n / ms / 1e3,
                "ok": ok}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("log2n", nargs="?", type=int, default=24)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    lines = run(args.log2n, args.device)
    print(card_line(args.device))
    return 0 if all(line["ok"] for line in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
