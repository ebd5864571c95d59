"""Segmented-sort geometry and redistribution primitives on the card.

Counterpart of `benchmarks/sortgeom_bench.py`, whose numbers place the
segment length of a segmented sort. Modes:

  flat    an unstable 2-column sort of n rows (`torch.sort` + gather);
  seg     the same along dim 1 of [n / L, L], L = 2^10 .. 2^22 below n;
  seg3    a 3-column sort (one key, two gathered columns) at L = 2^10, 2^12;
  gather  a 2-column gather of 128-row blocks by a random permutation;
  hist    a one-hot histogram over P = 32 in rows of 1024;
  all     each of them.

Keys from `RandomState(0)` in [0, 2^30), payloads the row ids, drawn in the
JAX script's order. Every timed function ends in its order-dependent
reduction (`order_dep`: a strided sample of (31 k) ^ v summed mod 2^32), so
that the value depends on the order the call produced; it equals the JAX
script's bit for bit: int32 sums promote to int64 in torch, so it reduces
in int64 and wraps to int32. Each is timed by `utils/timing.best_ms` (CUDA
events after a warm-up, best of 6), with no round-trip subtraction. One
JSON line a measurement, then the card's name and power limit.

Usage: python -m icde2019_gpu_join_tpu_torch.benchmarks.sortgeom_bench
           [mode] [log2_n] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch

from icde2019_gpu_join_tpu_torch.benchmarks.bench import card_line
from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32
from icde2019_gpu_join_tpu_torch.utils.timing import best_ms

MODES = ("flat", "seg", "seg3", "gather", "hist", "all")
SEG_LOG2 = (10, 12, 14, 16, 18, 20, 22)
SEG3_LOG2 = (10, 12)
BLOCK = 128
HIST_P = 32
HIST_ROW = 1024
REPS = 6


def order_dep(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """int32 sum of (31 k) ^ v over every stride-th row, wrapping mod 2^32."""
    kf = k.reshape(-1)
    vf = v.reshape(-1)
    stride = max(1, kf.shape[0] // 4096)
    return wrap_i32(((kf[::stride].long() * 31) ^ vf[::stride].long()).sum())


def sort2(k: torch.Tensor, v: torch.Tensor, dim: int) -> torch.Tensor:
    ks, idx = torch.sort(k, dim=dim)
    return order_dep(ks, torch.gather(v, dim, idx))


def sort3(k: torch.Tensor, i: torch.Tensor, v: torch.Tensor,
          dim: int) -> torch.Tensor:
    ks, idx = torch.sort(k, dim=dim)
    return (order_dep(ks, torch.gather(v, dim, idx))
            ^ order_dep(ks, torch.gather(i, dim, idx)))


def gather2(kb: torch.Tensor, vb: torch.Tensor,
            bidx: torch.Tensor) -> torch.Tensor:
    return order_dep(torch.index_select(kb, 0, bidx),
                     torch.index_select(vb, 0, bidx))


def hist32(pid: torch.Tensor) -> torch.Tensor:
    """Per-row one-hot counts over HIST_P partitions, weighted by p + 1 and
    summed mod 2^32."""
    iota = torch.arange(HIST_P, dtype=pid.dtype, device=pid.device)
    hh = (pid[..., None] == iota).sum(1)                  # [rows, P] int64
    return wrap_i32((hh * (iota.long() + 1)).sum())


def run(mode: str = "all", lg: int = 24, device="cuda") -> List[dict]:
    """One line a measurement, printed as it is measured."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    n = 1 << lg
    rng = np.random.RandomState(0)
    keys0 = torch.from_numpy(rng.randint(0, 1 << 30, n, dtype=np.int32)).to(device)
    pay0 = torch.arange(n, dtype=torch.int32, device=device)
    lines = []

    def report(op, fn, shape, rows=n, nbytes=None):
        ms = best_ms(fn, device, reps=REPS)
        line = {"tool": "sortgeom_bench", "op": op, "shape": list(shape),
                "n": n, "ms": ms, "mrows_s": rows / ms / 1e3,
                "check": int(fn())}
        if nbytes is not None:
            line["gbps_moved"] = nbytes / ms / 1e6
        print(json.dumps(line), flush=True)
        lines.append(line)

    if mode in ("flat", "all"):
        report("flat sort2 unstable", lambda: sort2(keys0, pay0, 0), [n])
    if mode in ("seg", "all"):
        for lgL in SEG_LOG2:
            if lgL >= lg:
                break
            k, v = keys0.view(-1, 1 << lgL), pay0.view(-1, 1 << lgL)
            report("seg sort2", lambda: sort2(k, v, 1), k.shape)
    if mode in ("seg3", "all"):
        for lgL in SEG3_LOG2:
            if lgL >= lg:
                break
            idx = torch.from_numpy(
                rng.randint(0, 1 << 30, n, dtype=np.int32)).to(device)
            k, i, v = (x.view(-1, 1 << lgL) for x in (keys0, idx, pay0))
            report("seg sort3", lambda: sort3(k, i, v, 1), k.shape)
    if mode in ("gather", "all"):
        nb = n // BLOCK
        bidx = torch.from_numpy(rng.permutation(nb).astype(np.int32)).to(device)
        kb, vb = keys0.view(nb, BLOCK), pay0.view(nb, BLOCK)
        report("block gather 2col", lambda: gather2(kb, vb, bidx), kb.shape,
               nbytes=n * 8)
    if mode in ("hist", "all"):
        pid = (keys0 & (HIST_P - 1)).view(-1, HIST_ROW)
        report("onehot hist P=32", lambda: hist32(pid), pid.shape)
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("mode", nargs="?", default="all", choices=MODES)
    parser.add_argument("log2n", nargs="?", type=int, default=24)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(args.mode, args.log2n, args.device)
    print(card_line(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
