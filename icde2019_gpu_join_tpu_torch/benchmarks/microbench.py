"""Rates of the primitives a partition or sort design is built from.

Counterpart of `benchmarks/microbench.py`: the same primitives, keys and
seeds (`RandomState(0)`, keys in [0, 2^30), a random permutation, partition
ids = keys & (2^13 - 1)), each with that script's byte count for its
GB/s-effective, so that the figures compare:

  sort3 / sort2      a stable `torch.sort` of the first column + a gather of
                     the other 2 / 1 int32 columns (JAX sorts the operands
                     together); 12 / 8 B a row, read and written. The int64
                     index array the sort writes and the gathers read is
                     not counted, and the line says so;
  take               a gather by the permutation (8 B a row);
  scatter_set        zeros, then a scatter by the permutation (8 B a row);
  hist_bincount_8k / _32   `torch.bincount` over 2^13 / 32 bins (4 B a row;
                     every input lies below the bin count, so the output
                     has exactly that length, as `jnp.bincount(length=)`);
  hist_onehot_256    a one-hot histogram over 256 bins, contracted in
                     float32 with TF32 off, in batches of ONEHOT_BATCH rows
                     (exact counts; 4 B a row);
  searchsorted_8k    2^13 + 1 probes into the sorted partition ids (4 B a
                     row);
  argsort            `torch.argsort` of the keys (8 B a row; the int64
                     output's extra 4 B not counted);
  hist_cumsum        an int32 cumsum down a [n / 8192, 8192] matrix (8 B an
                     element);
  copy               a device-to-device copy of the keys (8 B a row, read
                     and written): the measured counterpart of
                     `utils/timing.detect_hbm_gbps`, and its share of it.

Each is timed by `utils/timing.best_ms` (CUDA events after a warm-up, best
of 5). One JSON line a primitive, then the card's name and power limit.

Usage: python -m icde2019_gpu_join_tpu_torch.benchmarks.microbench
           [log2_n] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch

from icde2019_gpu_join_tpu_torch.benchmarks.bench import card_line
from icde2019_gpu_join_tpu_torch.ops.groupby import _ieee_fp32_matmul
from icde2019_gpu_join_tpu_torch.utils.timing import best_ms, detect_hbm_gbps

PARTS = 1 << 13
ONEHOT_BINS = 256
ONEHOT_BATCH = (1 << 25) // ONEHOT_BINS   # rows: 2^25 one-hot elements a batch
CUMSUM_COLS = 8192
SORT_INDICES = "int64 sort indices (n x 8 B written, read by the gathers)"


def onehot_hist(pid: torch.Tensor, batch: int = ONEHOT_BATCH) -> torch.Tensor:
    """[ONEHOT_BINS] int64 counts of pid & 255: a batch's one-hot rows
    contracted with a ones vector in float32 (exact: fewer than 2^24 rows a
    batch), summed over batches in int64."""
    iota = torch.arange(ONEHOT_BINS, dtype=pid.dtype, device=pid.device)
    ones = torch.ones(min(batch, pid.shape[0]), dtype=torch.float32,
                      device=pid.device)
    counts = torch.zeros(ONEHOT_BINS, dtype=torch.int64, device=pid.device)
    with _ieee_fp32_matmul():
        for lo in range(0, pid.shape[0], batch):
            oh = ((pid[lo:lo + batch] & 255)[:, None] == iota).to(torch.float32)
            counts += (ones[:oh.shape[0]] @ oh).to(torch.int64)
    return counts


def run(lg: int = 24, device="cuda") -> List[dict]:
    """One line a primitive, printed as it is measured."""
    n = 1 << lg
    rng = np.random.RandomState(0)
    keys = torch.from_numpy(rng.randint(0, 1 << 30, n, dtype=np.int32)).to(device)
    pay = torch.arange(n, dtype=torch.int32, device=device)
    perm = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(device)
    pid = keys & (PARTS - 1)
    pid_sorted = torch.sort(pid).values
    probes = torch.arange(PARTS + 1, dtype=torch.int32, device=device)
    hists = torch.ones((n // CUMSUM_COLS, CUMSUM_COLS), dtype=torch.int32,
                       device=device)
    low5 = keys & 31
    copy_out = torch.empty_like(keys)

    def sort3():
        p, idx = torch.sort(pid, stable=True)
        return p, keys[idx], pay[idx]

    def sort2():
        k, idx = torch.sort(keys, stable=True)
        return k, pay[idx]

    cases = [
        ("sort3", sort3, n * 12 * 2, {"uncounted": SORT_INDICES}),
        ("sort2", sort2, n * 8 * 2, {"uncounted": SORT_INDICES}),
        ("take", lambda: torch.index_select(keys, 0, perm), n * 8, {}),
        ("scatter_set",
         lambda: torch.zeros_like(keys).index_put_((perm,), keys), n * 8, {}),
        ("hist_bincount_8k", lambda: torch.bincount(pid, minlength=PARTS),
         n * 4, {}),
        ("hist_bincount_32", lambda: torch.bincount(low5, minlength=32),
         n * 4, {}),
        ("hist_onehot_256", lambda: onehot_hist(pid), n * 4,
         {"batch_rows": ONEHOT_BATCH}),
        ("searchsorted_8k", lambda: torch.searchsorted(pid_sorted, probes),
         n * 4, {}),
        ("argsort", lambda: torch.argsort(keys), n * 8,
         {"uncounted": "int64 output (n x 4 B beyond JAX's int32)"}),
        ("hist_cumsum", lambda: torch.cumsum(hists, 0, dtype=torch.int32),
         hists.numel() * 8, {}),
        ("copy", lambda: copy_out.copy_(keys), n * 8, {}),
    ]
    lines = []
    for op, fn, nbytes, extra in cases:
        ms = best_ms(fn, device)
        line = {"tool": "microbench", "op": op, "n": n, "ms": ms,
                "bytes": nbytes, "gbps_effective": nbytes / ms / 1e6, **extra}
        if op == "copy":
            line["hbm_gbps"] = detect_hbm_gbps(device)
            line["of_hbm"] = line["gbps_effective"] / line["hbm_gbps"]
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("log2n", nargs="?", type=int, default=24)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(args.log2n, args.device)
    print(card_line(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
