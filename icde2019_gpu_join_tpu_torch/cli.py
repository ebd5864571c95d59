"""CLI mirroring the reference benchmark binary, on the card.

Reference: ./bench -b 7 -a HJC -S <n> -R <n> [-s skew] [--non-unique]
[--full-range] [-x/-y multipliers] [-k/-l filenames] [--file]
(parseInputArgs, src/main.cu:434-557; dispatch :264-301). Port of
`icde2019_gpu_join_tpu/cli.py`: the same flags, datasets and printed lines
(the result count and per-phase throughput), plus --json, whose report
also holds the timed call's counts (`JoinResult.counts`).

Usage: python -m icde2019_gpu_join_tpu_torch.cli -b 7 -a HJC -R 1000000 -S 16000000
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from icde2019_gpu_join_tpu_torch import datagen
from icde2019_gpu_join_tpu_torch.models.joins import (clustered_probe_join,
                                                      dispatch_regime)
from icde2019_gpu_join_tpu_torch.relation import Relation
from icde2019_gpu_join_tpu_torch.utils import datasets


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu-join-torch", description=__doc__)
    p.add_argument("-b", "--benchmark", type=int, default=7,
                   help="benchmark id (7 = device join, 8 = CPU oracle join)")
    p.add_argument("-a", "--alg", default="HJC",
                   help="join algorithm (HJC = hash join clustered probe)")
    p.add_argument("-R", "--RelsNum", type=int, default=1 << 20)
    p.add_argument("-S", "--SelsNum", type=int, default=1 << 24)
    p.add_argument("-s", "--skew", type=float, default=0.0)
    # accepted for the reference CLI's sake (main.cu:445-455), ignored: they
    # tune the reference's thread counts, shared memory and pivots
    ignored = " (accepted for reference-CLI compatibility; ignored)"
    p.add_argument("-t", "--threadsNum", type=int, default=0,
                   help="CUDA/OpenMP threads" + ignored)
    p.add_argument("-v", "--values", type=int, default=2,
                   help="values per tuple" + ignored)
    p.add_argument("-m", "--memory", type=int, default=30 << 10,
                   help="shared memory bytes" + ignored)
    p.add_argument("-p", "--pivotsNum", type=int, default=1,
                   help="pivot count" + ignored)
    p.add_argument("-w", "--OneToMany", type=int, default=0,
                   help="one-to-many flag" + ignored)
    p.add_argument("-x", "--XSelsMultiplier", type=int, default=1)
    p.add_argument("-y", "--YRelsMultiplier", type=int, default=1)
    p.add_argument("-k", "--R_filename", default=None)
    p.add_argument("-l", "--S_filename", default=None)
    p.add_argument("--file", action="store_true", dest="fileInput")
    p.add_argument("--non-unique", action="store_false", dest="uniqueKeys")
    p.add_argument("--full-range", action="store_true", dest="fullRange")
    p.add_argument("--seed", type=int, default=12345)
    p.add_argument("--json", action="store_true", help="structured output")
    p.add_argument("--materialize", action="store_true")
    return p


def create_datasets(args) -> tuple:
    """Reference dataset matrix (main.cu:186-262)."""
    n_r, n_s = args.RelsNum, args.SelsNum
    if args.fileInput:
        rk = datasets.read_bin(args.R_filename, n_r)
        sk = datasets.read_bin(args.S_filename, n_s)
        if rk is None or sk is None:
            sys.exit("could not read input .bin files")
        return rk, sk
    if args.fullRange:
        rk = datasets.create_relation_nonunique(
            datasets.pk_filename(n_r), n_r, 2**31 - 1, args.seed)
        sk = datasets.create_relation_fk_from_pk(n_s, rk, args.seed)
        return rk, sk
    if args.uniqueKeys:
        # -x/-y: the base relation tiled (main.cu:103-105, 212, 245)
        xm, ym = max(args.XSelsMultiplier, 1), max(args.YRelsMultiplier, 1)
        if args.skew > 0:
            rk = datasets.create_relation_unique(n_r, n_r, args.seed)
            sk = datasets.create_relation_zipf(n_s, n_r, args.skew, args.seed)
        else:
            rk, sk = datasets.make_pk_fk(n_r, n_s, 0.0, args.seed)
        if ym > 1:
            rk = datasets.create_relation_n(rk, ym)
        if xm > 1:
            sk = datasets.create_relation_n(sk, xm)
        return rk, sk
    rk = datasets.create_relation_nonunique(
        datasets.nonunique_filename("R", n_r), n_r, max(n_r // 2, 1), args.seed)
    sk = datasets.create_relation_nonunique(
        datasets.nonunique_filename("S", n_s), n_s, max(n_r // 2, 1), args.seed)
    return rk, sk


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)
    if args.benchmark not in (7, 8):
        sys.exit("only -b 7 (device join) and -b 8 (CPU oracle) are implemented")

    print(f"INPUT: option = {args.benchmark}\tjoinAlg = {args.alg}\t"
          f"||S|| = {args.SelsNum}\t||R|| = {args.RelsNum}\t"
          f"skew = {args.skew:.6f}")
    rk, sk = create_datasets(args)
    n_r, n_s = rk.shape[0], sk.shape[0]
    rp = np.ones(n_r, np.int32)
    sp = np.ones(n_s, np.int32)

    if args.benchmark == 8:
        # the CPU oracle join (compiled but never called by the reference,
        # hash_join_clustered_probe.cu:2025-2059): the C++ host engine
        t0 = time.perf_counter()
        agg = datagen.host_oracle_aggregate(rk, rp, sk, sp)
        dt = time.perf_counter() - t0
        print(f"{agg} results")
        print(f"CPU join total throughput is {2*(n_r+n_s)*4/dt/1e6:.2f} MB/s")
        return 0

    # In memory, both relations go to the card before the warm-up, so the
    # timed call holds no upload (the reference also runs Join1 twice,
    # hash_join_clustered_probe.cu:802-994). The streamed and co-processed
    # regimes read them from host memory and move them themselves, in one
    # run.
    in_memory = dispatch_regime(n_r, n_s) == "join1"
    home = device if in_memory else "cpu"
    r = Relation.from_numpy(rk, rp, device=home)
    s = Relation.from_numpy(sk, sp, device=home)
    if in_memory:
        clustered_probe_join(r, s, materialize=args.materialize, device=device)
    t0 = time.perf_counter()
    res = clustered_probe_join(r, s, materialize=args.materialize,
                               device=device)
    dt = time.perf_counter() - t0

    tp = res.timer
    t_part = tp.seconds("partition") or tp.seconds("partition_build")
    t_join = tp.seconds("join") or tp.seconds("segment")
    mbps = lambda t: 2.0 * (n_r + n_s) * 4.0 / t / 1e6 if t else float("inf")
    result = res.aggregate if res.aggregate is not None else res.count
    print(f"{result} results")
    print(f"Partition throughput is {mbps(t_part):.2f} MB/s")
    print(f"Join throughput is {mbps(t_join):.2f} MB/s")
    print(f"Total throughput is {mbps(dt):.2f} MB/s")
    if args.json:
        # the timed call's counters (`JoinResult.counts`) beside its phases
        print(json.dumps(tp.report({"result": result, "elapsed_s": dt,
                                    "counts": res.counts})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
