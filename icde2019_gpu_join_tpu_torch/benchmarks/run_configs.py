"""The six BASELINE.json configurations end to end on the card.

Counterpart of the repository's `benchmarks/run_configs.py`, with the same
configurations, default sizes, flags and report keys. Each configuration
prints one JSON line a leg: {config, metric, rows, seconds, mrows_s,
correct, ...}; `seconds` is the wall time of one call after a warm-up
(configs 4 at 2^28 rows and more, and 6, are timed on their one call, as
there).

  1  1M x 16M uniform PK-FK, `ClusteredJoin.aggregate`, against
     `oracle.join_count`;
  2  2^27 x 2^27 uniform PK-FK with payloads: the aggregate, then the
     materializing join into a 2^24 ring (its total mod 2^32);
  3  filter -> probe -> group-by, 2^24 R x 2^26 S (2^29 with --full), 64
     groups: fused where it fits the card, else streamed in a number of
     segments that divides S;
  4  Zipf z = 1.05, 2^26 a side (2^30 with --full): in memory below 2^28
     rows, co-processed from host memory from there;
  5  the distributed join: on one card, three legs of config 5 in a 1-rank
     NCCL world and `dryrun_multichip(8)` in a thread world on the card; on
     several cards, one NCCL process a card;
  6  the streamed probe, R = min(2^29, S / 4) on the card, S = 2^26 (2^31
     with --full) in host memory.

Configurations 2 and 5 are held against the C++ host oracle (the checked-in
`data/oracle_agg_pkfk_*` value where the dataset has one), not against
`sort_merge_aggregate` as the repository's script holds them: that shares
the sort under test. Oracle values are cached in `data/` under the
repository script's names (`_cache_path`: a tag and a fingerprint of the
datasets' content), so both packages read each other's caches.

    python -m icde2019_gpu_join_tpu_torch.benchmarks.run_configs [--configs 1,2,3,4,5[,6]] [--full]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from icde2019_gpu_join_tpu_torch import datagen
from icde2019_gpu_join_tpu_torch.benchmarks.bench import (DATA_DIR, REPO, SEED,
                                                          generator_tag,
                                                          oracle_expect_cached)
from icde2019_gpu_join_tpu_torch.config import EngineConfig
from icde2019_gpu_join_tpu_torch.models import pipelines
from icde2019_gpu_join_tpu_torch.models.joins import (ClusteredJoin,
                                                      clustered_probe_join)
from icde2019_gpu_join_tpu_torch.models.streaming import streaming_join_aggregate
from icde2019_gpu_join_tpu_torch.ops import _build
from icde2019_gpu_join_tpu_torch.parallel import dist_join
from icde2019_gpu_join_tpu_torch.parallel.dryrun import dryrun_multichip
from icde2019_gpu_join_tpu_torch.parallel.mesh import group_mesh
from icde2019_gpu_join_tpu_torch.relation import Relation
from icde2019_gpu_join_tpu_torch.utils import datasets, oracle

C3_GROUPS, C3_LO, C3_HI, C3_SEED = 64, 100, 600, 42
C3_SEGMENT_ROWS = 1 << 27     # the most S rows a streamed segment holds
# device bytes the fused config-3 pipeline holds at its peak, per row
C3_FUSED_BYTES_PER_S_ROW = 64
C3_FUSED_BYTES_PER_R_ROW = 32
C4_COPROCESS_SCALE = 28      # from 2^28 rows a side config 4 co-processes
C5_ZIPF_SEED = 777
RANK_TIMEOUT_S = 1800


def _report(config, metric, rows, seconds, correct, extra=None) -> dict:
    out = {
        "config": config,
        "metric": metric,
        "rows": rows,
        "seconds": seconds,
        "mrows_s": rows / seconds / 1e6 if seconds else None,
        "correct": bool(correct),
    }
    if extra:
        out.update(extra)
    print(json.dumps(out), flush=True)
    return out


def _fingerprint(*arrays):
    """Content fingerprint of the gate's input datasets: sha256 over each
    array's size, full-content uint64 sum, and head/middle/tail row
    samples; byte for byte those of `benchmarks/run_configs.py`, so that
    its caches and these share keys."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.asarray(a)
        h.update(np.int64(a.size).tobytes())
        h.update(np.uint64(a.astype(np.uint64, copy=False).sum()
                           if a.size else 0).tobytes())
        h.update(a[:4096].tobytes())
        h.update(a[a.size // 2: a.size // 2 + 4096].tobytes())
        h.update(a[-4096:].tobytes())
    return h.hexdigest()[:12]


def _cache_path(tag, fp, cache_dir: Optional[str] = None):
    d = cache_dir or DATA_DIR
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"oracle_{tag}_g{generator_tag()}_{fp}.json")


def _oracle_agg_cached(tag, rk, sk, cache_dir: Optional[str] = None) -> int:
    """Cached host-oracle SUM(1*1) (= match count mod 2^32) of a
    ones-payload join, keyed by tag + dataset-content fingerprint."""
    path = _cache_path(tag, _fingerprint(rk, sk), cache_dir)
    if os.path.exists(path):
        with open(path) as f:
            return int(json.load(f)["aggregate"])
    agg = datagen.host_oracle_aggregate(
        rk, np.ones(rk.size, np.int32), sk, np.ones(sk.size, np.int32))
    with open(path, "w") as f:
        json.dump({"aggregate": int(agg), "n_r": int(rk.size),
                   "n_s": int(sk.size)}, f)
    return int(agg)


def _oracle_groupby_cached(tag, rk, rp, sk, s_filter, s_gid, lo, hi, groups,
                           cache_dir: Optional[str] = None):
    """Cached numpy filter -> probe -> group-by oracle (config 3's gate),
    keyed by tag + content fingerprint of every input column."""
    path = _cache_path(tag, _fingerprint(rk, rp, sk, s_filter, s_gid),
                       cache_dir)
    if os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        return (np.asarray(rec["counts"], np.int64),
                np.asarray(rec["sums"], np.int64))
    ec, es = oracle.filter_probe_groupby(rk, rp, sk, s_filter, s_gid,
                                         lo, hi, groups)
    with open(path, "w") as f:
        json.dump({"counts": np.asarray(ec).tolist(),
                   "sums": np.asarray(es).tolist()}, f)
    return np.asarray(ec), np.asarray(es)


def _u32(x: int) -> int:
    return int(x) & 0xFFFFFFFF


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    """(wall seconds of one call, synchronised, its result)."""
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return time.perf_counter() - t0, out


def _warm_timed(fn, device):
    """One warm-up call, then the wall time of one call and its result."""
    fn()
    _sync(device)
    return _timed(fn, device)


def _ones_relations(rk, sk, device):
    return (Relation.from_numpy(rk, np.ones(rk.size, np.int32), device=device),
            Relation.from_numpy(sk, np.ones(sk.size, np.int32), device=device))


def config1(device="cuda", n_r: int = 1 << 20, n_s: int = 1 << 24) -> dict:
    """1M x 16M uniform PK-FK, single pass, payloads 1."""
    rk, sk = datasets.make_pk_fk(n_r, n_s, 0.0, SEED)
    r, s = _ones_relations(rk, sk, device)
    eng = ClusteredJoin(device=device)
    dt, res = _warm_timed(lambda: eng.aggregate(r, s), device)
    return _report(1, f"pkfk_{n_r >> 20}Mx{n_s >> 20}M", n_r + n_s, dt,
                   res.aggregate == oracle.join_count(rk, sk))


def config2(scale: int = 27, device="cuda", cache_dir: Optional[str] = None,
            ring: int = 1 << 24) -> List[dict]:
    """2^scale x 2^scale uniform with payloads (the bench's workload), then
    the materializing leg: the reference's Join1 measures both probes, the
    materializing one into the 2^24-slot FOLD ring
    (src/hash_join_clustered_probe.cu:913-916, 937-940)."""
    n = 1 << scale
    rk, sk = datasets.make_pk_fk(n, n, 0.0, SEED)
    r, s = _ones_relations(rk, sk, device)
    ones = np.ones(n, np.int32)
    expect = oracle_expect_cached(rk, ones, sk, ones, scale, 0.0,
                                  cache_dir=cache_dir)
    eng = ClusteredJoin(device=device)
    dt, res = _warm_timed(lambda: eng.aggregate(r, s), device)
    out = [_report(2, f"uniform_{n >> 20}Mx{n >> 20}M_payload", 2 * n, dt,
                   _u32(res.aggregate) == _u32(expect))]
    # the total match count mod 2^32 equals the aggregate (payloads 1); the
    # ring's content is held against numpy by chip_smoke's materialize phase
    dt, resm = _warm_timed(lambda: eng.materialize(r, s, capacity=ring), device)
    out.append(_report(
        2, f"materialize_{n >> 20}Mx{n >> 20}M_fold{ring.bit_length() - 1}",
        2 * n, dt, _u32(resm.count) == _u32(expect),
        {"ring_slots": ring, "matches_mod32": _u32(resm.count)}))
    return out


def config3_segments(n_s: int, fused_fits: bool) -> int:
    """1 where the fused pipeline fits the device, else the least number of
    segments of at most C3_SEGMENT_ROWS rows that divides n_s (the n_s >> 27
    of `benchmarks/run_configs.py` assumes a power of two). A prime n_s over the limit
    gets n_s segments of one row."""
    if fused_fits:
        return 1
    need = -(-n_s // C3_SEGMENT_ROWS)
    best, i = n_s, 1
    while i * i <= n_s:                 # divisor pairs (i, n_s / i)
        if n_s % i == 0:
            best = min([best] + [d for d in (i, n_s // i) if d >= need])
        i += 1
    return max(best, 1)


def _c3_fused_fits(n_r: int, n_s: int, device) -> bool:
    """Whether the fused pipeline's peak fits the card's free memory; host
    memory is not checked."""
    if torch.device(device).type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(device)
    return (C3_FUSED_BYTES_PER_S_ROW * n_s + C3_FUSED_BYTES_PER_R_ROW * n_r
            <= free)


def config3(scale: int = 26, device="cuda", cache_dir: Optional[str] = None,
            n_r: int = 1 << 24) -> dict:
    """Filter -> probe -> group-by COUNT / SUM over 2^scale probe rows."""
    n_s = 1 << scale
    cols = datasets.make_config3(n_r, n_s, C3_GROUPS, seed=C3_SEED)
    segments = config3_segments(n_s, _c3_fused_fits(n_r, n_s, device))
    args = [torch.from_numpy(a).to(device) for a in cols]
    if segments > 1:
        run = lambda: pipelines.filter_probe_groupby_streamed(
            *args, C3_LO, C3_HI, C3_GROUPS, segments=segments)
    else:
        run = lambda: pipelines.filter_probe_groupby(
            *args, C3_LO, C3_HI, C3_GROUPS)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    dt, (cnt, sums) = _warm_timed(run, device)
    extra = {"segments": segments} if segments > 1 else {}
    if cuda:
        extra["peak_device_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    ec, es = _oracle_groupby_cached(f"c3_s{scale}_seed{C3_SEED}", *cols,
                                    C3_LO, C3_HI, C3_GROUPS, cache_dir)
    ok = (np.array_equal(cnt.cpu().numpy(), ec)
          and np.array_equal(sums.cpu().numpy(), es))
    return _report(3, f"filter_probe_groupby_{n_s >> 20}M", n_s, dt, ok, extra)


def config4(scale: int = 26, device="cuda",
            cache_dir: Optional[str] = None) -> dict:
    """Zipf z = 1.05 join (nominal 1B x 1B). From 2^28 rows a side the
    relations stay in host memory and the size dispatcher co-processes them
    (the reference's Join2); below, `ClusteredJoin` on the card."""
    n = 1 << scale
    rk, sk = datasets.make_pk_fk(n, n, skew=1.05, seed=SEED)
    big = scale >= C4_COPROCESS_SCALE
    if big:
        r, s = _ones_relations(rk, sk, "cpu")
        dt, res = _timed(lambda: clustered_probe_join(r, s, device=device),
                         device)
    else:
        r, s = _ones_relations(rk, sk, device)
        eng = ClusteredJoin(device=device)
        dt, res = _warm_timed(lambda: eng.aggregate(r, s), device)
    expect = _oracle_agg_cached(f"c4_pkfk_s{scale}_z1.05_seed{SEED}", rk, sk,
                                cache_dir)
    return _report(4, f"zipf1.05_{n >> 20}Mx{n >> 20}M", 2 * n, dt,
                   _u32(res.aggregate) == _u32(expect),
                   {"regime": "coprocess" if big else "in_memory"})


def _one_rank_legs(n: int, device, cache_dir: Optional[str] = None,
                   run=None) -> List[dict]:
    """Config 5's three legs in a 1-rank world (NCCL on a card, gloo on the
    CPU), through the process-group entry points. `run(tag, fn)` calls a
    leg and returns (its seconds, its last result); the default is one
    warm-up, then one timed call."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    scale = n.bit_length() - 1
    rk, sk = datasets.make_pk_fk(n, n, 0.0, SEED)
    ones = np.ones(n, np.int32)
    want = _u32(oracle_expect_cached(rk, ones, sk, ones, scale, 0.0,
                                     cache_dir=cache_dir))
    # the Zipf leg at its own seed, not through the .bin cache, whose names
    # carry no seed
    rkz = datagen.random_unique_gen(n, n, seed=C5_ZIPF_SEED)
    skz = datagen.gen_zipf(n, n, 1.05, seed=C5_ZIPF_SEED)
    want_z = _u32(_oracle_agg_cached(f"c5_zipf_s{scale}_seed{C5_ZIPF_SEED}",
                                     rkz, skz, cache_dir))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    store = tempfile.mkdtemp(prefix="run_configs_store_")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}/store",
                            rank=0, world_size=1)
    try:
        comm = group_mesh().comm("x")
        one = torch.ones(n, dtype=torch.int32, device=dev)
        r, s, rz, sz = (torch.from_numpy(a).to(dev) for a in (rk, sk, rkz, skz))
        legs = [
            ("distributed_exchange_1chip", want, lambda: (
                dist_join.distributed_join_segmented_local(
                    r, one, s, one, comm, num_segments=4))),
            ("distributed_oneshot_1chip", want, lambda: (
                dist_join.distributed_join_aggregate_local(r, one, s, one,
                                                           comm))),
            ("distributed_zipf_1chip", want_z, lambda: (
                dist_join.distributed_join_segmented_local(
                    rz, one, sz, one, comm, num_segments=4))),
        ]
        out = []
        run = run or (lambda tag, fn: _warm_timed(fn, dev))
        for tag, expect, fn in legs:
            dt, (agg, ov) = run(tag, fn)
            out.append(_report(5, f"{tag}_{n >> 20}Mx{n >> 20}M", 2 * n, dt,
                               _u32(agg) == expect and int(ov) == 0,
                               {"overflow": int(ov), "backend": backend}))
        return out
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


_RANK_CODE = ("import sys\n"
              "from icde2019_gpu_join_tpu_torch.benchmarks import run_configs\n"
              "run_configs._config5_rank(*sys.argv[1:])\n")


def _config5_rank(rank, world, n, backend, store, out_path):
    """One rank of the multi-card config 5: its shard of the 2^scale
    relations (rows in rank order), one warm-up and one timed call of the
    one-shot distributed join; writes {aggregate, overflow, seconds}."""
    rank, world, n = int(rank), int(world), int(n)
    dev = torch.device("cuda", rank) if backend == "nccl" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        rk, sk = datasets.make_pk_fk(n, n, 0.0, SEED)   # cached by the parent
        rows = slice(rank * (n // world), (rank + 1) * (n // world))
        r, s = (torch.from_numpy(a[rows].copy()).to(dev) for a in (rk, sk))
        one = torch.ones(n // world, dtype=torch.int32, device=dev)
        comm = group_mesh().comm("x")
        run = lambda: dist_join.distributed_join_aggregate_local(
            r, one, s, one, comm)
        run()
        _sync(dev)
        dist.barrier()
        dt, (agg, ov) = _timed(run, dev)
        with open(out_path, "w") as f:
            json.dump({"aggregate": int(agg), "overflow": int(ov),
                       "seconds": dt}, f)
    finally:
        dist.destroy_process_group()


def _process_world(n: int, ranks: int, backend: str) -> List[dict]:
    """Runs `ranks` processes of `_config5_rank`, each joined within
    RANK_TIMEOUT_S and killed on failure; their outputs. Each rank's
    stderr goes to a file, so that no rank blocks on a full pipe."""
    tmp = tempfile.mkdtemp(prefix="run_configs_world_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    path = lambda name: os.path.join(tmp, name)
    procs = []
    try:
        for r in range(ranks):
            with open(path(f"rank{r}.err"), "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _RANK_CODE, str(r), str(ranks),
                     str(n), backend, path("store"), path(f"rank{r}.json")],
                    cwd=REPO, env=env, stderr=err))
        for p in procs:
            p.wait(timeout=RANK_TIMEOUT_S)
        outs = []
        for r, p in enumerate(procs):
            if p.returncode != 0:
                with open(path(f"rank{r}.err")) as f:
                    raise RuntimeError(f"config 5 rank {r} of {ranks} failed: "
                                       f"{f.read()[-3000:]}")
            with open(path(f"rank{r}.json")) as f:
                outs.append(json.load(f))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def config5(scale: int = 24, device="cuda", cache_dir: Optional[str] = None,
            ranks: Optional[int] = None) -> List[dict]:
    """The distributed join. `ranks` defaults to the cards present (1 on
    the CPU). One rank: the three legs of `_one_rank_legs` at
    2^min(scale, 26) a side, then `dryrun_multichip(8)` on `device`.
    Several: one process a card (NCCL), or a gloo world on the CPU, each
    with a 1/ranks shard of the 2^scale relations."""
    cuda = torch.device(device).type == "cuda"
    ranks = ranks or (torch.cuda.device_count() if cuda else 1)
    if ranks < 2:
        out = _one_rank_legs(1 << min(scale, 26), device, cache_dir)
        print(dryrun_multichip(8, device), flush=True)
        return out
    n = (1 << scale) // ranks * ranks
    rk, sk = datasets.make_pk_fk(n, n, 0.0, SEED)   # the ranks read the cache
    expect = _u32(_oracle_agg_cached(f"c5_pkfk_n{n}_seed{SEED}", rk, sk,
                                     cache_dir))
    outs = _process_world(n, ranks, "nccl" if cuda else "gloo")
    agg, ov = outs[0]["aggregate"], outs[0]["overflow"]
    agree = all(o["aggregate"] == agg and o["overflow"] == ov for o in outs)
    return [_report(5, f"distributed_{n >> 20}Mx{n >> 20}M_{ranks}dev", 2 * n,
                    max(o["seconds"] for o in outs),
                    agree and _u32(agg) == expect and ov == 0,
                    {"overflow": ov})]


def config6(scale_s: int = 26, device="cuda",
            cache_dir: Optional[str] = None) -> dict:
    """2B-shape streaming join: R = min(2^29, 2^(scale_s - 2)) on the card,
    S = 2^scale_s in host memory, streamed in segments of at most 2^27
    rows through pinned staging slots and a copy stream."""
    n_r, n_s = min(1 << 29, 1 << (scale_s - 2)), 1 << scale_s
    rk, sk = datasets.make_pk_fk(n_r, n_s, seed=SEED)
    r = Relation.from_numpy(rk, np.ones(n_r, np.int32), device=device)
    s = Relation.from_numpy(sk, np.ones(n_s, np.int32), device="cpu")
    cfg = EngineConfig(segment_rows=min(1 << 27, n_s))
    dt, res = _timed(lambda: streaming_join_aggregate(r, s, cfg, device),
                     device)
    expect = _oracle_agg_cached(f"c6_r{n_r}_s{n_s}_seed{SEED}", rk, sk,
                                cache_dir)
    return _report(6, f"streaming_{n_r >> 20}Mx{n_s >> 20}M", n_r + n_s, dt,
                   _u32(res.aggregate) == _u32(expect),
                   {"phases": {p.name: p.seconds for p in res.timer.phases}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--full", action="store_true",
                    help="nominal sizes (2^29, 2^30, 2^31 rows)")
    args = ap.parse_args(argv)
    want = {int(c) for c in args.configs.split(",")}
    # built before any clock starts: config 6 and the co-processed config 4
    # time their only call
    _build.build_kernels()
    datagen.native_lib()
    lines = []
    if 1 in want:
        lines.append(config1())
    if 2 in want:
        lines += config2(27)
    if 3 in want:
        lines.append(config3(29 if args.full else 26))
    if 4 in want:
        lines.append(config4(30 if args.full else 26))
    if 5 in want:
        lines += config5(31 if args.full else 24)
    if 6 in want:
        lines.append(config6(31 if args.full else 26))
    return 0 if all(line["correct"] for line in lines) else 1


if __name__ == "__main__":
    raise SystemExit(main())
