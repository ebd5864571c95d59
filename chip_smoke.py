#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: `python3 chip_smoke.py`. It drives the port's
main path, `ClusteredJoin(device="cuda").aggregate`, in five phases, each
printing one line:

  1. report: torch and CUDA versions, the card's name and power limit;
  2. build: the CUDA kernel library (nvcc, sm_90a) and the C++ host library;
  3. kernel vs plain: `banded_compare_sum` against `banded_compare_sum_ref`
     on the card, exact int32 equality, with both times;
  4. end to end at 2^24 x 2^24 uniform PK-FK (against the checked-in oracle
     value) and at 2^22 x 2^22 Zipf z=1.05 (against the C++ oracle);
  5. end to end at 2^27 x 2^27 uniform PK-FK with payloads of 1, the
     `bench.py` workload: best of 3 after a warm-up, which must equal the
     checked-in oracle value and must have launched the kernel.

Then one JSON line on the kernels, and last the result line
`{"ok": true, "device": {...}}`. Any failure raises, so the exit code is not
0 and no result line is printed; that includes a machine without CUDA.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from icde2019_gpu_join_tpu_torch import datagen
from icde2019_gpu_join_tpu_torch.models import ClusteredJoin
from icde2019_gpu_join_tpu_torch.ops import _build, band_compare, band_join
from icde2019_gpu_join_tpu_torch.relation import Relation
from icde2019_gpu_join_tpu_torch.utils import datasets

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 12345
KERNEL_SHAPES = [(8, 1), (333, 3), (2048, 1), (2048, 4)]
HEADLINE_SCALE = 27
REPS = 3


def _oracle_value(scale: int, skew: float) -> int:
    """A checked-in C++ oracle aggregate (native generator, payloads 1)."""
    path = os.path.join(REPO, "data",
                        f"oracle_agg_pkfk_s{scale}_z{skew}_seed{SEED}_gnative.json")
    with open(path) as f:
        return int(json.load(f)["aggregate"])


def _time_ms(fn, reps: int) -> float:
    """Mean device time of one call, by CUDA events over `reps` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _chunk_inputs(ch: int, w: int, rng: np.random.RandomState):
    """Dense-match chunk: keys from a narrow range, full-range int32
    payloads (sums wrap), and one row whose rp is all zero."""
    wb = w * band_compare.LANES
    sk = rng.randint(0, 16, (ch, band_compare.LANES)).astype(np.int32)
    rk = rng.randint(0, 16, (ch, wb)).astype(np.int32)
    sp = rng.randint(-2**31, 2**31, sk.shape, dtype=np.int64).astype(np.int32)
    rp = rng.randint(-2**31, 2**31, rk.shape, dtype=np.int64).astype(np.int32)
    rp[ch // 2] = 0
    return [torch.from_numpy(a).cuda() for a in (sk, sp, rk, rp)]


def _max_rounds(r: Relation, s: Relation, w: int) -> int:
    r_sv, _ = band_join.sort_by_key(r.keys, r.payload)
    s_sv, _ = band_join.sort_by_key(s.keys, s.payload)
    lo, hi = band_join.block_windows(r_sv, s_sv)
    return int(((hi - lo + (w - 1)) // w).max())


def phase_report() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"[report] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}")
    print(smi)
    return kind


def phase_build():
    t_kernels = _build.build_kernels()
    t_host = _build.build_host()
    band_compare._kernel()  # loads the library and binds the symbol
    if datagen.native_lib() is None:
        raise RuntimeError("native host library did not load")
    print(f"[build] kernels {t_kernels:.2f}s ({_build.KERNEL_LIB}) "
          f"host {t_host:.2f}s ({_build.HOST_LIB})")


def phase_kernel() -> dict:
    rng = np.random.RandomState(SEED)
    max_err = 0
    for ch, w in KERNEL_SHAPES:
        args = _chunk_inputs(ch, w, rng)
        got = int(band_compare.banded_compare_sum(*args))
        want = int(band_compare.banded_compare_sum_ref(*args))
        torch.cuda.synchronize()
        if got != want:
            raise AssertionError(f"kernel {got} != plain {want} at CH={ch} W={w}")
        max_err = max(max_err, abs(got - want))
    small = _chunk_inputs(2048, 1, rng)
    k_small = _time_ms(lambda: band_compare.banded_compare_sum(*small), 50)
    p_small = _time_ms(lambda: band_compare.banded_compare_sum_ref(*small), 5)
    # the chunk shape the headline run launches (W = 1)
    main = _chunk_inputs(band_join._CHUNK_BLOCKS, 1, rng)
    if int(band_compare.banded_compare_sum(*main)) != int(
            band_compare.banded_compare_sum_ref(*main)):
        raise AssertionError("kernel != plain at the main-path chunk shape")
    k_main = _time_ms(lambda: band_compare.banded_compare_sum(*main), 20)
    p_main = _time_ms(lambda: band_compare.banded_compare_sum_ref(*main), 3)
    print(f"[kernel] equal to plain at (CH, W) in {KERNEL_SHAPES} and "
          f"({band_join._CHUNK_BLOCKS}, 1); (2048,1): kernel {k_small:.4f} ms "
          f"plain {p_small:.4f} ms; ({band_join._CHUNK_BLOCKS},1): kernel "
          f"{k_main:.4f} ms plain {p_main:.4f} ms")
    return {"max_abs_err": max_err, "ms": k_main, "plain_ms": p_main}


def _relations(rk, rp, sk, sp):
    return (Relation.from_numpy(rk, rp, device="cuda"),
            Relation.from_numpy(sk, sp, device="cuda"))


def phase_mid():
    engine = ClusteredJoin(device="cuda")
    n = 1 << 24
    rk, sk = datasets.make_pk_fk(n, n, seed=SEED)
    ones = np.ones(n, np.int32)
    r, s = _relations(rk, ones, sk, ones)
    want = _oracle_value(24, 0.0)
    t_uni = float("inf")
    for _ in range(1 + REPS):  # the first call is the warm-up
        t0 = time.perf_counter()
        uni = engine.aggregate(r, s).aggregate
        t_uni = min(t_uni, time.perf_counter() - t0)
        if uni != want:
            raise AssertionError(f"2^24 uniform: {uni} != oracle {want}")

    n = 1 << 22
    rk, sk = datasets.make_pk_fk(n, n, skew=1.05, seed=SEED)
    rng = np.random.RandomState(SEED)
    rp = rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    sp = rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    r, s = _relations(rk, rp, sk, sp)
    got = engine.aggregate(r, s).aggregate
    want = datagen.oracle_join_aggregate(rk, rp, sk, sp)
    if got != want:
        raise AssertionError(f"2^22 zipf 1.05: {got} != C++ oracle {want}")
    rounds = _max_rounds(r, s, engine.config.band_window_blocks)
    print(f"[mid] 2^24 uniform = {uni} (oracle), best of {REPS} "
          f"{t_uni * 1e3:.3f} ms; "
          f"2^22 zipf1.05 = {got} (C++ oracle {want}), max rounds {rounds}")


def phase_headline() -> int:
    n = 1 << HEADLINE_SCALE
    t0 = time.perf_counter()
    rk, sk = datasets.make_pk_fk(n, n, seed=SEED)
    ones = np.ones(n, np.int32)
    r, s = _relations(rk, ones, sk, ones)
    t_data = time.perf_counter() - t0
    want = _oracle_value(HEADLINE_SCALE, 0.0)
    engine = ClusteredJoin(device="cuda")
    torch.cuda.reset_peak_memory_stats()

    band_compare.LAUNCHES = 0
    res = engine.aggregate(r, s)
    launches = band_compare.LAUNCHES
    if launches <= 0:
        raise AssertionError("the main path launched no band_compare kernel")
    best = float("inf")
    for _ in range(REPS):
        if res.aggregate != want:
            raise AssertionError(f"2^27 uniform: {res.aggregate} != oracle {want}")
        t0 = time.perf_counter()
        res = engine.aggregate(r, s)
        best = min(best, time.perf_counter() - t0)
    if res.aggregate != want:
        raise AssertionError(f"2^27 uniform: {res.aggregate} != oracle {want}")
    peak = torch.cuda.max_memory_allocated()
    rounds = _max_rounds(r, s, engine.config.band_window_blocks)
    print(f"[headline] 2^27 x 2^27 uniform = {res.aggregate} (oracle {want}); "
          f"best of {REPS} {best * 1e3:.3f} ms, "
          f"{2 * n / best / 1e6:.1f} Mrows/s; peak device memory "
          f"{peak / 2**30:.2f} GiB; chunk {band_join._CHUNK_BLOCKS} blocks; "
          f"rounds {rounds}; kernel launches per join {launches}; "
          f"data {t_data:.1f}s")
    return launches


def main():
    kind = phase_report()
    phase_build()
    kstats = phase_kernel()
    phase_mid()
    launches = phase_headline()
    print(json.dumps({"kernels": [{
        "name": "band_compare_sum",
        "route": "cuda",
        "source": "icde2019_gpu_join_tpu_torch/csrc/band_compare.cu",
        "replaces": "icde2019_gpu_join_tpu/ops/band_compare_pallas.py:44",
        "launches": launches,
        **kstats,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
