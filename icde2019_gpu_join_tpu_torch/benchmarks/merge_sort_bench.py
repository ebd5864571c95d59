"""Measurements for the merge-tree sort question on the card.

Counterpart of `benchmarks/merge_sort_bench.py`; the CUDA kernel of
`stage_reps` is `csrc/stage_reps.cu` (`tj_stage_reps`). Three measurements,
the cheapest first:

  stages : the rate (Gelem-stage/s) of one compare-exchange stage at several
           distances, in both memories a stage can run in on this card. A
           tile of at most 2^14 pairs stays in a block's shared memory for
           all reps; a larger tile cannot, and each rep is a pass over device
           memory. The reference's four distances run at the reference's
           tile rule, max(2^18, 2d), so in device memory; the same ladder
           runs at tile 2^14 in shared memory (`smem_*`). Each line names
           the memory. Then one in-block merge level (`merge_levels_vmem`,
           run = tile / 2, tile 2^14: the reference's 2^18 does not fit a
           block). The reference times that level under both values of
           `lane_transpose`; one kernel stands for both here, so there is
           one line.
  packed : the one-operand sort of (key << 32 | payload) words
           (`packed_sort_pairs`) against `torch.sort` + gather.
  full   : `_merge_sort_cascade` end to end against `torch.sort` + gather
           under several geometries. The reference's variants `merge_nodb`
           and `merge_lt` differ from `merge` only in `hbm_double_buffer`
           and `lane_transpose`, which select nothing here: they are the
           same launches as `merge` and are printed once, under `merge`
           (`same_launches_as_merge`). `merge_w32k` (window 32768) passes
           both what a block holds (2 windows of at most 2^13 pairs) and the
           runs of 2^14 the in-block levels hand over: the line carries the
           `ValueError` (`merge_w32k_error`). `merge_w4k` and `merge_w2k`
           are the windows below the default, which do fit. On the card a
           cascade is device work from end to end (each merge-path level
           is two launches, the plan kernel and the merge, and the host
           reads nothing between them), so a variant's time is its
           kernels' and the windows can be compared here.

Every time is the best of several calls after a warm-up, by CUDA events on
the card and by the host clock on the CPU (`utils/timing.best_ms`).

Usage: python -m icde2019_gpu_join_tpu_torch.benchmarks.merge_sort_bench
           [stages|packed|full|all] [log2n] [--device cpu]
Prints one JSON line per measurement and exits 1 on a wrong result.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from icde2019_gpu_join_tpu_torch.ops import _build, merge
from icde2019_gpu_join_tpu_torch.utils.timing import best_ms

REPS = 24
LANES = 128
REF_TILE = 1 << 18    # the reference's tile: pairs a TPU tile holds

# Calls of `stage_reps` that launched the kernel since the last reset.
LAUNCHES: Dict[str, int] = {"stage_reps": 0}


def reset_launches():
    LAUNCHES["stage_reps"] = 0


def _check(sv, pv, d: int, reps: int, tile: int):
    merge._check_pairs(sv, pv)
    n = sv.shape[0]
    if not (merge._is_pow2(d) and merge._is_pow2(tile) and tile >= LANES
            and 2 * d <= tile and reps >= 1):
        raise ValueError(f"d and tile (>= {LANES}) must be powers of two "
                         f"with 2 * d <= tile, and reps >= 1: d={d}, "
                         f"tile={tile}, reps={reps}")
    if n == 0 or n % tile:
        raise ValueError(f"n must be a positive multiple of tile: n={n}, "
                         f"tile={tile}")


def stage_reps_ref(sv: torch.Tensor, pv: torch.Tensor, d: int, reps: int,
                   tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `stage_reps`: the stage over the whole
    arrays, `reps` times."""
    _check(sv, pv, d, reps, tile)
    for _ in range(reps):
        sv, pv = merge._cx(sv, pv, d)
    return sv.view(-1, LANES), pv.view(-1, LANES)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.kernel_lib().tj_stage_reps
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stage_reps(sv: torch.Tensor, pv: torch.Tensor, d: int, reps: int,
               tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`reps` times one compare-exchange stage at distance d (strict <, a
    pair swapped as one, every group ascending) over each tile of `tile`
    pairs of the flat (sv, pv); returns int32 [n / 128, 128] twice. A stage
    is idempotent: the result is that of one stage, the work that of `reps`.
    On the card a tile of at most MAX_BLOCK_ELEMS runs in shared memory, a
    larger one as `reps` passes over device memory (`stage_memory`)."""
    _check(sv, pv, d, reps, tile)
    if not sv.is_cuda:
        return stage_reps_ref(sv, pv, d, reps, tile)
    osv, opv = torch.empty_like(sv), torch.empty_like(pv)
    with torch.cuda.device(sv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(sv.data_ptr(), pv.data_ptr(), osv.data_ptr(),
                        opv.data_ptr(), sv.shape[0], d, reps, tile, stream)
    if err != 0:
        raise RuntimeError(f"tj_stage_reps launch failed: CUDA error {err}")
    LAUNCHES["stage_reps"] += 1
    return osv.view(-1, LANES), opv.view(-1, LANES)


def stage_memory(tile: int) -> str:
    """The memory a stage over tiles of `tile` pairs runs in on the card."""
    return "shared" if tile <= merge.MAX_BLOCK_ELEMS else "global"


def stage_cases(n: int) -> List[Tuple[str, int, int]]:
    """(name, d, tile) of every stage `bench_stages` times at n pairs: the
    reference's four distances at the reference's tile rule, then the same
    ladder inside a block's shared memory."""
    block = merge.MAX_BLOCK_ELEMS
    cases = [(name, d, min(max(REF_TILE, 2 * d), n))
             for name, d in (("sublane_big", 1 << 17), ("sublane_128", 128),
                             ("lane_16", 16), ("lane_1", 1))]
    cases += [(f"smem_{name}", d, min(block, n))
              for name, d in (("sublane_big", block // 2), ("sublane_128", 128),
                              ("lane_16", 16), ("lane_1", 1))]
    return [c for c in cases if 2 * c[1] <= c[2]]


def _pairs(n: int, lo: int, hi: int, device, seed: int = 0):
    """Seeded keys in [lo, hi) and full-range payloads, on `device`."""
    rng = np.random.RandomState(seed)
    k = rng.randint(lo, hi, n, dtype=np.int64).astype(np.int32)
    v = rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    return torch.from_numpy(k).to(device), torch.from_numpy(v).to(device)


def bench_stages(lg: int, device="cuda") -> dict:
    n = 1 << lg
    sv, pv = _pairs(n, -2**31, 2**31, device)
    out = {"bench": "stages", "n": n, "reps": REPS, "stages_correct": True}
    for name, d, tile in stage_cases(n):
        ms = best_ms(lambda: stage_reps(sv, pv, d, REPS, tile), device)
        # a stage is idempotent: one plain stage is what `reps` must give
        got, want = stage_reps(sv, pv, d, REPS, tile), stage_reps_ref(
            sv, pv, d, 1, tile)
        out["stages_correct"] &= all(torch.equal(g, w)
                                     for g, w in zip(got, want))
        rate = n * REPS / (ms * 1e-3) / 1e9
        out[f"{name}_Gelem_stage_s"] = rate
        print(json.dumps({"stage": name, "d": d, "tile": tile,
                          "memory": stage_memory(tile), "ms": ms,
                          "Gelem_stage_s": rate}))
    tile = min(merge.MAX_BLOCK_ELEMS, n)
    if tile >= 2 * LANES:
        out["vmem_level_tile"] = tile
        out["vmem_level_ms"] = best_ms(
            lambda: merge.merge_levels_vmem(sv, pv, tile // 2, 1,
                                            tile_elems=tile), device)
    print(json.dumps(out))
    return out


def bench_packed(lg: int, device="cuda") -> dict:
    n = 1 << lg
    kd, vd = _pairs(n, -2**31, 2**31, device)
    t2 = best_ms(lambda: merge.torch_sort_pairs(kd, vd), device)
    tp = best_ms(lambda: merge.packed_sort_pairs(kd, vd), device)
    ko, _ = merge.packed_sort_pairs(kd, vd)
    ks, _ = merge.torch_sort_pairs(kd, vd)
    res = {"bench": "packed", "n": n,
           "two_op_ms": t2, "two_op_Mrows_s": n / t2 / 1e3,
           "packed_ms": tp, "packed_Mrows_s": n / tp / 1e3,
           "packed_correct": bool(torch.equal(ko, ks)),
           "speedup": t2 / tp}
    print(json.dumps(res))
    return res


# (name, geometry) of `bench_full`'s cascades
FULL_VARIANTS = (("merge", {}), ("merge_w32k", {"hbm_window": 32768}),
                 ("merge_w4k", {"hbm_window": 4096}),
                 ("merge_w2k", {"hbm_window": 2048}))


def bench_full(lg: int, device="cuda") -> dict:
    n = 1 << lg
    # keys in [-2^30, 2^30): none is a masking sentinel of the cascade
    kd, vd = _pairs(n, -2**30, 2**30, device)
    t2 = best_ms(lambda: merge.torch_sort_pairs(kd, vd), device)
    res = {"bench": "full", "n": n, "lax_ms": t2, "lax_Mrows_s": n / t2 / 1e3,
           "same_launches_as_merge": ["merge_nodb", "merge_lt"]}
    ks, _ = merge.torch_sort_pairs(kd, vd)
    for name, geometry in FULL_VARIANTS:
        fn = functools.partial(merge._merge_sort_cascade, kd, vd, **geometry)
        try:
            ko, _ = fn()
        except ValueError as e:   # a geometry that does not fit a block
            res[f"{name}_error"] = " ".join(str(e).split())[:160]
            continue
        tm = best_ms(fn, device)
        res.update({f"{name}_ms": tm, f"{name}_Mrows_s": n / tm / 1e3,
                    f"{name}_speedup": t2 / tm,
                    f"{name}_keys_exact": bool(torch.equal(ko, ks))})
    print(json.dumps(res))
    return res


def correct(res: dict) -> bool:
    """Every check a bench's result line carries holds."""
    return all(v for k, v in res.items()
               if k.endswith("_keys_exact")
               or k in ("packed_correct", "stages_correct"))


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("which", nargs="?", default="all",
                        choices=("stages", "packed", "full", "all"))
    parser.add_argument("log2n", nargs="?", type=int, default=24)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    ok = True
    if args.which in ("stages", "all"):
        ok &= correct(bench_stages(min(args.log2n, 24), args.device))
    if args.which in ("packed", "all"):
        ok &= correct(bench_packed(args.log2n, args.device))
    if args.which in ("full", "all"):
        ok &= correct(bench_full(args.log2n, args.device))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
