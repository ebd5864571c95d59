#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: `python3 chip_smoke.py`. It builds the port's
kernels and drives its paths on the card, each phase printing one line with
its seconds. `python3 chip_smoke.py --phases "kernel merge,sorts"` runs
`report`, `build` and only the named phases (`PHASES`; `headline` comes
along where a phase joins its relations), each whole, and ends with a line
that names them: it prints no `kernels` line and no result line, so only a
run of all phases can pass. The phases:

  report     torch and CUDA versions, the card's name and power limit;
  build      the CUDA kernel library (nvcc, sm_90a) and the C++ host library,
             side by side;
  kernel     each of the first five kernels against its plain version on the card,
             exact int32 equality: the four banded kernels at small shapes
             (W > 1, full-range payloads, empty windows) and at the shape
             their path gives them, with both times at that shape; the
             stream-range probe (kernel 5) at small plans (several partitions
             per R tile, tiles with no chunks, a skewed tile with hundreds of
             chunks, chunk counts past S, full-range payloads) and at
             config 1's full plan, with both times there;
  kernel merge  the merge sort's kernels (6: `merge_levels_vmem`, 7: the two
             launches of `merge_level_hbm`, the plan and the merge) against
             their plain versions, keys and payloads exactly equal and the
             plan kernel's table equal to the torch planner's: small shapes
             (duplicate-heavy and full-range keys, several blocks so odd run
             parities occur, two pairs so an odd pair's encoded output
             occurs, the short second-to-last tile of a pair, windows 8192,
             4096, 1024 and 256, keys in [0, 16) at 2^20 and 2^21 pairs)
             and the shapes the 2^27 cascade gives them,
             which the phase walks level by level: base runs, kernel 6 at run
             4096 and 2 levels, then 13 merge-path levels, each with the plan
             kernel's table held against the torch planner's and both timed,
             and kernel 7's time; the first level (runs of
             2^14) and the last (2^26) held against the plain version and
             timed beside it at windows 8192 and 4096; then the whole
             `merge_sort_pairs` and
             `packed_sort_pairs` at 2^27 against `torch.sort` (keys equal,
             (key, payload) multiset equal; packed element for element),
             with their times and `torch.sort` + gather beside them;
  kernel sort tiles  the tile sort (kernel 8, `benchmarks/experimental_sort.py`
             of the port) against its plain version, keys and payloads exactly
             equal: tiles of 1024, 2^15, 2^17, 2^20 (which reach the strided
             passes) and 2^22 (two strided passes for its last merge), several
             tiles, distinct keys, keys
             in [0, 16) (where the element-wise exchange of the reference
             loses payloads: the count that survives is printed, kernel and
             plain alike) and full-range keys with both extremes; then 2^27
             pairs at tile 2^20 with distinct keys, with both times and
             `torch.sort` of [128, 2^20] along dim 1 + gather beside them;
  kernel stage  the stage kernel (kernel 9, `benchmarks/merge_sort_bench.py`
             of the port): every distance at tile 2^12 (shared memory) and
             2^15 (device memory), reps 1 and 3, then `bench_stages` at 2^24
             through its entry point, then its eight (d, tile) cases at reps
             24 against the plain version, with the rates;
  probes     the ladder of construct probes (kernel 10,
             `benchmarks/construct_probes.py` of the port) through
             `run_probes`: every probe ok, with its time;
  sort tools `bench_packed` and `bench_full` at 2^24 and `merge_fix_validate`
             at 2^18 and 2^24 through their entry points, every check true,
             window 32768 refused;
  mid        `ClusteredJoin.aggregate` at 2^24 x 2^24 uniform PK-FK (against
             the checked-in oracle value) and 2^22 x 2^22 Zipf z=1.05
             (against the C++ oracle);
  headline   the aggregate at 2^27 x 2^27 uniform PK-FK with payloads of 1,
             the `bench.py` workload: best of 3 after a warm-up;
  sorts      `EngineConfig.sort_impl`: the headline relations with every key
             plus 1 on both sides (the same join and oracle value, no sort
             value a masking sentinel) under "merge" and "packed", best of 3
             with peak memory; under "merge" each call must launch kernel 6
             twice, kernel 7 26 times and its plan kernel as often, and take
             the cascade twice; the
             unshifted relations under "merge" must launch neither and fall
             back twice (key 0 sorts as a sentinel), as the reference does;
             then config 1 with keys plus 1 under "merge": `probe_mode=
             "pallas"` (the cascade feeding the partitions and kernel 5),
             banded materialize into 2^24 and late aggregate; and config 3 at
             2^24 x 2^26 under "packed";
  materialize  `ClusteredJoin.materialize` (a) at 2^24 x 2^24 PK-FK into a
             2^24 buffer, which must take the block-windowed fast path and
             equal the numpy oracle as a multiset, and (b) the config-2 leg,
             2^27 x 2^27 into a 2^24 ring: the total must equal the
             checked-in oracle value and the ring the one built in numpy from
             the sorted S keys (payloads are functions of the key, so the
             ring does not depend on tie order); best of 3;
  partitioned  the radix-partitioned modes: `probe_mode="pallas"` at config
             1 (2^20 x 2^24 PK-FK, full-range payloads) and 2^22 Zipf z=1.05
             against the C++ oracle, and at config 2 (the headline's 2^27
             relations at 18 bits) against the checked-in value, best of 3
             with peak memory, work items, compares and the kernel's time at
             that plan; `probe_mode="blocked"` aggregate, count, materialize
             (into 2^24, multiset) and late aggregate at config 1 against the
             numpy oracles; `probe_mode="sort_merge"` at 2^27 against the
             checked-in value; `global_ht_join_aggregate` at config 1;
  late       `ClusteredJoin.late_aggregate` at 2^24 per side with 4 R and 2 S
             columns, against the numpy oracle;
  pipeline   BASELINE.json config 3, 2^24 R x 2^29 S, 64 groups, filter
             [100, 600): fused and streamed in 4 segments, equal to each
             other and to a direct-address numpy oracle, best of 3 and peak
             device memory; and the general numpy oracle at 2^20
             duplicate-key R x 2^23 S.

The headline, sorts, materialize, partitioned, late and pipeline phases, and
the four phases of the sort tools, each zero the kernels' launch counts just
before they drive their path, read them just after, and fail if a kernel of
the path did not launch. Then one JSON
line on the kernels: each with its launches on its path, its time and its
plain version's at the path's shape, and its bound there, the larger of the
bytes it must move (each input read once, each output written once) over
3.35 TB/s and the integer operations its function needs over the card's
integer rate (SMs x 64 int32 lanes x the SM clock `nvidia-smi` reports;
`KERNEL_OPS` says what is counted). `library_ms` is the one PyTorch call
that computes the tile sort on distinct keys (`torch.sort` along dim 1 +
gather); no single call computes any of the other functions, so it is null
there; the whole merge sort has `torch.sort` + gather beside it in the kernel
merge phase. Kernel 7's entry also carries its plan kernel's time
(`plan_ms`, beside the torch planner's wall time) and launches
(`plan_launches`) and window 4096 at both levels; kernel 5's its time and bound at config 2's plan. The probe ladder is one entry: its launches are the probe
kernels run, its times their sums, with a map per probe. Last the result line `{"ok": true, "device": {...}}`.
Any failure raises, so the exit code is not 0 and no result line is
printed; that includes a machine without CUDA.
"""

import concurrent.futures
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from icde2019_gpu_join_tpu_torch import datagen
from icde2019_gpu_join_tpu_torch.benchmarks import (construct_probes,
                                                    experimental_sort,
                                                    merge_fix_validate,
                                                    merge_sort_bench)
from icde2019_gpu_join_tpu_torch.config import EngineConfig, default_bits_for
from icde2019_gpu_join_tpu_torch.models import ClusteredJoin, pipelines
from icde2019_gpu_join_tpu_torch.ops import (_build, band_compare, band_join,
                                             merge, perfect_hash, probe_ranges)
from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32
from icde2019_gpu_join_tpu_torch.ops.partition import radix_partition
from icde2019_gpu_join_tpu_torch.relation import Relation
from icde2019_gpu_join_tpu_torch.utils import datasets, oracle

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
SEED = 12345
SMALL_SHAPES = [(8, 1), (333, 3), (2048, 1), (2048, 4)]   # (CH, W)
MID_SCALE = 24        # log2 rows per side: mid aggregate and late aggregate
HEADLINE_SCALE = 27   # the aggregate headline and the config-2 ring leg
RING = 1 << 24        # the FOLD ring; also the rows per side of the fast leg
REPS = 3
KEY_MIX = 0x5bd1e995   # S payload = key ^ KEY_MIX, R payload = 7 * key + 1
C3 = dict(n_r=1 << 24, n_s=1 << 29, groups=64, lo=100, hi=600, segments=4)
C3_GENERAL = (1 << 20, 1 << 23)   # (R, S) rows for the general numpy oracle
CONFIG1 = (1 << 20, 1 << 24)      # BASELINE.json config 1, pkfk_1Mx16M
RANGE_TILE = 1024                 # probe_mode "pallas": max(1024, probe_tile_*)
CONFIG2_BITS = 18                 # default_bits_for(2^27, 1024)
C3_PACKED = (1 << 24, 1 << 26)    # (R, S) rows of config 3 under "packed"
SORT_SCALE = 27                   # log2 rows of the merge phase's sorts
BANDED_PALLAS = "icde2019_gpu_join_tpu/ops/band_compare_pallas.py"
BANDED_SOURCE = "icde2019_gpu_join_tpu_torch/csrc/band_compare.cu"
MERGE_PALLAS = "icde2019_gpu_join_tpu/ops/merge_pallas.py"
MERGE_SOURCE = "icde2019_gpu_join_tpu_torch/csrc/merge.cu"
SORT_TILES = (27, 1 << 20)        # (log2 rows, tile) of the tile sort's phase
STAGE_SCALE = 24                  # log2 rows of `bench_stages`
TOOLS_SCALE = 24                  # log2 rows of `bench_full`, `bench_packed`
VALIDATE_SCALES = (18, 24)        # log2 rows of `merge_fix_validate`
CSRC = "icde2019_gpu_join_tpu_torch/csrc"
# kernel: (its CUDA source, the TPU kernel it replaces)
ROUTES = {
    "banded_compare_sum": (BANDED_SOURCE, f"{BANDED_PALLAS}:44"),
    "banded_compare_per_s": (BANDED_SOURCE, f"{BANDED_PALLAS}:93"),
    "banded_compare_first": (BANDED_SOURCE, f"{BANDED_PALLAS}:138"),
    "banded_interval_select": (BANDED_SOURCE, f"{BANDED_PALLAS}:185"),
    "probe_aggregate_ranges": (
        "icde2019_gpu_join_tpu_torch/csrc/probe_ranges.cu",
        "icde2019_gpu_join_tpu/ops/probe_pallas.py:76"),
    "merge_levels_vmem": (MERGE_SOURCE, f"{MERGE_PALLAS}:182"),
    "merge_level_hbm": (MERGE_SOURCE, f"{MERGE_PALLAS}:313"),
    "sort_tiles": (f"{CSRC}/sort_tiles.cu",
                   "benchmarks/experimental_sort_pallas.py:100"),
    "stage_reps": (f"{CSRC}/stage_reps.cu", "benchmarks/merge_sort_bench.py:77"),
    "construct_probes": (f"{CSRC}/construct_probes.cu",
                         "benchmarks/mosaic_bisect.py:89"),
}
# The integer operations each kernel's function needs per unit of work, for
# its bound: per compared (S row, R column) pair a compare and one
# predicated add (kernels 1 and 5), two adds (2), an add and a min (3), two
# compares and three adds (4); per compare-exchange of the merge kernels,
# the tile sort, the stage kernel and the probes a compare and four selects.
KERNEL_OPS = {"banded_compare_sum": 2, "banded_compare_per_s": 3,
              "banded_compare_first": 3, "banded_interval_select": 5,
              "probe_aggregate_ranges": 2, "merge_levels_vmem": 5,
              "merge_level_hbm": 5, "sort_tiles": 5, "stage_reps": 5,
              "construct_probes": 5}
# The exchanges of each construct probe: (stages, exchanges a stage).
PROBE_EXCHANGES = {
    "transpose_only": (0, 0), "concat_only": (0, 0), "min_dma": (0, 0),
    "lane_64": (1, 1 << 13), "lane_16": (1, 1 << 13), "lane_1": (1, 1 << 13),
    "dirmask_stage": (1, 1 << 13), "sublane_ladder": (7, 1 << 13),
    "lane_ladder_T": (7, 1 << 13), "concat_merge": (14, 1 << 14),
    "min_dma_compute": (14, 1 << 14), "full_merge_T": (15, 1 << 14),
    "merge_T_dm": (15, 1 << 14)}
# The int32 elements each construct probe reads and writes.
PROBE_ELEMENTS = {
    "transpose_only": 2 << 14, "concat_only": 2 << 14, "min_dma": 2 << 15,
    "lane_64": 3 << 14, "lane_16": 3 << 14, "lane_1": 3 << 14,
    "dirmask_stage": 3 << 14, "sublane_ladder": 3 << 14,
    "lane_ladder_T": 3 << 14, "concat_merge": 4 << 14,
    "min_dma_compute": 2 << 15, "full_merge_T": 3 << 14, "merge_T_dm": 3 << 14}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
INT32_LANES_PER_SM = 64
CARD = {}                   # "int_ops_per_s", set by phase_report


def _oracle_value(scale: int, skew: float) -> int:
    """A checked-in C++ oracle aggregate (native generator, payloads 1)."""
    path = os.path.join(REPO, "data",
                        f"oracle_agg_pkfk_s{scale}_z{skew}_seed{SEED}_gnative.json")
    with open(path) as f:
        return int(json.load(f)["aggregate"])


# the modules whose wrappers count their kernels' launches
COUNTED = (band_compare, probe_ranges, merge, experimental_sort,
           merge_sort_bench, construct_probes)


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


def _best_s(fn, reps: int = REPS):
    """(best wall seconds of `reps` synchronised calls, the last result)."""
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best, out


def _launched(fn):
    """Zero the launch counts, run fn once (synchronised), and return
    (fn's result, the launch counts of that run, every kernel)."""
    for module in COUNTED:
        module.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = {}
    for module in COUNTED:
        counts.update(module.LAUNCHES)
    return out, counts


def _bound(nbytes: int, int_ops: int) -> dict:
    """The least time the card could take: the bytes over the memory rate or
    the integer operations over the integer rate, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = int_ops / CARD["int_ops_per_s"] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _require(counts: dict, path: str, *names):
    for name in names:
        if counts[name] <= 0:
            raise AssertionError(f"{path}: kernel {name} did not launch ({counts})")


# ---- kernel inputs, made on the card from a seeded generator -------------

def _ints(gen, lo: int, hi: int, shape) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=gen, device=DEVICE,
                         dtype=torch.int64).to(torch.int32)


def _full(gen, shape) -> torch.Tensor:
    """Full-range int32 payloads (sums wrap)."""
    return wrap_i32(torch.randint(0, 1 << 32, shape, generator=gen,
                                  device=DEVICE, dtype=torch.int64))


def _compare_inputs(gen, ch: int, wb: int):
    """Keys from a narrow range (dense matches); one row whose window holds
    only the R-pad sentinel (an empty window)."""
    sk = _ints(gen, 0, 16, (ch, band_compare.LANES))
    rk = _ints(gen, 0, 16, (ch, wb))
    rk[ch // 3] = band_join._R_PAD_SV
    return sk, rk


def _sum_args(gen, ch, wb):
    sk, rk = _compare_inputs(gen, ch, wb)
    rp = _full(gen, (ch, wb))
    rp[ch // 2] = 0
    return sk, _full(gen, sk.shape), rk, rp


def _per_s_args(gen, ch, wb):
    sk, rk = _compare_inputs(gen, ch, wb)
    return sk, rk, _full(gen, (ch, wb))


def _first_args(gen, ch, wb):
    sk, rk = _compare_inputs(gen, ch, wb)
    gidx = torch.randperm(ch * wb, generator=gen, device=DEVICE).to(
        torch.int32).view(ch, wb)
    return sk, rk, gidx


def _interval_args(gen, ch, wb):
    """Disjoint [lo, hi) per row, some empty and one row all empty; slots on
    both sides of every interval."""
    widths = _ints(gen, 0, 5, (ch, wb))
    widths[ch // 3] = 0
    lo = (torch.cumsum(widths, 1) - widths).to(torch.int32)
    hi = lo + widths
    pos = _ints(gen, -2, int(hi.max()) + 3, (ch, band_compare.LANES))
    return (pos, lo, hi, _full(gen, (ch, wb)), _full(gen, (ch, wb)),
            torch.ones_like(lo))


BC = band_compare
# the banded kernels, name: (wrapper, plain version, inputs)
KERNELS = {
    "banded_compare_sum": (BC.banded_compare_sum, BC.banded_compare_sum_ref,
                           _sum_args),
    "banded_compare_per_s": (BC.banded_compare_per_s,
                             BC.banded_compare_per_s_ref, _per_s_args),
    "banded_compare_first": (BC.banded_compare_first,
                             BC.banded_compare_first_ref, _first_args),
    "banded_interval_select": (BC.banded_interval_select,
                               BC.banded_interval_select_ref, _interval_args),
}


def _main_shapes() -> dict:
    """The (CH, W) each kernel gets on its path, the timed one first: a
    probe chunk at W = 1 (aggregate, pipeline, descriptors), and
    _extract_blocked's slot blocks at a RING buffer, S side SWB = 4 blocks
    wide, R side RWB = 6."""
    chunk = (band_join._CHUNK_BLOCKS, 1)
    slots = RING // band_compare.LANES
    return {"banded_compare_sum": [chunk],
            "banded_compare_per_s": [chunk, (slots, 6)],
            "banded_compare_first": [chunk],
            "banded_interval_select": [(slots, 4)]}


def _max_err(got, want) -> int:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))


# ---- phases ---------------------------------------------------------------

def phase_report() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    CARD["int_ops_per_s"] = sms * INT32_LANES_PER_SM * sm_mhz * 1e6
    kind = torch.cuda.get_device_name(0)
    print(f"[report] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}; {sms} SMs x "
          f"{INT32_LANES_PER_SM} int32 lanes x {sm_mhz:.0f} MHz = "
          f"{CARD['int_ops_per_s']:.3e} integer operations/s")
    print(smi)
    return kind


def phase_build():
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        kernels = pool.submit(_build.build_kernels)
        host = pool.submit(_build.build_host)
        t_kernels, t_host = kernels.result(), host.result()
    for name in KERNELS:
        band_compare._kernel(name)  # loads the library and binds the symbol
    probe_ranges._kernel()
    for name in ("merge_levels", "merge_level_plan", "merge_level_hbm"):
        merge._kernel(name)
    for name in ("chunks", "strided"):
        experimental_sort._kernel(name)
    merge_sort_bench._kernel()
    for name in construct_probes.ENTRY_POINTS:
        construct_probes._kernel(name)
    if datagen.native_lib() is None:
        raise RuntimeError("native host library did not load")
    print(f"[build] kernels {t_kernels:.2f}s ({_build.KERNEL_LIB}) "
          f"host {t_host:.2f}s ({_build.HOST_LIB}), in parallel")


def phase_kernel() -> dict:
    """Per kernel: max |kernel - plain| over every shape, and both times at
    its first main-path shape."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    stats = {}
    for name, (wrapper, plain, make) in KERNELS.items():
        main = _main_shapes()[name]
        err = 0
        for ch, w in SMALL_SHAPES + main:
            args = make(gen, ch, w * band_compare.LANES)
            err = max(err, _max_err(wrapper(*args), plain(*args)))
            torch.cuda.synchronize()
            if err:
                raise AssertionError(f"{name}: kernel != plain at CH={ch} W={w}"
                                     f" (max abs err {err})")
        ch, w = main[0]
        args = make(gen, ch, w * band_compare.LANES)
        ms = _time_ms(lambda: wrapper(*args), 20)
        plain_ms = _time_ms(lambda: plain(*args), 3)
        out = wrapper(*args)
        bound = _bound(
            _nbytes(*args, *(out if isinstance(out, tuple) else (out,))),
            ch * band_compare.LANES * w * band_compare.LANES * KERNEL_OPS[name])
        stats[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       **bound}
        print(f"[kernel] {name}: equal to plain at (CH, W) in "
              f"{SMALL_SHAPES + main}; at {main[0]}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"by {bound['bound_by']}")
    return stats


# ---- kernel 5: the stream-range probe --------------------------------------

def _range_inputs(gen, rs: np.random.RandomState, tr: int, ts: int,
                  n_tiles: int, n_chunks: int, nch):
    """Synthetic columns (dense keys, full-range payloads) and a plan with
    random chunk-aligned starts and the given chunk counts."""
    cols = (_ints(gen, 0, 24, (n_tiles * tr,)), _full(gen, (n_tiles * tr,)),
            _ints(gen, 0, 24, (n_chunks * ts,)), _full(gen, (n_chunks * ts,)))
    s_start = (rs.randint(0, n_chunks, n_tiles) * ts).astype(np.int32)
    return cols, s_start, np.asarray(nch, np.int32)


def _plan_of(r: Relation, s: Relation, bits: int, tr: int, ts: int):
    """Both sides partitioned on the card, padded, and the range plan."""
    pr = radix_partition(r.keys, r.payload, bits)
    ps = radix_partition(s.keys, s.payload, bits)
    s_start, s_nch = probe_ranges.plan_ranges(
        pr.offsets.cpu().numpy(), ps.offsets.cpu().numpy(), r.num_rows, tr, ts)
    cols = (*probe_ranges.pad_for_probe(pr.keys, pr.payload, tr),
            *probe_ranges.pad_for_probe(ps.keys, ps.payload, ts))
    return cols, s_start, s_nch


def _range_work(cols, s_start, s_nch, tr: int, ts: int):
    """(work items, compares) of one call."""
    tile, _ = probe_ranges._items(s_start, s_nch, cols[2].shape[0], ts)
    return tile.size, tile.size * tr * ts


@functools.lru_cache(maxsize=None)
def _config1_tables():
    """Config 1's keys and full-range payloads (numpy; shared, read only)."""
    rk, sk = datasets.make_pk_fk(*CONFIG1, seed=SEED)
    rng = np.random.RandomState(SEED + 3)
    rp = rng.randint(-2**31, 2**31, rk.size, dtype=np.int64).astype(np.int32)
    sp = rng.randint(-2**31, 2**31, sk.size, dtype=np.int64).astype(np.int32)
    return rk, rp, sk, sp


@functools.lru_cache(maxsize=None)
def _config1_oracles() -> dict:
    """Config 1's answers, computed once for the phases that join it: the
    C++ oracle's aggregate, the numpy oracles' count, pair multiset (padded
    with zero pairs to RING slots) and late sum over 4 R + 2 S seeded
    columns of row-id payloads. Adding 1 to every key on both sides keeps
    every match, so the shifted relations have the same answers."""
    rk, rp, sk, sp = _config1_tables()
    pairs = oracle.join_materialize(rk, rp, sk, sp)
    if pairs.shape[0] > RING:
        raise AssertionError(f"config 1: {pairs.shape[0]} pairs > {RING}")
    pad = np.zeros(RING - pairs.shape[0], np.int32)
    rs = np.random.RandomState(SEED + 4)
    r_cols = rs.randint(-2**31, 2**31, (rk.size, 4), dtype=np.int64).astype(np.int32)
    s_cols = rs.randint(-2**31, 2**31, (sk.size, 2), dtype=np.int64).astype(np.int32)
    ids_r, ids_s = (np.arange(m, dtype=np.int32) for m in CONFIG1)
    return {"aggregate": datagen.oracle_join_aggregate(rk, rp, sk, sp),
            "count": oracle.join_count(rk, sk), "pairs": pairs.shape[0],
            "multiset": _pair_multiset(np.concatenate([pairs[:, 0], pad]),
                                       np.concatenate([pairs[:, 1], pad])),
            "r_cols": r_cols, "s_cols": s_cols,
            "late": oracle.join_late_materialize_sum(rk, ids_r, sk, ids_s,
                                                     r_cols, s_cols)}


def _same_config1_pairs(res, what: str):
    want = _config1_oracles()
    if res.count != want["pairs"] or not np.array_equal(
            _pair_multiset(*(x.cpu().numpy() for x in res.pairs)),
            want["multiset"]):
        raise AssertionError(f"{what}: total {res.count} (oracle "
                             f"{want['pairs']}) or pairs != oracle multiset")


def phase_kernel_ranges() -> dict:
    """Kernel 5 against its plain version: small synthetic and partitioned
    plans, then config 1's full plan, where both are timed."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    rs = np.random.RandomState(SEED)
    plans = [   # (tr, ts, tiles, S chunks, chunks per tile)
        (1024, 1024, 8, 40, [0, 1, 3, 40, 2, 50, 0, 5]),
        (2048, 128, 4, 300, [300, 0, 17, 1]),
        (1024, 1152, 5, 6, [1, 6, 0, 2, 9]),
    ]
    cases = [(_range_inputs(gen, rs, *p), p[0], p[1]) for p in plans]
    rk = rs.permutation(1 << 17)[:1 << 16].astype(np.int32)      # skewed S
    sk = rk[np.minimum(rs.zipf(1.3, 1 << 18) - 1, rk.size - 1)]
    full = lambda n: rs.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    for bits in (6, 10):
        rels = _relations(rk, full(rk.size), sk, full(sk.size))
        cases.append((_plan_of(*rels, bits, 1024, 1024), 1024, 1024))
    rels = _relations(*_config1_tables())
    cases.append((_plan_of(*rels, 13, RANGE_TILE, RANGE_TILE), RANGE_TILE,
                  RANGE_TILE))
    del rels
    err, shapes = 0, []
    for (cols, s_start, s_nch), tr, ts in cases:
        args = (*cols, s_start, s_nch)
        got = probe_ranges.probe_aggregate_ranges(*args, tile_r=tr, tile_s=ts)
        want = probe_ranges.probe_aggregate_ranges_ref(*args, tile_r=tr,
                                                       tile_s=ts)
        err = max(err, _max_err(got, want))
        torch.cuda.synchronize()
        items, compares = _range_work(cols, s_start, s_nch, tr, ts)
        shapes.append(f"{tr}x{ts}:{items} items, max {int(s_nch.max())} chunks")
        if err:
            raise AssertionError(f"probe_aggregate_ranges: kernel != plain at "
                                 f"{shapes[-1]} (max abs err {err})")
    (cols, s_start, s_nch), tr, ts = cases[-1]
    args = (*cols, s_start, s_nch)
    fn = lambda: probe_ranges.probe_aggregate_ranges(*args, tile_r=tr, tile_s=ts)
    ms = _time_ms(fn, 20)
    plain_ms = _time_ms(lambda: probe_ranges.probe_aggregate_ranges_ref(
        *args, tile_r=tr, tile_s=ts), 3)
    items, compares = _range_work(*cases[-1][0], tr, ts)
    # the four columns read once, and the scalar written
    bound = _bound(_nbytes(*cols) + 4,
                   compares * KERNEL_OPS["probe_aggregate_ranges"])
    print(f"[kernel] probe_aggregate_ranges: equal to plain at {shapes}; at "
          f"config 1's plan ({items} items, {compares:.3e} compares): kernel "
          f"{ms:.4f} ms ({compares / ms / 1e9:.3f} T compares/s), plain "
          f"{plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms by "
          f"{bound['bound_by']}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound}


# ---- kernels 6 and 7: the merge sort ----------------------------------------

def _sort_inputs(gen, n: int, lo: int, hi: int):
    """Keys in [lo, hi) (callers keep the masking sentinels out) and
    full-range payloads."""
    return _ints(gen, lo, hi, (n,)), _full(gen, (n,))


def _encoded_runs(sv, pv, run: int):
    """(sv, pv) as sorted runs of `run` in the cascade's layout: run r
    ascending by its stored value, stored = actual ^ -(r & 1)."""
    mask = merge._run_parity_mask(sv.shape[0], run, sv.device)
    s2, idx = torch.sort(sv.view(-1, run) ^ mask, dim=1)
    return s2.view(-1), torch.gather(pv.view(-1, run), 1, idx).view(-1)


def _same_pairs(got, want, what: str) -> int:
    """Keys and payloads exactly equal, or an AssertionError."""
    err = _max_err(got, want)
    torch.cuda.synchronize()
    if err:
        raise AssertionError(f"{what}: kernel != plain (max abs err {err})")
    return err


def _same_plan(sv, run: int, window: int, what: str) -> torch.Tensor:
    """The plan kernel's table, equal to the torch planner's or an
    AssertionError."""
    meta = merge.merge_level_plan(sv, run, window)
    want = merge.merge_level_meta(sv, run, window)
    torch.cuda.synchronize()
    if meta.shape != want.shape or not torch.equal(meta, want):
        raise AssertionError(f"merge_level_plan != merge_level_meta {what}")
    return meta


def _packed_words(sv, pv):
    return (sv.long() << 32) | (pv.long() & 0xFFFFFFFF)


def _check_sorted_pairs(got, sv, pv, what: str):
    """got holds sv ascending and the same (key, payload) multiset."""
    if not torch.equal(got[0], torch.sort(sv).values):
        raise AssertionError(f"{what}: keys != torch.sort")
    if not torch.equal(torch.sort(_packed_words(*got)).values,
                       torch.sort(_packed_words(sv, pv)).values):
        raise AssertionError(f"{what}: (key, payload) multiset changed")


def _wall_ms(fn) -> float:
    """Wall time of one synchronised call (for host-bound steps)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


LEVEL_SHAPES = [   # kernel 6: (n, run_len, levels, key lo, key hi)
    (1 << 16, 256, 3, 0, 64),                   # duplicate-heavy
    (1 << 16, 128, 1, -2**31 + 1, 2**31 - 1),   # full range, 256-pair blocks
    (1 << 17, 4096, 2, -2**31 + 1, 2**31 - 1),  # 8 blocks: odd parities
    (1 << 15, 512, 5, 0, 64),                   # five levels in one block
]
TILE_SHAPES = [    # kernel 7: (n, run_len, window, key lo, key hi)
    (1 << 16, 1 << 14, 8192, 0, 64),   # two pairs, five tiles each, the
    (1 << 16, 1 << 14, 8192, -2**31 + 1, 2**31 - 1),   # fourth 512 rows
    (1 << 17, 1 << 13, 8192, -1000, 1000),      # run_len == window
    (1 << 15, 1 << 12, 1024, 0, 64),            # a smaller window
    (1 << 16, 1 << 13, 4096, 0, 64),            # two blocks a multiprocessor
    (1 << 12, 1 << 10, 256, -5, 5),             # the least window: one warp
    (1 << 21, 1 << 19, 8192, 0, 16),            # duplicate-heavy, long runs
    (1 << 20, 1 << 16, 4096, 0, 16),
]
WINDOWS = (merge.HBM_WINDOW, 4096)   # kernel 7 is timed at both


def phase_kernel_merge() -> dict:
    """Kernels 6 and 7 against their plain versions, then the 2^27 cascade
    level by level, then the whole sorts. Returns the two kernels' stats."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 6)
    for n, run, levels, lo, hi in LEVEL_SHAPES:
        es, ep = _encoded_runs(*_sort_inputs(gen, n, lo, hi), run)
        _same_pairs(merge.merge_levels_vmem(es, ep, run, levels),
                    merge.merge_levels_vmem_ref(es, ep, run, levels),
                    f"merge_levels_vmem at {(n, run, levels)}")
    for n, run, window, lo, hi in TILE_SHAPES:
        es, ep = _encoded_runs(*_sort_inputs(gen, n, lo, hi), run)
        meta = _same_plan(es, run, window, f"at {(n, run, window)}")
        valid = (meta[3] - meta[2]) + (meta[5] - meta[4])
        if (run, window) == (1 << 14, 8192) and int(valid.min()) != 512:
            raise AssertionError(f"no short tile at {(n, run, window)}")
        want = merge.merge_tiles_ref(es, ep, meta, window)
        _same_pairs(merge.merge_tiles(es, ep, meta, window), want,
                    f"merge_level_hbm at {(n, run, window)}")
    print(f"[kernel merge] merge_levels_vmem equal to plain at (n, run, "
          f"levels) in {[c[:3] for c in LEVEL_SHAPES]}; merge_level_plan's "
          f"table equal to merge_level_meta's and merge_level_hbm equal to "
          f"plain at (n, run, window) "
          f"in {[c[:3] for c in TILE_SHAPES]}, the short second-to-last tile "
          f"and keys in [0, 16) at 2^20 and 2^21 pairs included")

    # the cascade at 2^27, level by level
    n = 1 << SORT_SCALE
    sv, pv = _sort_inputs(gen, n, -2**31 + 1, 2**31 - 1)
    base_ms = _time_ms(lambda: merge.encode_base_runs(sv, pv), 3)
    es, ep = merge.encode_base_runs(sv, pv)
    run, levels = merge.BASE_RUN, 2
    k6 = lambda: merge.merge_levels_vmem(es, ep, run, levels)
    k6_plain = lambda: merge.merge_levels_vmem_ref(es, ep, run, levels)
    stats = {"merge_levels_vmem": {
        "max_abs_err": _same_pairs(k6(), k6_plain(),
                                   f"merge_levels_vmem at 2^{SORT_SCALE}"),
        "ms": _time_ms(k6, 10), "plain_ms": _time_ms(k6_plain, 1),
        # 13 + 14 stages of n / 2 exchanges
        **_bound(16 * n, 27 * (n // 2) * KERNEL_OPS["merge_levels_vmem"])}}
    cur = k6()
    del es, ep
    run <<= levels
    plan_ms, plan_kernel_ms, tile_ms, shown = [], [], [], {}
    while run < n:
        # the plan kernel's table against the torch planner's, at every level
        meta = _same_plan(cur[0], run, merge.HBM_WINDOW,
                          f"at 2^{SORT_SCALE}, run {run}")
        plan_ms.append(_wall_ms(lambda: merge.merge_level_meta(cur[0], run)))
        plan_kernel_ms.append(
            _time_ms(lambda: merge.merge_level_plan(cur[0], run), 5))
        k7 = lambda: merge.merge_tiles(*cur, meta)
        tile_ms.append(_time_ms(k7, 3))
        if run in (1 << 14, n // 2):      # the first, widest level; the last
            shown[run] = by_window = {}
            for w in WINDOWS:
                m = meta if w == merge.HBM_WINDOW else _same_plan(
                    cur[0], run, w, f"at 2^{SORT_SCALE}, run {run}, window {w}")
                k7w = lambda: merge.merge_tiles(*cur, m, w)
                k7_plain = lambda: merge.merge_tiles_ref(*cur, m, w)
                err = _same_pairs(k7w(), k7_plain(), f"merge_level_hbm at "
                                  f"2^{SORT_SCALE}, run {run}, window {w}")
                ntiles = m.shape[1]
                stages = (2 * w).bit_length() - 1
                by_window[w] = {
                    "max_abs_err": err, "ms": _time_ms(k7w, 3),
                    "plain_ms": _time_ms(k7_plain, 1), "ntiles": ntiles,
                    # the function's work: the n valid rows through the
                    # log2(2 * window) stages, n / 2 exchanges each. The
                    # kernel's networks also carry masked junk and each
                    # pair's re-covering tile: `network_exchanges`, not in
                    # the bound
                    "network_exchanges": ntiles * stages * w,
                    **_bound(16 * n + _nbytes(m),
                             stages * (n // 2) * KERNEL_OPS["merge_level_hbm"])}
                del m
        cur = k7()
        run <<= 1
    _check_sorted_pairs(cur, sv, pv, "the cascade, level by level")
    del cur, meta
    first, last = (shown[r][merge.HBM_WINDOW] for r in (1 << 14, n // 2))
    # the row's required keys are the first level's (run 2^14) at the default
    # window; the last level's, window 4096 at both, the plan kernel and the
    # sums over all levels of one sort stand beside them
    stats["merge_level_hbm"] = {
        **first,
        "max_abs_err": max(c["max_abs_err"] for by in shown.values()
                           for c in by.values()),
        "last_level": last,
        "window_4096": {"first_level": shown[1 << 14][4096],
                        "last_level": shown[n // 2][4096]},
        "levels": len(tile_ms), "levels_ms": sum(tile_ms),
        "levels_planner_wall_ms": sum(plan_ms),
        "levels_plan_kernel_ms": sum(plan_kernel_ms),
        "plan_ms": plan_kernel_ms[0], "plan_torch_wall_ms": plan_ms[0]}
    k6s = stats["merge_levels_vmem"]
    print(f"[kernel merge] 2^{SORT_SCALE} cascade: base runs {base_ms:.3f} "
          f"ms; merge_levels_vmem (run 4096, 2 levels) {k6s['ms']:.4f} ms, "
          f"plain {k6s['plain_ms']:.3f} ms, bound {k6s['bound_ms']:.4f} ms by "
          f"{k6s['bound_by']}; merge_level_hbm at run 2^14 ({first['ntiles']} "
          f"tiles) {first['ms']:.4f} ms, plain {first['plain_ms']:.3f} ms, "
          f"bound {first['bound_ms']:.4f} ms by {first['bound_by']}; at run "
          f"2^{SORT_SCALE - 1} ({last['ntiles']} tiles) {last['ms']:.4f} ms, "
          f"plain {last['plain_ms']:.3f} ms, bound {last['bound_ms']:.4f} ms "
          f"by {last['bound_by']}; all equal to plain; {len(tile_ms)} levels: kernel "
          f"{sum(tile_ms):.3f} ms ({', '.join(f'{t:.3f}' for t in tile_ms)}); "
          f"the plan kernel "
          f"{sum(plan_kernel_ms):.4f} ms "
          f"({', '.join(f'{t:.4f}' for t in plan_kernel_ms)}), its table equal "
          f"to the torch planner's at every level, which takes "
          f"{sum(plan_ms):.3f} ms wall "
          f"({', '.join(f'{t:.3f}' for t in plan_ms)}); window 4096 (equal to "
          f"plain) at run 2^14 / 2^{SORT_SCALE - 1}: "
          + " / ".join(
              f"{shown[r][4096]['ms']:.4f} ms ({shown[r][4096]['ntiles']} "
              f"tiles)" for r in (1 << 14, n // 2))
          + f", beside {first['ms']:.4f} / {last['ms']:.4f} at 8192")

    # the whole sorts
    merge.reset_launches()
    got = merge.merge_sort_pairs(sv, pv)
    _check_sorted_pairs(got, sv, pv, "merge_sort_pairs")
    if merge.ROUTES != {"cascade": 1, "fallback": 0}:
        raise AssertionError(f"merge_sort_pairs took {merge.ROUTES}")
    got = merge.packed_sort_pairs(sv, pv)
    # element for element: payloads ascending as uint32 within a key, by
    # two stable sorts
    order = torch.sort(pv.long() & 0xFFFFFFFF, stable=True).indices
    order = order[torch.sort(sv[order], stable=True).indices]
    if not (torch.equal(got[0], sv[order]) and torch.equal(got[1], pv[order])):
        raise AssertionError("packed_sort_pairs != the two-key stable sort")
    del got, order
    library = lambda: band_join.sort_pairs(sv, pv, "lax")
    times = {name: min(_wall_ms(fn) for _ in range(REPS)) for name, fn in (
        ("merge", lambda: merge.merge_sort_pairs(sv, pv)),
        ("packed", lambda: merge.packed_sort_pairs(sv, pv)),
        ("torch.sort + gather", library))}
    print(f"[kernel merge] 2^{SORT_SCALE} pairs, best of {REPS}, wall: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + "; merge and packed hold torch.sort's keys and the same pairs")
    return stats


# ---- kernels 8, 9, 10 and the sort tools --------------------------------------

def _tile_keys(gen, kind: str, n: int) -> torch.Tensor:
    if kind == "distinct":
        return (torch.randperm(n, generator=gen, device=DEVICE)
                - n // 2).to(torch.int32)
    if kind == "dup16":
        return _ints(gen, 0, 16, (n,))
    keys = _full(gen, (n,))           # full range, both extremes present
    keys[n // 3], keys[n // 2] = merge.INT_MIN, merge.INT_MAX
    return keys


SORT_TILE_SHAPES = [   # (tile, tiles, keys)
    (1024, 5, "distinct"), (1024, 3, "dup16"), (1024, 7, "full"),
    (1 << 15, 4, "distinct"), (1 << 15, 2, "dup16"), (1 << 15, 3, "full"),
    # tiles that reach the strided passes; 2^22: two passes for its last merge
    (1 << 17, 3, "dup16"), (1 << 17, 2, "full"),
    (1 << 20, 2, "dup16"), (1 << 20, 1, "full"), (1 << 22, 1, "distinct"),
]


def phase_kernel_sort_tiles() -> tuple:
    """Kernel 8 against its plain version, keys and payloads exactly equal:
    small shapes, then the headline width at the reference's default tile,
    with both times and the library call beside them. Returns (its stats,
    its launch count on that call)."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 8)
    es = experimental_sort
    survivors = []
    for tile, tiles, kind in SORT_TILE_SHAPES:
        n = tile * tiles
        sv = _tile_keys(gen, kind, n)
        pay = torch.randperm(n, generator=gen, device=DEVICE).to(torch.int32)
        got = es.sort_tiles(sv, pay, tile)
        _same_pairs(got, es.sort_tiles_ref(sv, pay, tile),
                    f"sort_tiles at {(tile, tiles, kind)}")
        if not torch.equal(got[0], torch.sort(sv.view(tiles, tile), dim=1)
                           .values.view(-1)):
            raise AssertionError(f"sort_tiles at {(tile, tiles, kind)}: keys "
                                 f"!= torch.sort")
        if kind == "dup16":
            survivors.append(f"{int(torch.unique(got[1]).numel())} of {n} at "
                             f"tile {tile}")
        elif kind == "distinct" and int(torch.unique(got[1]).numel()) != n:
            raise AssertionError("sort_tiles lost a payload on distinct keys")
    print(f"[kernel sort tiles] sort_tiles equal to plain at (tile, tiles, "
          f"keys) in {SORT_TILE_SHAPES}; on keys in [0, 16) the element-wise "
          f"exchange writes one payload of an equal pair twice and loses the "
          f"other, as the reference's kernel does: distinct payloads that "
          f"survive, kernel and plain alike: {', '.join(survivors)}")

    lg, tile = SORT_TILES
    n = 1 << lg
    sv = _tile_keys(gen, "distinct", n)
    pay = _full(gen, (n,))
    kernel = lambda: es.sort_tiles(sv, pay, tile)
    plain = lambda: es.sort_tiles_ref(sv, pay, tile)

    def library():
        keys, idx = torch.sort(sv.view(-1, tile), dim=1)
        return keys.view(-1), torch.gather(pay.view(-1, tile), 1, idx).view(-1)

    got, launches = _launched(kernel)
    _require(launches, "sort_tiles", "sort_tiles")
    err = _same_pairs(got, plain(), f"sort_tiles at 2^{lg}, tile {tile}")
    _same_pairs(got, library(), "sort_tiles against torch.sort along dim 1")
    del got
    stages = tile.bit_length() - 1
    stages = stages * (stages + 1) // 2
    stats = {"max_abs_err": err, "ms": _time_ms(kernel, 3),
             "plain_ms": _time_ms(plain, 1),
             **_bound(16 * n, stages * (n // 2) * KERNEL_OPS["sort_tiles"]),
             "library_ms": _time_ms(library, 3), "stages": stages,
             # where the time goes: one launch (tile 2^14), then the first
             # merge that takes a strided pass and a chunk pass besides
             "by_tile_ms": {t: _time_ms(lambda: es.sort_tiles(sv, pay, t), 3)
                            for t in (1 << 14, 1 << 15) if t < tile}}
    print(f"[kernel sort tiles] n = 2^{lg}, tile {tile} ({stages} stages), "
          f"distinct keys: kernel {stats['ms']:.4f} ms "
          f"({n / stats['ms'] / 1e3:.1f} Melem/s), plain "
          f"{stats['plain_ms']:.3f} ms, torch.sort of [{n // tile}, {tile}] "
          f"along dim 1 + gather {stats['library_ms']:.4f} ms, bound "
          f"{stats['bound_ms']:.4f} ms by {stats['bound_by']}; all three equal; "
          f"the same pairs by tile: "
          + ", ".join(f"{t}: {ms:.4f} ms ({len(es.launch_schedule(t.bit_length() - 1))}"
                      f" launches)" for t, ms in stats["by_tile_ms"].items())
          + f", {tile}: {len(es.launch_schedule(tile.bit_length() - 1))} launches")
    return stats, launches["sort_tiles"]


def phase_kernel_stage() -> tuple:
    """Kernel 9 against its plain version: every distance at a small tile in
    shared memory and at one in device memory, then `bench_stages` through
    its entry point, then its eight cases held against the plain version at
    the same reps and timed beside it. Returns (stats, launches of
    `bench_stages`)."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 9)
    msb = merge_sort_bench
    shapes = []
    for tile, tiles, lo, hi in ((1 << 12, 4, 0, 64),
                                (1 << 15, 2, -2**31, 2**31)):
        sv, pv = _sort_inputs(gen, tile * tiles, lo, hi)
        for d in (1 << j for j in range(tile.bit_length() - 1)):
            for reps in (1, 3):
                _same_pairs(msb.stage_reps(sv, pv, d, reps, tile),
                            msb.stage_reps_ref(sv, pv, d, reps, tile),
                            f"stage_reps at {(tile, d, reps)}")
        shapes.append(f"tile {tile} ({msb.stage_memory(tile)} memory), "
                      f"d = 1 .. {tile // 2}, reps 1 and 3")
    print(f"[kernel stage] stage_reps equal to plain at {'; '.join(shapes)}")

    res, launches = _launched(lambda: msb.bench_stages(STAGE_SCALE, DEVICE))
    _require(launches, "bench_stages", "stage_reps", "merge_levels_vmem")
    if not msb.correct(res):
        raise AssertionError(f"bench_stages: a stage != its plain version: {res}")

    n, reps = 1 << STAGE_SCALE, msb.REPS
    sv, pv = _sort_inputs(gen, n, -2**31, 2**31)
    cases = {}
    for name, d, tile in msb.stage_cases(n):
        kernel = lambda: msb.stage_reps(sv, pv, d, reps, tile)
        plain = lambda: msb.stage_reps_ref(sv, pv, d, reps, tile)
        err = _same_pairs(kernel(), plain(), f"stage_reps at {(name, d, tile)}")
        ms = _time_ms(kernel, 5)
        bound = _bound(16 * n, reps * (n // 2) * KERNEL_OPS["stage_reps"])
        cases[name] = {
            "d": d, "tile": tile, "memory": msb.stage_memory(tile),
            "max_abs_err": err, "ms": ms, "plain_ms": _time_ms(plain, 1),
            "Gelem_stage_s": n * reps / ms / 1e6,
            "bench_Gelem_stage_s": res[f"{name}_Gelem_stage_s"], **bound,
            # what `reps` passes over device memory must move
            "passes_bound_ms": bound["bound_ms"] * (
                reps if msb.stage_memory(tile) == "global" else 1)}
    first = next(iter(cases))
    stats = {**{k: cases[first][k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "at": first, "cases": cases, "vmem_level_ms": res["vmem_level_ms"]}
    print(f"[kernel stage] n = 2^{STAGE_SCALE}, reps {reps}, equal to plain; "
          + "; ".join(
              f"{name} (d {c['d']}, tile {c['tile']}, {c['memory']}) "
              f"{c['ms']:.4f} ms = {c['Gelem_stage_s']:.1f} Gelem-stage/s, "
              f"plain {c['plain_ms']:.3f} ms" for name, c in cases.items())
          + f"; bound {cases[first]['bound_ms']:.4f} ms by "
          f"{cases[first]['bound_by']} (each input read once; {reps} passes "
          f"over device memory: {cases[first]['passes_bound_ms']:.4f} ms); one "
          f"in-block merge level at tile {res['vmem_level_tile']}: "
          f"{res['vmem_level_ms']:.4f} ms")
    return stats, launches["stage_reps"]


def phase_probes() -> tuple:
    """The whole ladder of construct probes through its entry point. Returns
    (stats of the probe kernels, their launches on that run)."""
    cp = construct_probes
    lines, launches = _launched(lambda: cp.run_probes(device=DEVICE))
    _require(launches, "construct probes", "construct_probes",
             "merge_levels_vmem", "merge_level_hbm")
    bad = [line for line in lines if not line["ok"]]
    if bad or [line["probe"] for line in lines] != [n for n, _ in cp.PROBES]:
        raise AssertionError(f"construct probes failed: {bad or lines}")
    by_name = {line["probe"]: line for line in lines}
    mine = {name: by_name[name] for name in cp.CONSTRUCTS}
    ops = sum(stages * exchanges * KERNEL_OPS["construct_probes"]
              for stages, exchanges in PROBE_EXCHANGES.values())
    stats = {"max_abs_err": 0,
             "ms": sum(line["ms"] for line in mine.values()),
             "plain_ms": sum(line["plain_ms"] for line in mine.values()),
             **_bound(4 * sum(PROBE_ELEMENTS.values()), ops),
             "probes": len(mine),
             "probe_ms": {name: line["ms"] for name, line in by_name.items()},
             "probe_plain_ms": {name: line["plain_ms"]
                                for name, line in by_name.items()}}
    print(f"[probes] {len(lines)} probes ok, each equal to its plain version; "
          f"ms, kernel / plain: " + ", ".join(
              f"{n} {l['ms']:.4f} / {l['plain_ms']:.3f}" for n, l in by_name.items())
          + f"; the {len(mine)} probe kernels together {stats['ms']:.4f} ms, "
          f"bound {stats['bound_ms']:.6f} ms by {stats['bound_by']}; "
          f"launches {launches}")
    return stats, launches["construct_probes"]


def phase_sort_tools():
    """`bench_packed`, `bench_full` and `merge_fix_validate` through their
    entry points, each result checked."""
    msb = merge_sort_bench
    packed = msb.bench_packed(TOOLS_SCALE, DEVICE)
    full, launches = _launched(lambda: msb.bench_full(TOOLS_SCALE, DEVICE))
    _require(launches, "bench_full", "merge_levels_vmem", "merge_level_hbm")
    if not (msb.correct(packed) and msb.correct(full)):
        raise AssertionError(f"bench_packed / bench_full: a wrong sort: "
                             f"{packed} {full}")
    fits = [name for name, _ in msb.FULL_VARIANTS if f"{name}_ms" in full]
    if fits != ["merge", "merge_w4k", "merge_w2k"] or (
            "merge_w32k_error" not in full):
        raise AssertionError(f"bench_full: variants that ran {fits}: {full}")
    for lg in VALIDATE_SCALES:
        (check, speed), launches = _launched(
            lambda: merge_fix_validate.validate(lg, DEVICE))
        _require(launches, f"merge_fix_validate 2^{lg}", "merge_levels_vmem",
                 "merge_level_hbm")
        if not (check["keys_ok"] and check["pairs_ok"] and check["cascade"]):
            raise AssertionError(f"merge_fix_validate at 2^{lg}: {check}")
    # `bench_full` times whole calls; the merge-path kernel alone, by window,
    # at the first level
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 7)
    n, run = 1 << TOOLS_SCALE, merge.DEVICE_VMEM_TILE
    es, ep = _encoded_runs(*_sort_inputs(gen, n, -2**30, 2**30), run)
    alone = {}
    for name, geometry in msb.FULL_VARIANTS:
        window = geometry.get("hbm_window", merge.HBM_WINDOW)
        if f"{name}_ms" in full:
            meta = merge.merge_level_plan(es, run, window)
            alone[window] = (_time_ms(
                lambda: merge.merge_tiles(es, ep, meta, window), 10),
                meta.shape[1])
    print(f"[sort tools] bench_packed and bench_full at 2^{TOOLS_SCALE} and "
          f"merge_fix_validate at 2^{VALIDATE_SCALES} correct (their lines "
          f"above); window 32768: {full['merge_w32k_error']}; the merge-path "
          f"kernel alone at 2^{TOOLS_SCALE} pairs, run {run}, by window: "
          + ", ".join(f"{w}: {ms:.4f} ms ({tiles} tiles)"
                      for w, (ms, tiles) in alone.items()))


def _relations(rk, rp, sk, sp):
    return (Relation.from_numpy(rk, rp, device=DEVICE),
            Relation.from_numpy(sk, sp, device=DEVICE))


def _max_rounds(r: Relation, s: Relation, w: int) -> int:
    r_sv, _ = band_join.sort_by_key(r.keys, r.payload)
    s_sv, _ = band_join.sort_by_key(s.keys, s.payload)
    lo, hi = band_join.block_windows(r_sv, s_sv)
    return int(((hi - lo + (w - 1)) // w).max())


def phase_mid():
    engine = ClusteredJoin(device=DEVICE)
    n = 1 << MID_SCALE
    rk, sk = datasets.make_pk_fk(n, n, seed=SEED)
    ones = np.ones(n, np.int32)
    r, s = _relations(rk, ones, sk, ones)
    want = _oracle_value(MID_SCALE, 0.0)
    uni = engine.aggregate(r, s).aggregate   # warm-up
    t_uni, uni = _best_s(lambda: engine.aggregate(r, s).aggregate)
    if uni != want:
        raise AssertionError(f"2^{MID_SCALE} uniform: {uni} != oracle {want}")

    n = 1 << (MID_SCALE - 2)
    rk, sk = datasets.make_pk_fk(n, n, skew=1.05, seed=SEED)
    rng = np.random.RandomState(SEED)
    rp = rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    sp = rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    r, s = _relations(rk, rp, sk, sp)
    got = engine.aggregate(r, s).aggregate
    want = datagen.oracle_join_aggregate(rk, rp, sk, sp)
    if got != want:
        raise AssertionError(f"zipf 1.05: {got} != C++ oracle {want}")
    rounds = _max_rounds(r, s, engine.config.band_window_blocks)
    print(f"[mid] 2^{MID_SCALE} uniform = {uni} (oracle), best of {REPS} "
          f"{t_uni * 1e3:.3f} ms; 2^{MID_SCALE - 2} zipf1.05 = {got} "
          f"(C++ oracle {want}), max rounds {rounds}")


def phase_headline():
    """Returns the launch counts of one join and its inputs (numpy keys,
    device keys) for the ring leg."""
    n = 1 << HEADLINE_SCALE
    t0 = time.perf_counter()
    rk, sk = datasets.make_pk_fk(n, n, seed=SEED)
    ones = np.ones(n, np.int32)
    r, s = _relations(rk, ones, sk, ones)
    t_data = time.perf_counter() - t0
    want = _oracle_value(HEADLINE_SCALE, 0.0)
    engine = ClusteredJoin(device=DEVICE)
    torch.cuda.reset_peak_memory_stats()

    res, launches = _launched(lambda: engine.aggregate(r, s))
    _require(launches, "headline", "banded_compare_sum")
    if res.aggregate != want:
        raise AssertionError(f"headline: {res.aggregate} != oracle {want}")
    best, agg = _best_s(lambda: engine.aggregate(r, s).aggregate)
    if agg != want:
        raise AssertionError(f"headline: {agg} != oracle {want}")
    peak = torch.cuda.max_memory_allocated()
    rounds = _max_rounds(r, s, engine.config.band_window_blocks)
    print(f"[headline] 2^{HEADLINE_SCALE} per side uniform = {agg} "
          f"(oracle {want}); "
          f"best of {REPS} {best * 1e3:.3f} ms, "
          f"{2 * n / best / 1e6:.1f} Mrows/s; peak device memory "
          f"{peak / 2**30:.2f} GiB; chunk {band_join._CHUNK_BLOCKS} blocks; "
          f"rounds {rounds}; launches per join {launches}; "
          f"data {t_data:.1f}s")
    return launches, (rk, sk, r.keys, s.keys)


def _sort_engine(impl: str, **kw) -> ClusteredJoin:
    return ClusteredJoin(EngineConfig(sort_impl=impl, **kw), device=DEVICE)


def _expect_cascade(launches: dict, path: str, levels_launches: int,
                    tile_launches: int, sorts: int):
    got = (launches["merge_levels_vmem"], launches["merge_level_hbm"],
           dict(merge.ROUTES))
    if launches["merge_level_plan"] != launches["merge_level_hbm"]:
        raise AssertionError(f"{path}: {launches['merge_level_plan']} plans "
                             f"for {launches['merge_level_hbm']} merge-path "
                             f"levels")
    want = (levels_launches, tile_launches,
            {"cascade": sorts if levels_launches else 0,
             "fallback": 0 if levels_launches else sorts})
    if got != want:
        raise AssertionError(f"{path}: launches and routes {got} != {want}")


def phase_sorts(big) -> dict:
    """`sort_impl` "merge" and "packed" through the engine. Returns the
    launch counts of one 2^27 aggregate under "merge"."""
    _, _, r_keys, s_keys = big
    n = r_keys.shape[0]
    ones = torch.ones_like(r_keys)
    want = _oracle_value(HEADLINE_SCALE, 0.0)
    # every key plus 1: the same join, and no sort value is a sentinel
    r, s = Relation(r_keys + 1, ones), Relation(s_keys + 1, ones)
    lines = []
    for impl in ("merge", "packed"):
        engine = _sort_engine(impl)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res, launches = _launched(lambda: engine.aggregate(r, s))
        if impl == "merge":
            # two sorts: kernel 6 once, the plan kernel and kernel 7 on 13
            # levels each
            _expect_cascade(launches, "2^27 merge", 2, 26, 2)
            head, routes = launches, dict(merge.ROUTES)
        _require(launches, f"2^27 {impl}", "banded_compare_sum")
        best, agg = _best_s(lambda: engine.aggregate(r, s).aggregate)
        peak = torch.cuda.max_memory_allocated()
        if res.aggregate != want or agg != want:
            raise AssertionError(f"2^27 {impl}: {agg} != oracle {want}")
        lines.append(f"2^{HEADLINE_SCALE} per side, keys + 1, {impl!r} = "
                     f"oracle, best of {REPS} {best * 1e3:.3f} ms "
                     f"({2 * n / best / 1e6:.1f} Mrows/s), peak "
                     f"{peak / 2**30:.2f} GiB")
    lines[0] += f", launches per call {head}, routes {routes}"
    del r, s
    r, s = Relation(r_keys, ones), Relation(s_keys, ones)
    res, launches = _launched(lambda: _sort_engine("merge").aggregate(r, s))
    _expect_cascade(launches, "2^27 merge, key 0 present", 0, 0, 2)
    if res.aggregate != want:
        raise AssertionError(f"2^27 merge fallback: {res.aggregate} != {want}")
    lines.append(f"unshifted under 'merge' = oracle, no merge launches, "
                 f"routes {merge.ROUTES} (key 0 sorts as a sentinel)")
    del r, s, ones

    # config 1, keys plus 1, under "merge"
    rk, rp, sk, sp = _config1_tables()
    rk, sk = rk + 1, sk + 1
    r, s = _relations(rk, rp, sk, sp)
    want1 = _config1_oracles()
    ranges = _sort_engine("merge", probe_mode="pallas")
    res, launches = _launched(lambda: ranges.aggregate(r, s))
    # partitions of 2^20 and 2^24 rows: 6 + 10 merge-path levels
    _expect_cascade(launches, "pallas config 1 merge", 2, 16, 2)
    _require(launches, "pallas config 1 merge", "probe_aggregate_ranges")
    t_c1, agg = _best_s(lambda: ranges.aggregate(r, s).aggregate)
    if res.aggregate != want1["aggregate"] or agg != want1["aggregate"]:
        raise AssertionError(f"pallas config 1 merge: {agg} != "
                             f"{want1['aggregate']}")
    banded = _sort_engine("merge")
    res, launches = _launched(lambda: banded.materialize(r, s, capacity=RING))
    _expect_cascade(launches, "materialize config 1 merge", 2, 16, 2)
    t_mat, res = _best_s(lambda: banded.materialize(r, s, capacity=RING))
    _same_config1_pairs(res, "materialize config 1 merge")
    del res
    r_ids = Relation.from_numpy(rk, device=DEVICE)   # payloads: row ids
    s_ids = Relation.from_numpy(sk, device=DEVICE)
    rc, sc = (torch.from_numpy(want1[c]).to(DEVICE)
              for c in ("r_cols", "s_cols"))
    late, launches = _launched(
        lambda: banded.late_aggregate(r_ids, s_ids, rc, sc).aggregate)
    _expect_cascade(launches, "late config 1 merge", 2, 16, 2)
    t_late, late = _best_s(
        lambda: banded.late_aggregate(r_ids, s_ids, rc, sc).aggregate)
    if late != want1["late"]:
        raise AssertionError(f"late config 1 merge {late} != {want1['late']}")
    lines.append(f"config 1, keys + 1, 'merge' (2 + 16 merge launches each): "
                 f"'pallas' = C++ oracle {t_c1 * 1e3:.3f} ms, materialize "
                 f"into {RING} = oracle multiset {t_mat * 1e3:.3f} ms, late "
                 f"4 + 2 columns = oracle {t_late * 1e3:.3f} ms (best of "
                 f"{REPS} each)")
    del r, s, r_ids, s_ids, rc, sc

    # config 3 under "packed"
    c = C3
    inputs = datasets.make_config3(*C3_PACKED, c["groups"])
    want3 = _direct_config3_oracle(*inputs, c["lo"], c["hi"], c["groups"])
    args = [torch.from_numpy(a).to(DEVICE) for a in inputs]
    packed = lambda: pipelines.filter_probe_groupby(
        *args, c["lo"], c["hi"], c["groups"], sort_impl="packed")
    got, launches = _launched(packed)
    _require(launches, "config 3 packed", "banded_compare_per_s")
    t_c3, got = _best_s(packed)
    for g, w, what in zip(got, want3, ("COUNT", "SUM")):
        if not np.array_equal(g.cpu().numpy(), w):
            raise AssertionError(f"config 3 packed {what} != oracle")
    lines.append(f"config 3 at {C3_PACKED[0]} x {C3_PACKED[1]} under 'packed' "
                 f"= direct oracle, best of {REPS} {t_c3 * 1e3:.3f} ms")
    print("[sorts] " + "; ".join(lines))
    return head


def _key_payloads(r_keys, s_keys):
    """(R payloads 7k+1, S payloads k ^ KEY_MIX), numpy or torch int32."""
    if isinstance(r_keys, torch.Tensor):
        return wrap_i32(7 * r_keys.long() + 1), s_keys ^ KEY_MIX
    return ((7 * r_keys.astype(np.int64) + 1).astype(np.int32),
            s_keys ^ np.int32(KEY_MIX))


def _pair_multiset(out_r: np.ndarray, out_s: np.ndarray) -> np.ndarray:
    return np.sort((out_r.astype(np.int64) << 32)
                   | (out_s.astype(np.int64) & 0xFFFFFFFF))


def phase_materialize(big):
    """(a) the fast path at RING rows per side; (b) the config-2 ring on
    the headline's inputs. Returns the launch counts of (a) and (b)."""
    engine = ClusteredJoin(device=DEVICE)
    n = RING
    rk, sk = datasets.make_pk_fk(n, n, seed=SEED)
    rp, sp = _key_payloads(rk, sk)
    r, s = _relations(rk, rp, sk, sp)
    res, fast = _launched(lambda: engine.materialize(r, s, capacity=RING))
    _require(fast, "materialize (a), fast path", "banded_compare_first",
             "banded_interval_select", "banded_compare_per_s")
    t_fast, res = _best_s(lambda: engine.materialize(r, s, capacity=RING))
    want = oracle.join_materialize(rk, rp, sk, sp)
    if res.count != want.shape[0] or want.shape[0] > RING:
        raise AssertionError(f"materialize (a): total {res.count} != "
                             f"oracle {want.shape[0]}")
    pad = np.zeros(RING - want.shape[0], np.int32)
    got = _pair_multiset(*(x.cpu().numpy() for x in res.pairs))
    if not np.array_equal(got, _pair_multiset(np.concatenate([want[:, 0], pad]),
                                              np.concatenate([want[:, 1], pad]))):
        raise AssertionError("materialize (a): pairs != oracle multiset")
    total_a = res.count
    del r, s, res, got, want

    rk, sk, r_keys, s_keys = big
    r, s = (Relation(k, p) for k, p in
            zip((r_keys, s_keys), _key_payloads(r_keys, s_keys)))
    res, ring = _launched(lambda: engine.materialize(r, s, capacity=RING))
    _require(ring, "materialize (b), slot path", "banded_compare_first")
    if ring["banded_interval_select"]:
        raise AssertionError("ring: the fast path ran on a wrapped ring")
    t_ring, res = _best_s(lambda: engine.materialize(r, s, capacity=RING))
    total = res.count
    want_total = _oracle_value(HEADLINE_SCALE, 0.0) & 0xFFFFFFFF
    if total != want_total or total <= RING:
        raise AssertionError(f"ring: total {total} != oracle {want_total}, "
                             f"or no lap around {RING} slots")
    # the S-sorted match stream: every S key, in order, once per R match
    cnt_r = np.bincount(rk)
    s_sorted = np.sort(sk, kind="stable")
    mult = np.where(s_sorted < cnt_r.size,
                    cnt_r[np.minimum(s_sorted, cnt_r.size - 1)], 0)
    stream = np.repeat(s_sorted, mult)
    if stream.size != total:
        raise AssertionError(f"ring: stream {stream.size} != {total}")
    j = np.arange(RING, dtype=np.int64)
    keys = stream[j + RING * ((total - 1 - j) // RING)]  # last lap wins
    exp_r, exp_s = _key_payloads(keys, keys)
    if not (np.array_equal(res.pairs[0].cpu().numpy(), exp_r)
            and np.array_equal(res.pairs[1].cpu().numpy(), exp_s)):
        raise AssertionError("ring != the ring of the sorted S keys")
    print(f"[materialize] (a) {RING} x {RING} into {RING}: {total_a} pairs = "
          f"oracle multiset, fast path, best of {REPS} {t_fast * 1e3:.3f} ms, "
          f"launches {fast}; (b) 2^{HEADLINE_SCALE} per side, ring {RING}: "
          f"total {total} "
          f"(oracle), ring exact, slot path, best of {REPS} "
          f"{t_ring * 1e3:.3f} ms, launches {ring}")
    return fast, ring


def _overflow_rows(rel: Relation) -> int:
    """Build rows past their bucket's slots in the default global table."""
    log_buckets = perfect_hash.default_log_buckets(rel.num_rows)
    return int(perfect_hash.global_ht_build(rel.keys, rel.payload,
                                            log_buckets, 8)[-1])


def _partitioned_config1(lines: list) -> dict:
    """"pallas", "blocked" (aggregate, count, materialize, late aggregate)
    and the global hash table at config 1; returns the "pallas" launches."""
    rk, rp, sk, sp = _config1_tables()
    r, s = _relations(rk, rp, sk, sp)
    oracles = _config1_oracles()
    want = oracles["aggregate"]
    ranges = ClusteredJoin(EngineConfig(probe_mode="pallas"), device=DEVICE)
    res, launches = _launched(lambda: ranges.aggregate(r, s))
    _require(launches, "pallas config 1", "probe_aggregate_ranges")
    t_c1, agg = _best_s(lambda: ranges.aggregate(r, s).aggregate)
    if res.aggregate != want or agg != want:
        raise AssertionError(f"pallas config 1: {agg} != C++ oracle {want}")
    lines.append(f"pallas config 1 = {agg} (C++ oracle), best of {REPS} "
                 f"{t_c1 * 1e3:.3f} ms, launches {launches}")

    blocked = ClusteredJoin(EngineConfig(probe_mode="blocked"), device=DEVICE)
    t_agg, agg = _best_s(lambda: blocked.aggregate(r, s).aggregate)
    cnt = blocked.count(r, s).count
    if agg != want or cnt != oracles["count"]:
        raise AssertionError(f"blocked config 1: aggregate {agg} (oracle "
                             f"{want}), count {cnt}")
    t_mat, res = _best_s(lambda: blocked.materialize(r, s, capacity=RING))
    _same_config1_pairs(res, "blocked materialize")
    del res
    r_ids = Relation.from_numpy(rk, device=DEVICE)   # payloads: row ids
    s_ids = Relation.from_numpy(sk, device=DEVICE)
    rc, sc = (torch.from_numpy(oracles[c]).to(DEVICE)
              for c in ("r_cols", "s_cols"))
    t_late, late = _best_s(
        lambda: blocked.late_aggregate(r_ids, s_ids, rc, sc).aggregate)
    if late != oracles["late"]:
        raise AssertionError(f"blocked late aggregate {late} != "
                             f"{oracles['late']}")
    lines.append(f"blocked config 1 ({default_bits_for(CONFIG1[1], 256)} "
                 f"bits): aggregate {t_agg * 1e3:.3f} ms, count = {cnt}, "
                 f"materialize into {RING} = oracle multiset "
                 f"{t_mat * 1e3:.3f} ms, late 4 + 2 columns = oracle "
                 f"{t_late * 1e3:.3f} ms (best of {REPS} each)")
    del r_ids, s_ids, rc, sc

    t_ht, ht = _best_s(lambda: int(perfect_hash.global_ht_join_aggregate(
        r.keys, r.payload, s.keys, s.payload)))
    if ht != want:
        raise AssertionError(f"global hash table config 1: {ht} != {want}")
    lines.append(f"global_ht config 1 = oracle, best of {REPS} "
                 f"{t_ht * 1e3:.3f} ms, {_overflow_rows(r)} overflow rows")
    return launches


def _partitioned_zipf(lines: list):
    """"pallas" at 2^22 Zipf z=1.05, and the global hash table built on
    the Zipf side, whose chains overflow into the banded fallback."""
    n = 1 << (MID_SCALE - 2)
    zk_r, zk_s = datasets.make_pk_fk(n, n, skew=1.05, seed=SEED)
    zrng = np.random.RandomState(SEED)
    zp_r = zrng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    zp_s = zrng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    zr, zs = _relations(zk_r, zp_r, zk_s, zp_s)
    ranges = ClusteredJoin(EngineConfig(probe_mode="pallas"), device=DEVICE)
    got = ranges.aggregate(zr, zs).aggregate
    want = datagen.oracle_join_aggregate(zk_r, zp_r, zk_s, zp_s)
    if got != want:
        raise AssertionError(f"pallas zipf 1.05: {got} != C++ oracle {want}")
    ht, launches = _launched(lambda: int(perfect_hash.global_ht_join_aggregate(
        zs.keys, zs.payload, zr.keys, zr.payload)))
    _require(launches, "global_ht overflow fallback", "banded_compare_sum")
    want = datagen.oracle_join_aggregate(zk_s, zp_s, zk_r, zp_r)
    n_ov = _overflow_rows(zs)
    if ht != want or n_ov == 0:
        raise AssertionError(f"global_ht zipf build side: {ht} != C++ oracle "
                             f"{want}, or no overflow ({n_ov})")
    lines.append(f"pallas 2^{MID_SCALE - 2} zipf1.05 = {got} (C++ oracle); "
                 f"global_ht with the zipf side as build = C++ oracle, "
                 f"{n_ov} overflow rows through the banded fallback")


def _partitioned_config2(lines: list, big) -> tuple:
    """"pallas" at 18 bits and "sort_merge" on the headline's 2^27
    relations (payloads 1); returns the "pallas" launches and kernel 5's
    time and bound at that plan."""
    _, _, r_keys, s_keys = big
    ones = torch.ones_like(r_keys)
    r, s = Relation(r_keys, ones), Relation(s_keys, ones)
    want = _oracle_value(HEADLINE_SCALE, 0.0)
    c2 = ClusteredJoin(EngineConfig(probe_mode="pallas").with_bits(CONFIG2_BITS),
                       device=DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, launches = _launched(lambda: c2.aggregate(r, s))
    _require(launches, "pallas config 2", "probe_aggregate_ranges")
    t_c2, agg = _best_s(lambda: c2.aggregate(r, s).aggregate)
    peak = torch.cuda.max_memory_allocated()
    if res.aggregate != want or agg != want:
        raise AssertionError(f"pallas config 2: {agg} != oracle {want}")
    cols, s_start, s_nch = _plan_of(r, s, CONFIG2_BITS, RANGE_TILE, RANGE_TILE)
    items, compares = _range_work(cols, s_start, s_nch, RANGE_TILE, RANGE_TILE)
    k_ms = _time_ms(lambda: probe_ranges.probe_aggregate_ranges(
        *cols, s_start, s_nch, tile_r=RANGE_TILE, tile_s=RANGE_TILE), 10)
    # the four columns read once, and the scalar written
    bound = _bound(_nbytes(*cols) + 4,
                   compares * KERNEL_OPS["probe_aggregate_ranges"])
    del cols
    lines.append(f"pallas config 2, 2^{HEADLINE_SCALE} per side at "
                 f"{CONFIG2_BITS} bits = {agg} (oracle), best of {REPS} "
                 f"{t_c2 * 1e3:.3f} ms, peak {peak / 2**30:.2f} GiB, {items} "
                 f"items, {compares:.3e} compares, kernel alone {k_ms:.4f} ms "
                 f"({compares / k_ms / 1e9:.3f} T compares/s), bound "
                 f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}, launches "
                 f"{launches}")

    sm = ClusteredJoin(EngineConfig(probe_mode="sort_merge"), device=DEVICE)
    t_sm, agg = _best_s(lambda: sm.aggregate(r, s).aggregate)
    if agg != want:
        raise AssertionError(f"sort_merge 2^{HEADLINE_SCALE}: {agg} != {want}")
    lines.append(f"sort_merge 2^{HEADLINE_SCALE} = oracle, best of {REPS} "
                 f"{t_sm * 1e3:.3f} ms")
    return launches, {"config2_ms": k_ms,
                      "config2_bound_ms": bound["bound_ms"],
                      "config2_bound_by": bound["bound_by"]}


def phase_partitioned(big) -> tuple:
    """The radix-partitioned modes. Returns (the launch counts of the
    config-2 "pallas" aggregate, kernel 5's time and bound at config 2's
    plan)."""
    lines = []
    _partitioned_config1(lines)
    _partitioned_zipf(lines)
    launches, at_config2 = _partitioned_config2(lines, big)
    print("[partitioned] " + "; ".join(lines))
    return launches, at_config2


def phase_late():
    engine = ClusteredJoin(device=DEVICE)
    n = 1 << MID_SCALE
    rk, sk = datasets.make_pk_fk(n, n, seed=SEED)
    rng = np.random.RandomState(SEED + 2)
    r_cols = rng.randint(-2**31, 2**31, (n, 4), dtype=np.int64).astype(np.int32)
    s_cols = rng.randint(-2**31, 2**31, (n, 2), dtype=np.int64).astype(np.int32)
    # payloads default to row ids, made on the card
    r = Relation.from_numpy(rk, device=DEVICE)
    s = Relation.from_numpy(sk, device=DEVICE)
    rc, sc = (torch.from_numpy(c).to(DEVICE) for c in (r_cols, s_cols))
    res, launches = _launched(lambda: engine.late_aggregate(r, s, rc, sc))
    _require(launches, "late", "banded_compare_per_s")
    t, agg = _best_s(lambda: engine.late_aggregate(r, s, rc, sc).aggregate)
    ids = np.arange(n, dtype=np.int32)
    want = oracle.join_late_materialize_sum(rk, ids, sk, ids, r_cols, s_cols)
    if agg != want or res.aggregate != want:
        raise AssertionError(f"late aggregate {agg} != oracle {want}")
    print(f"[late] 2^{MID_SCALE} per side, 4 R + 2 S columns = {agg} "
          f"(oracle), best of "
          f"{REPS} {t * 1e3:.3f} ms, launches {launches}")
    return launches


def _direct_config3_oracle(rk, rp, sk, s_filter, s_gid, lo, hi, groups):
    """Config 3's answer by direct addressing: R keys are a permutation of
    [0, n_r), so pay[k] is the payload of key k and every S key matches
    once; per-group sums of payloads < 100 stay far below 2^53, exact in
    float64."""
    n_r = rk.size
    if rk.min() < 0 or rk.max() >= n_r or not (np.bincount(rk, minlength=n_r) == 1).all():
        raise AssertionError("config-3 R keys are not a permutation")
    pay = np.empty(n_r, np.int64)
    pay[rk] = rp
    keep = (s_filter >= lo) & (s_filter < hi)
    g = s_gid[keep]
    counts = np.bincount(g, minlength=groups).astype(np.int64)
    sums = np.bincount(g, weights=pay[sk[keep]].astype(np.float64),
                       minlength=groups).astype(np.int64)
    as_i32 = lambda x: (x & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return as_i32(counts), as_i32(sums)


def phase_pipeline():
    """Returns the launch counts of the fused pipeline's first call."""
    c = C3
    t0 = time.perf_counter()
    inputs = datasets.make_config3(c["n_r"], c["n_s"], c["groups"])
    want = _direct_config3_oracle(*inputs, c["lo"], c["hi"], c["groups"])
    args = [torch.from_numpy(a).to(DEVICE) for a in inputs]
    del inputs
    t_data = time.perf_counter() - t0
    fused = lambda: pipelines.filter_probe_groupby(
        *args, c["lo"], c["hi"], c["groups"])
    streamed = lambda: pipelines.filter_probe_groupby_streamed(
        *args, c["lo"], c["hi"], c["groups"], segments=c["segments"])

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    got, launches = _launched(fused)
    _require(launches, "pipeline", "banded_compare_per_s")
    t_fused, got = _best_s(fused)
    peak_fused = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_streamed, got_s = _best_s(streamed)
    peak_streamed = torch.cuda.max_memory_allocated()
    for name, res in (("fused", got), ("streamed", got_s)):
        for g, w, what in zip(res, want, ("COUNT", "SUM")):
            if not np.array_equal(g.cpu().numpy(), w):
                raise AssertionError(f"config 3 {name} {what} != oracle")
    del args

    # the general numpy oracle, at a size where it runs in seconds
    rng = np.random.default_rng(7)
    (n_r, n_s), groups = C3_GENERAL, c["groups"]
    rk = rng.integers(0, n_r // 2, n_r).astype(np.int32)      # duplicate keys
    rp = rng.integers(-2**31, 2**31, n_r).astype(np.int32)
    sk = np.where(rng.random(n_s) < 0.75, rk[rng.integers(0, n_r, n_s)],
                  rng.integers(n_r // 2, n_r, n_s)).astype(np.int32)
    s_filter = rng.integers(0, 1000, n_s).astype(np.int32)
    s_gid = rng.integers(0, groups, n_s).astype(np.int32)
    mid = (rk, rp, sk, s_filter, s_gid)
    got_m = pipelines.filter_probe_groupby(
        *(torch.from_numpy(a).to(DEVICE) for a in mid), c["lo"], c["hi"], groups)
    want_m = oracle.filter_probe_groupby(*mid, c["lo"], c["hi"], groups)
    for g, w in zip(got_m, want_m):
        if not np.array_equal(g.cpu().numpy(), w):
            raise AssertionError("general pipeline != numpy oracle")
    print(f"[pipeline] config 3, {c['n_r']} x {c['n_s']}, {groups} groups, filter "
          f"[{c['lo']}, {c['hi']}): fused = streamed({c['segments']}) = "
          f"direct oracle; fused best of {REPS} {t_fused * 1e3:.3f} ms "
          f"({c['n_s'] / t_fused / 1e6:.1f} Mrows/s), peak "
          f"{peak_fused / 2**30:.2f} GiB; streamed best of {REPS} "
          f"{t_streamed * 1e3:.3f} ms, peak {peak_streamed / 2**30:.2f} GiB; "
          f"launches per fused call {launches}; {n_r} dup-R x {n_s} = numpy "
          f"oracle; data {t_data:.1f}s")
    return launches


def _timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase] {name} {time.perf_counter() - t0:.1f}s", flush=True)
    return out


PHASES = ("kernel", "kernel ranges", "kernel merge", "kernel sort tiles",
          "kernel stage", "probes", "sort tools", "mid", "headline", "sorts",
          "materialize", "partitioned", "late", "pipeline")
# phases that join the headline's 2^27 relations, which `headline` makes
NEED_HEADLINE = ("sorts", "materialize", "partitioned")


def _partial(names) -> int:
    """`report`, `build` and the named phases, each whole: no size,
    repetition or check is cut. Prints no `kernels` line and no result
    line, only which phases ran."""
    unknown = [name for name in names if name not in PHASES]
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {unknown}; the phases "
                         f"are {', '.join(PHASES)}")
    _timed("report", phase_report)
    _timed("build", phase_build)
    alone = {"kernel": phase_kernel, "kernel ranges": phase_kernel_ranges,
             "kernel merge": phase_kernel_merge,
             "kernel sort tiles": phase_kernel_sort_tiles,
             "kernel stage": phase_kernel_stage, "probes": phase_probes,
             "sort tools": phase_sort_tools, "mid": phase_mid,
             "late": phase_late, "pipeline": phase_pipeline}
    with_big = {"sorts": phase_sorts, "materialize": phase_materialize,
                "partitioned": phase_partitioned}
    big = None
    ran = []
    for name in PHASES:
        if name in names or (name == "headline"
                             and any(n in names for n in NEED_HEADLINE)):
            if name == "headline":
                _, big = _timed(name, phase_headline)
            elif name in with_big:
                _timed(name, with_big[name], big)
            else:
                _timed(name, alone[name])
            torch.cuda.empty_cache()
            ran.append(name)
    print(f"chip_smoke: ran only the phases {', '.join(ran)}; a run of all "
          f"phases prints the kernels line and the result line")
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        if len(argv) != 2 or argv[0] != "--phases":
            raise SystemExit("usage: chip_smoke.py [--phases 'a,b']")
        return _partial([name.strip() for name in argv[1].split(",")])
    kind = _timed("report", phase_report)
    _timed("build", phase_build)
    kstats = _timed("kernel", phase_kernel)
    kstats["probe_aggregate_ranges"] = _timed("kernel ranges",
                                              phase_kernel_ranges)
    kstats.update(_timed("kernel merge", phase_kernel_merge))
    tools = {}   # kernels 8-10: launches on their tools' runs
    for name, label, phase in (
            ("sort_tiles", "kernel sort tiles", phase_kernel_sort_tiles),
            ("stage_reps", "kernel stage", phase_kernel_stage),
            ("construct_probes", "probes", phase_probes)):
        kstats[name], tools[name] = _timed(label, phase)
        torch.cuda.empty_cache()
    _timed("sort tools", phase_sort_tools)
    _timed("mid", phase_mid)
    head, big = _timed("headline", phase_headline)
    sorts = _timed("sorts", phase_sorts, big)
    fast, ring = _timed("materialize", phase_materialize, big)
    part, at_config2 = _timed("partitioned", phase_partitioned, big)
    kstats["probe_aggregate_ranges"].update(at_config2)
    del big
    torch.cuda.empty_cache()
    _timed("late", phase_late)
    pipe = _timed("pipeline", phase_pipeline)
    # each kernel's launches on its path: the aggregate, the config-3
    # pipeline, the config-2 ring, the 2^24 fast-path materialize, the
    # config-2 "pallas" aggregate, the 2^27 aggregate under "merge"; the tile
    # sort's call, `bench_stages`, the probe ladder
    launches = {"banded_compare_sum": head["banded_compare_sum"],
                "banded_compare_per_s": pipe["banded_compare_per_s"],
                "banded_compare_first": ring["banded_compare_first"],
                "banded_interval_select": fast["banded_interval_select"],
                "probe_aggregate_ranges": part["probe_aggregate_ranges"],
                "merge_levels_vmem": sorts["merge_levels_vmem"],
                "merge_level_hbm": sorts["merge_level_hbm"], **tools}
    # kernel 7 is two launches a level: its plan kernel's count beside it
    kstats["merge_level_hbm"]["plan_launches"] = sorts["merge_level_plan"]
    # the two kernels with the longest records of levels and windows come
    # last, so that the end of a cut log still carries them whole
    order = sorted(ROUTES, key=lambda name: name in ("merge_level_hbm",
                                                     "sort_tiles"))
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": ROUTES[name][0],
        "replaces": ROUTES[name][1],
        "launches": launches[name],
        **kstats[name],
    } for name in order]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
