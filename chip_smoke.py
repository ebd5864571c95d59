#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: `python3 chip_smoke.py`. It builds the port's
kernels and drives its paths on the card, each phase printing one line with
its seconds. `python3 chip_smoke.py --phases "kernel merge,sorts"` runs
`report`, `build` and only the named phases (`PHASES`; `headline` comes
along where a phase joins its relations), each whole, and ends with a line
that names them: it prints no `kernels` line and no result line, so only a
run of all phases can pass. The phases:

  report     torch and CUDA versions, the card's name and power limit, its
             memory and integer rates (`utils/timing`);
  build      the CUDA kernel library (nvcc, sm_90a) and the C++ host library,
             side by side;
  kernel     each of the first five kernels against its plain version on the card,
             exact int32 equality: the four banded kernels, and the windowed
             entry points of kernels 1, 2 and 3, at small shapes (W > 1,
             full-range payloads, empty windows) and at the shape their path
             gives them, with both times at that shape (kernel 2, both entry
             points, at each of `KERNEL2_SHAPES`); the windowed ones
             also on edge windows (`WINDOW_EDGE_SHAPES` at rounds 1 and 3:
             empty and clamped windows, S and R pad rows, W of 1, 2 and 6,
             an empty round); the
             interval select (kernel 4) also at widths of 1, 257, 333 and 512
             columns on disjoint intervals and on overlapping, inverted and
             INT32_MIN / INT32_MAX ones; the
             stream-range probe (kernel 5, a shared-memory hash table of
             each R tile) at small plans (several partitions per R tile,
             tiles with no chunks, a skewed tile with hundreds of chunks,
             chunk counts past S, full-range payloads), at the table's edge
             plans (a tile of one key, keys equal in their low 13 or 18
             bits, INT32_MIN, -1, 0 and INT32_MAX as keys, 1024 keys of one
             slot: the longest probe chain, wrapping at the table's end) and
             at config 1's full plan, with both times there;
  kernel merge  the merge sort's kernels (6: `merge_levels_vmem`, 7: the two
             launches of `merge_level_hbm`, the plan and the merge) against
             their plain versions, keys and payloads exactly equal and the
             plan kernel's table equal to the torch planner's: small shapes
             (duplicate-heavy and full-range keys, several blocks so odd run
             parities occur, two pairs so an odd pair's encoded output
             occurs, output runs of 2^13 and of 256, a number of output runs
             that is odd and one that ends inside a block,
             the short second-to-last tile of a pair, windows 8192,
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
             `run_probes`: every probe ok; every probe kernel held against
             its plain version at the edges (`hold_edges`: windows at the
             first and last rows and overlapping, a fully masked and an
             unmasked tile, equal and extreme keys); each kernel's device
             time alone beside its bound and the parent's recorded time;
             each ladder kernel's form (CTAs a problem, cluster size,
             `cudaOccupancyMaxActiveClusters`); the
             library call beside concat_only (`torch.cat`) and
             transpose_only (`a + 1`), and an empty launch's device time
             (a launch's floor);
  sort tools `bench_packed` and `bench_full` at 2^24 and `merge_fix_validate`
             at 2^18 and 2^24 through their entry points, every check true,
             window 32768 refused;
  mid        `ClusteredJoin.aggregate` at 2^24 x 2^24 uniform PK-FK (against
             the checked-in oracle value) and 2^22 x 2^22 Zipf z=1.05
             (against the C++ oracle);
  headline   the aggregate at 2^27 x 2^27 uniform PK-FK with payloads of 1,
             the `bench.py` workload: best of 3 after a warm-up; the windowed
             kernel 1 must launch and the chunk entry point not at all, and
             the radix pair sort (`ops/radix_pairs.py`) five times a side;
  sorts      the radix pair sort (`radix_sort_pairs`, the "lax" route on the
             card) against its plain version (`torch.sort` + gather) at
             2^27 uniform keys, 2^29 Zipf z=1.05 keys (a hot digit in every
             pass) and a ragged 100,000,007 uniform keys, sorted as the
             engine sorts them (`rotate_keys`), full-range payloads: keys
             equal, each key's payload multiset equal (the sorted packed
             (sortval << 32 | payload) words of both), and the payloads in
             a stable sort's order; one histogram and four pass launches a
             call; its time alone beside its bound (68 bytes a row at the
             memory rate), the 16-byte roofline and `torch.sort` + gather
             (`library_ms`). Then `EngineConfig.sort_impl`: the headline
             relations with every key
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
  materialize  the extraction kernel (`ops/extract_pairs.py`) against its
             plain version at 2^27 S rows (one match a row in order into
             2^27 slots, the mat cell's shape; 0-2 matches a row with every
             4096th row matching 4096 times, about 2^28 slots; a 2^24 ring
             under 2^27 matches), one launch each,
             timed alone beside its bytes' bound and the plain version; then
             `ClusteredJoin.materialize` (a) at 2^24 x 2^24 PK-FK into a
             2^24 buffer, which must take the extraction kernel and neither
             kernel 4 nor kernel 2 and equal the numpy oracle as a multiset,
             and again with debug_force="fast", which must take the
             block-windowed fast path (kernels 4 and 2) to the same slots,
             and (b) the config-2 leg, 2^27 x 2^27 into a 2^24 ring through
             the kernel: the total must equal the
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
  streaming  the streamed probe through `clustered_probe_join`: R, the
             headline's 2^27 keys, on the card; S 2^29 rows in host memory,
             four copies of the headline's S with payloads 1-4; routed
             "streaming" with the resident limit at 2^27; 4 segments, then 6
             (a padded tail); 10 x the checked-in value, every upload from
             pinned memory, best of 3; then the overlap tool's line;
  coprocess  host co-processing through `clustered_probe_join`: the
             headline's relations from host memory under the default
             configuration (128,000,001 < 2^27 routes them there), against
             the checked-in value, and the 2^22 Zipf relations with the
             limit at 2^21 against the C++ oracle, best of 3; the overlap
             tool's line;
  late       `ClusteredJoin.late_aggregate` at 2^24 per side with 4 R and 2 S
             columns, against the numpy oracle; the windowed kernel 2 must
             launch and its chunk entry point not at all;
  pipeline   BASELINE.json config 3, 2^24 R x 2^29 S, 64 groups, filter
             [100, 600): fused and streamed in 4 segments, equal to each
             other and to a direct-address numpy oracle, best of 3 and peak
             device memory, the windowed kernel 2 launched and its chunk
             entry point not; and the general numpy oracle at 2^20
             duplicate-key R x 2^23 S;
  distributed  the distributed layer (`parallel/`) in two worlds on the card,
             its data and oracles all made before the first leg is timed.
             A 1-rank NCCL world (`torch.distributed`, a `file://` store):
             `run_configs` config 5's three legs, through its own one-card
             code (`run_configs._one_rank_legs`), at 2^24 x 2^24 with
             payloads 1, segmented in 4 segments and one-shot against the
             checked-in oracle value, and Zipf z=1.05 at seed 777 (no .bin
             cache) segmented against the C++ oracle; every line correct.
             Then an 8-rank thread world on the card at 2^22 x 2^22 global
             with full-range payloads: segmented in 4 segments; segmented
             with 30% of S on one key, where the heavy split must run (its
             executed per-rank loads and their spread printed, within 2x of
             the uniform share); the 2-level exchange on a 2 x 4 mesh; the
             materializing join as a multiset against the numpy oracle,
             routed and with debug_force="fast"; and
             the port's `dryrun_multichip(8)` (config 5's second leg). Every
             leg overflow 0 and equal to its oracle, best of 3 after a
             warm-up, kernel 1 (windowed) launched on every aggregate leg,
             kernel 3 (windowed) and the extraction kernel on the routed
             materialize leg and kernels 4 and 2 on the forced one. The
             warm-up calls record the (CH, W) each banded kernel gets; each
             is then held against its plain version at every one of them
             (the chunk entry points of kernels 1 and 3 at their windowed
             twins' shapes), with both times at the largest and the
             smallest CH (a tail chunk) of each width W.
             (Where the time of these legs goes: the port's
             `benchmarks/dist_bench.py`.)
  surface    the user surface, on the .bin files the earlier phases wrote:
             the port's CLI as the reference is invoked (`-b 7 -a HJC -R
             1000000 -S 16000000`), then with `--materialize` and as `-b 8`,
             each result line equal to the C++ oracle on the relations the
             CLI read; the port's bench at 2^27 under "lax" (`correct`, the
             checked-in aggregate; its JSON line printed; its three
             speed-of-light shares each in (0, 1], its `hbm_gbps` the data
             sheet's for the card's name, its measured sort rate > 0);
             `run_configs`
             configs 1 and 2 at their default sizes, every line correct
             (config 5 at its default size is the distributed phase's
             1-rank legs and dryrun); each call records the (CH, W) its
             banded kernels get, and the banded kernels are held against
             their plain versions at those shapes, as in the distributed
             phase;
             both group-by paths at 2^24 rows and 64 groups, vals in
             [0, 2^13), against `oracle.groupby_aggregate`, with their times;
             the sort path once more under `profiling.maybe_trace` and
             `annotate`, whose Chrome trace must hold the span and the
             card's kernels.
             Kernel 1 (windowed) must launch on the CLI's join, the bench and
             each configuration (kernel 3, windowed, on the materializing
             CLI call);
  rates      the three rate tools (no kernel of their own) at 2^24 rows
             through their entry points, `microbench`, `radix_proto_bench`
             and `sortgeom_bench all`: exit 0, every line's keys, every
             time > 0, every grouping's output holding the input's rows;
             their lines printed.
The headline, sorts, materialize, partitioned, streaming, coprocess, late,
pipeline, distributed and surface phases, and
the four phases of the sort tools, each zero the kernels' launch counts just
before they drive their path, read them just after, and fail if a kernel of
the path did not launch. Then one JSON
line on the kernels: each with its launches on its path, its time and its
plain version's at the path's shape, and its bound there, the larger of the
bytes it must move (each input read once, each output written once) over
the card's data-sheet memory rate (`utils/timing.detect_hbm_gbps`: 3.35
TB/s on the H100 SXM) and the integer operations its function needs over
the card's integer rate (`utils/timing.int_ops_per_s`: SMs x 128 integer
operations a clock, the issue rate, x the maximum SM clock `nvidia-smi`
reports; `KERNEL_OPS` says what is counted). `library_ms` is the one PyTorch call
that computes the tile sort on distinct keys (`torch.sort` along dim 1 +
gather); no single call computes any of the other functions, so it is null
there; the whole merge sort has `torch.sort` + gather beside it in the kernel
merge phase. The windowed kernel 1's entry also carries its launches in the
streamed and the co-processed call (`launches_streaming`,
`launches_coprocess`) and on each call of the surface phase
(`launches_surface`); the chunk entry points of kernels 1 and 3 lie on no
path (their launches are the aggregate's and the ring's: 0), nor do kernel
4 and kernel 2's chunk entry (their launches are the routed 2^24
materialize's: 0; on it with the fast path forced, `launches_fast_forced`).
The extraction kernel's entry carries its launches on the routed 2^24
materialize and its time alone at 2^27 slots, one match a row, beside its
bound and its plain version's (`cases`: each shape it was timed at). The banded
kernels carry their launches on each leg of the distributed phase
(`launches_distributed`), and each its holds at the shapes
the distributed legs and the surface calls gave it (`at_distributed`,
`at_surface`: every (CH, W) held, `held_at`, and the errors and times at
the largest and the smallest chunk of each width, `timed`; their errors
are folded into `max_abs_err`). The probe ladder's entry carries, beside its bound, the
floor its launches set (`bound_launches_ms`): 13 x the device time of one
empty launch (CUDA events around 100 of them back to back); its `ms` is
the sum of the 13 probe kernels' device times alone (each the mean of 50
launches behind a device sleep), `host_ms` the sum of their wrappers' times
by the host's events.
Kernel 7's entry also carries its plan kernel's time
(`plan_ms`, beside the torch planner's wall time) and launches
(`plan_launches`) and window 4096 at both levels. Kernel 5's `ms` is its
kernel alone (its C entry point on items made once), `wrapper_ms` the same
call through its wrapper, which makes and uploads the items each call; its
entry carries both and its bound at config 2's plan too (`config2_*`), and
the bound the TPU design's TR x TS compares an item would have
(`compare_bound_ms`). Kernel 2 has two entries, as kernel 1: the windowed
one with its launches on the config-3 pipeline (and `launches_late`), the
chunk entry with its launches on the routed materialize (0) and on the
forced fast path's extraction; both carry
`timed`, their times at each of `KERNEL2_SHAPES` (the chunk entry also at
the 2^24 fast path's extraction, (RING / 128, 6)). The probe ladder is
one entry: its launches are the probe kernels run, its times their sums,
with a map per probe (`probe_ms`, `probe_bound_ms`, `probe_library_ms`)
and each ladder kernel's `forms`. Last the result line
`{"ok": true, "device": {...}}`.
Any failure raises, so the exit code is not 0 and no result line is
printed; that includes a machine without CUDA.
"""

import concurrent.futures
import contextlib
import functools
import io
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from icde2019_gpu_join_tpu_torch import cli, datagen
from icde2019_gpu_join_tpu_torch.benchmarks import (bench, construct_probes,
                                                    experimental_sort,
                                                    merge_fix_validate,
                                                    merge_sort_bench,
                                                    microbench,
                                                    overlap_bench,
                                                    probe_bench,
                                                    radix_proto_bench,
                                                    run_configs,
                                                    sortgeom_bench)
from icde2019_gpu_join_tpu_torch.config import EngineConfig, default_bits_for
from icde2019_gpu_join_tpu_torch.models import (ClusteredJoin,
                                                clustered_probe_join,
                                                dispatch_regime, pipelines)
from icde2019_gpu_join_tpu_torch.ops import (_build, _launches, band_compare,
                                             band_join, groupby, merge,
                                             extract_pairs, perfect_hash,
                                             probe_ranges, radix_pairs,
                                             row_colsums)
from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32
from icde2019_gpu_join_tpu_torch.ops.partition import radix_partition
from icde2019_gpu_join_tpu_torch.parallel import dist_join, dryrun
from icde2019_gpu_join_tpu_torch.parallel import plan as xplan
from icde2019_gpu_join_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
from icde2019_gpu_join_tpu_torch.relation import Relation
from icde2019_gpu_join_tpu_torch.utils import (datasets, oracle, placement,
                                               profiling, timing)

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
    # kernels 1 and 3 on the block views, the gathers of
    # icde2019_gpu_join_tpu/ops/band_join.py folded in
    "banded_window_sum": (BANDED_SOURCE, f"{BANDED_PALLAS}:44"),
    "banded_window_per_s": (BANDED_SOURCE, f"{BANDED_PALLAS}:93"),
    "banded_window_first": (BANDED_SOURCE, f"{BANDED_PALLAS}:138"),
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
    # the block-windowed extraction: its gathers, kernel 4 and kernel 2
    "extract_pairs": (f"{CSRC}/extract_pairs.cu",
                      "icde2019_gpu_join_tpu/ops/band_join.py:514"),
    # no TPU kernel: the JAX package's lax.sort is a library sort
    "radix_sort_pairs": (f"{CSRC}/radix_pairs.cu", "none (lax.sort; ROADMAP R1)"),
}
# The integer operations each kernel's function needs per unit of work, for
# its bound: per compared (S row, R column) pair a compare and one
# predicated add (kernel 1), two adds (2), an add and a min (3),
# both entry points of kernels 1, 2 and 3 alike (a windowed call compares
# only the columns before hi: masked ones need no compare); for the
# stream-range probe (5), a hash table of each R tile since it was
# redesigned, per row a build (R) or a lookup (S): a multiply and a shift
# for the slot, a compare and an add (its bytes bound it: 8 a row); for
# the interval select (4) the least any design needs, a subtraction and an
# unsigned compare a pair ((uint32)(pos - lo) < len), since payloads are
# touched per hit and not per pair; per compare-exchange of the merge
# kernels, the tile sort, the stage kernel and the probes a compare and four
# selects.
KERNEL_OPS = {"banded_compare_sum": 2, "banded_compare_per_s": 3,
              "banded_compare_first": 3, "banded_interval_select": 2,
              "banded_window_sum": 2, "banded_window_per_s": 3,
              "banded_window_first": 3,
              "probe_aggregate_ranges": 4, "merge_levels_vmem": 5,
              "merge_level_hbm": 5, "sort_tiles": 5, "stage_reps": 5,
              "construct_probes": construct_probes.OPS_PER_EXCHANGE}
# "hbm_bytes_per_s", "int_ops_per_s" (`utils/timing`'s figures) and "line",
# set by phase_report
CARD = {}
# S of the streamed leg: this many copies of the headline's S (copy c has
# payload c + 1)
STREAM_COPIES = 4
# the distributed phase: config 5's 1-rank legs (benchmarks/run_configs.py:
# 256-307) at 2^DIST_SCALE a side, its default size; the thread world's
# DIST_RANKS ranks at 2^DIST_THREAD_SCALE global rows a side, the heavy leg
# with DIST_HOT of S on one key
DIST_SCALE = 24
DIST_RANKS = 8
DIST_THREAD_SCALE = 22
DIST_HOT = 0.3
# the empty launches timed back to back for the probe ladder's bound
EMPTY_LAUNCHES = 100
# Each construct probe kernel's device time alone in its parent's design
# (the probe kernels before they were redesigned around TMA, registers and
# clusters: one 1024-thread block a probe, every stage a trip through shared
# memory), the mean of the parent's two runs of `construct_probes --kernels`
# on a checkout of that design, in turns with the new kernels in one chip
# call, on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md, section 6, kernel
# 10): printed beside this run's times, not measured here.
PARENT_PROBE_MS = {
    "transpose_only": 0.0072992,
    "merge_T_dm": 0.0657325,
    "lane_ladder_T": 0.0244416,
    "full_merge_T": 0.0648048,
    "concat_only": 0.0043066,
    "lane_64": 0.0068474,
    "lane_16": 0.007857,
    "lane_1": 0.007832,
    "sublane_ladder": 0.0133722,
    "dirmask_stage": 0.0067728,
    "concat_merge": 0.0252125,
    "min_dma": 0.002896,
    "min_dma_compute": 0.0245328}
# the surface: the reference's own CLI invocation, the bench, run_configs
SURFACE_CLI = ["-a", "HJC", "-R", "1000000", "-S", "16000000"]
SURFACE_BENCH_SCALE = 27
SURFACE_CONFIG1 = (1 << 20, 1 << 24)
SURFACE_CONFIG2_SCALE = 27
SURFACE_GROUPBY = (1 << 24, 64, 1 << 13)   # rows, groups, vals in [0, 2^13)
# the rate tools: log2 rows, and each tool's arguments and the keys every
# line of it holds
RATES_SCALE = 24
RATE_TOOLS = {
    "microbench": (microbench, [], {"op", "n", "ms", "bytes",
                                    "gbps_effective"}),
    "radix_proto_bench": (radix_proto_bench, [], {"op", "bits", "chunk", "n",
                                                  "ms", "mrows_s", "ok"}),
    "sortgeom_bench": (sortgeom_bench, ["all"], {"op", "shape", "n", "ms",
                                                 "mrows_s", "check"}),
}


def _oracle_value(scale: int, skew: float) -> int:
    """A checked-in C++ oracle aggregate (native generator, payloads 1)."""
    path = os.path.join(REPO, "data",
                        f"oracle_agg_pkfk_s{scale}_z{skew}_seed{SEED}_gnative.json")
    with open(path) as f:
        return int(json.load(f)["aggregate"])




def _time_ms(fn, reps: int) -> float:
    """Mean device time of one call over `reps` calls queued behind a
    device sleep (`utils.timing.queued_ms`)."""
    return timing.queued_ms(fn, DEVICE, reps)


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
    """Zero the counters, run fn once (synchronised), and return (fn's
    result, the counts of that run: every registered table of
    `ops/_launches.py`)."""
    _launches.reset()
    out = fn()
    torch.cuda.synchronize()
    return out, _launches.snapshot()


def _bound(nbytes: int, int_ops: int) -> dict:
    """The least time the card could take: the bytes over the memory rate or
    the integer operations over the integer rate, whichever is larger."""
    by_bytes = nbytes / CARD["hbm_bytes_per_s"] * 1e3
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


def _require_windowed_per_s(counts: dict, path: str):
    """A per-S probe's path: the windowed kernel 2 launched, and its chunk
    entry point, which reads gathered chunks, not at all."""
    _require(counts, path, "banded_window_per_s")
    if counts["banded_compare_per_s"]:
        raise AssertionError(f"{path}: the chunk-array kernel 2 launched "
                             f"{counts['banded_compare_per_s']} times")


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


INTERVAL_EDGE_SHAPES = [(5, 1), (7, 333), (64, 257), (2048, 512)]   # (CH, WB)
EXTREMES = (-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1)


def _interval_edge_args(gen, ch, wb):
    """What the engine never sends and the kernel must still get right:
    intervals that overlap (a slot sums every column that holds it), inverted
    ones (hi < lo: they hold nothing), and, in every fourth row, pos, lo and
    hi drawn from INT32_MIN, INT32_MAX and their neighbours."""
    lo = _ints(gen, -8, 40, (ch, wb))
    hi = lo + _ints(gen, -3, 12, (ch, wb))
    pos = _ints(gen, -10, 52, (ch, band_compare.LANES))
    ext = torch.tensor(EXTREMES, dtype=torch.int32, device=DEVICE)
    for x in (lo, hi, pos):
        x[1::4] = ext[_ints(gen, 0, len(EXTREMES), x[1::4].shape).long()]
    return (pos, lo, hi, _full(gen, (ch, wb)), _full(gen, (ch, wb)),
            _full(gen, (ch, wb)))


def _window_args(gen, ch: int, wb: int, edge_round=None):
    """A windowed call's arguments: CH distinct S block ids, permuted, out of
    about CH + CH/8 blocks, and about CH/2 + W R blocks; keys from a narrow
    range (dense matches), full-range payloads, S pad rows and R pad rows
    (the sentinel). With `edge_round` None, as on the path: round 0, every
    window W whole blocks, placed along R by the S block's position. Else
    that round over windows of 0 to 2W + 1 blocks, some empty (lo == hi),
    and one at R's last block, whose columns past it are clamped. The
    accumulators start from values that are not the identity, so that the
    kernels' += and min show."""
    w = wb // band_compare.LANES
    nsb, nrb = ch + ch // 8 + 1, ch // 2 + w + 1
    pad = band_join._R_PAD_SV
    s_svb = _ints(gen, 0, 16, (nsb, band_compare.LANES))
    r_svb = _ints(gen, 0, 16, (nrb, band_compare.LANES))
    s_svb[-1, 64:] = pad
    r_svb[-1, 96:] = pad
    ids = torch.randperm(nsb, generator=gen, device=DEVICE)[:ch]
    if edge_round is None:
        lo = (torch.arange(nsb, device=DEVICE) * (nrb - w) // nsb).to(
            torch.int32)
        hi, r = lo + w, 0
    else:
        lo = _ints(gen, 0, nrb, (nsb,))
        hi = torch.clamp(lo + _ints(gen, 0, 2 * w + 2, (nsb,)), max=nrb)
        hi = hi.to(torch.int32)
        r = edge_round
        if ch >= 2:
            lo[ids[0]] = hi[ids[0]]            # an empty window
            lo[ids[1]], hi[ids[1]] = nrb - 1, nrb   # clamped past R's end
    s_side = (s_svb, _full(gen, s_svb.shape))
    return (*s_side, r_svb, _full(gen, r_svb.shape), ids, lo, hi, r, w)


def _window_sum_args(gen, ch, wb, edge_round=None):
    return (*_window_args(gen, ch, wb, edge_round), _full(gen, (1,)))


def _window_per_s_args(gen, ch, wb, edge_round=None):
    s_svb, _, r_svb, r_payb, ids, lo, hi, r, w = _window_args(gen, ch, wb,
                                                             edge_round)
    return (s_svb, r_svb, r_payb, ids, lo, hi, r, w,
            _ints(gen, 0, 5, s_svb.shape), _full(gen, s_svb.shape))


def _window_first_args(gen, ch, wb, edge_round=None):
    s_svb, _, r_svb, _, ids, lo, hi, r, w = _window_args(gen, ch, wb,
                                                         edge_round)
    h = _ints(gen, 0, 5, s_svb.shape)
    fm = torch.where(_ints(gen, 0, 2, s_svb.shape) > 0, band_compare.INT32_MAX,
                     _ints(gen, 0, 1 << 20, s_svb.shape)).to(torch.int32)
    return s_svb, r_svb, ids, lo, hi, r, w, h, fm


BC = band_compare
# the banded kernels, name: (wrapper, plain version, inputs, how many of the
# last arguments are outputs it updates in place: 0 where it returns them)
KERNELS = {
    "banded_compare_sum": (BC.banded_compare_sum, BC.banded_compare_sum_ref,
                           _sum_args, 0),
    "banded_compare_per_s": (BC.banded_compare_per_s,
                             BC.banded_compare_per_s_ref, _per_s_args, 0),
    "banded_compare_first": (BC.banded_compare_first,
                             BC.banded_compare_first_ref, _first_args, 0),
    "banded_interval_select": (BC.banded_interval_select,
                               BC.banded_interval_select_ref, _interval_args,
                               0),
    "banded_window_sum": (BC.banded_window_sum, BC.banded_window_sum_ref,
                          _window_sum_args, 1),
    "banded_window_per_s": (BC.banded_window_per_s,
                            BC.banded_window_per_s_ref, _window_per_s_args, 2),
    "banded_window_first": (BC.banded_window_first,
                            BC.banded_window_first_ref, _window_first_args, 2),
}
# the windowed kernels' edge windows, (CH, W), each held at rounds 1 and 3;
# CH 0 is an empty round
WINDOW_EDGE_SHAPES = [(0, 2), (5, 1), (77, 2), (300, 6), (2048, 6)]
# the chunk entry point whose body each windowed kernel shares
TWIN = {"banded_window_sum": "banded_compare_sum",
        "banded_window_per_s": "banded_compare_per_s",
        "banded_window_first": "banded_compare_first"}
# kernel 2's shapes, (CH, W), each held and timed, both entry points: a
# probe chunk at W = 1 (config 3, the late aggregate), the CLI join's
# (7812, 1), one rank's chunk (4096, 1), and the extraction's R side at
# W = 6 on one rank of the 8-rank materialize and on `cli --materialize`
KERNEL2_SHAPES = [(32768, 1), (7812, 1), (4096, 1), (4096, 6), (125000, 6)]
# a windowed kernel's arguments: where ids, lo, hi, r, w start; the S arrays
# read a row, the R arrays read a block, the [S blocks, 128] outputs read and
# written a row (kernel 1's is its one-word accumulator)
WINDOW_LAYOUT = {"banded_window_sum": (4, 2, 2, 0),
                 "banded_window_per_s": (3, 1, 2, 2),
                 "banded_window_first": (2, 1, 1, 2)}


def _call(name: str, fn, args):
    """fn (kernel `name`'s wrapper or plain version) on args; its outputs,
    which an in-place kernel updates in copies of the last arguments."""
    n_out = KERNELS[name][3]
    if not n_out:
        return fn(*args)
    outs = tuple(x.clone() for x in args[-n_out:])
    fn(*args[:-n_out], *outs)
    return outs


def _work(name: str, args, out) -> tuple:
    """(bytes moved, compared pairs) of one call: each input read once,
    each output written once; a windowed call reads its S rows, ids, lo, hi
    and the R rows before hi, updates its outputs, and compares those rows
    only."""
    lanes = band_compare.LANES
    if not KERNELS[name][3]:
        return _nbytes(*args, *out), args[0].numel() * args[-1].shape[1]
    at, s_arrays, r_arrays, out_arrays = WINDOW_LAYOUT[name]
    ids, lo, hi, r, w = args[at:at + 5]
    base = lo[ids].long() + r * w
    blocks = int(torch.clamp(hi[ids].long() - base, 0, w).sum())
    rows = ids.numel() * (s_arrays + 2 * out_arrays) + blocks * r_arrays
    acc = 8 if name == "banded_window_sum" else 0   # read and written
    return (rows * lanes * 4 + ids.numel() * (8 + 4 + 4) + acc,
            blocks * lanes * lanes)


def _main_shapes() -> dict:
    """The (CH, W) each kernel gets on its path, the timed one first: a
    probe chunk at W = 1 (aggregate, pipeline, descriptors), and
    _extract_blocked's slot blocks at a RING buffer, S side SWB = 4 blocks
    wide, R side RWB = 6."""
    chunk = (band_join._CHUNK_BLOCKS, 1)
    slots = RING // band_compare.LANES
    return {"banded_compare_sum": [chunk],
            "banded_compare_per_s": KERNEL2_SHAPES + [(slots, 6)],
            "banded_compare_first": [chunk],
            "banded_interval_select": [(slots, 4)],
            "banded_window_sum": [chunk],
            "banded_window_per_s": KERNEL2_SHAPES,
            "banded_window_first": [chunk]}


def _max_err(got, want) -> int:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))


# ---- phases ---------------------------------------------------------------

def phase_report() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = bench.card_line("cuda")
    CARD["hbm_bytes_per_s"] = timing.detect_hbm_gbps("cuda") * 1e9
    CARD["int_ops_per_s"] = timing.int_ops_per_s("cuda")
    CARD["line"] = smi
    kind = torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[report] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}; {sms} SMs x "
          f"{timing.INT32_OPS_PER_SM_CLOCK} integer operations a clock x "
          f"the max SM clock = "
          f"{CARD['int_ops_per_s']:.3e} integer operations/s; memory "
          f"{CARD['hbm_bytes_per_s']:.3e} B/s")
    print(smi)
    return kind


def phase_build():
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        kernels = pool.submit(_build.build_kernels)
        host = pool.submit(_build.build_host)
        t_kernels, t_host = kernels.result(), host.result()
    # load the library and bind every entry point the registered wrappers
    # launch, in the form their launches bind
    for name, (pointers, ints) in _launches.entries().items():
        _build.entry(name, pointers, ints)
    if datagen.native_lib() is None:
        raise RuntimeError("native host library did not load")
    print(f"[build] kernels {t_kernels:.2f}s ({_build.KERNEL_LIB}) "
          f"host {t_host:.2f}s ({_build.HOST_LIB}), in parallel")


def _hold(name: str, shapes, gen, **kw) -> int:
    """Kernel `name` against its plain version at each (CH, W) of `shapes`,
    on fresh inputs (`kw` to the inputs' maker); raises on a difference,
    else returns 0 (the max abs err)."""
    wrapper, plain, make, _ = KERNELS[name]
    for ch, w in shapes:
        args = make(gen, ch, w * band_compare.LANES, **kw)
        err = _max_err(_call(name, wrapper, args), _call(name, plain, args))
        torch.cuda.synchronize()
        if err:
            raise AssertionError(f"{name}: kernel != plain at CH={ch} W={w}"
                                 f" {kw} (max abs err {err})")
    return 0


def _time_at(name: str, ch: int, w: int, gen) -> dict:
    """Kernel `name`'s and its plain version's time at (CH, W), and its
    bound there. An in-place kernel accumulates into its arguments while
    it is timed."""
    wrapper, plain, make, _ = KERNELS[name]
    args = make(gen, ch, w * band_compare.LANES)
    ms = _time_ms(lambda: wrapper(*args), 20)
    plain_ms = _time_ms(lambda: plain(*args), 3)
    out = _call(name, wrapper, args)
    nbytes, pairs = _work(name, args,
                          out if isinstance(out, tuple) else (out,))
    return {"ms": ms, "plain_ms": plain_ms,
            **_bound(nbytes, pairs * KERNEL_OPS[name])}


def phase_kernel() -> dict:
    """Per kernel: max |kernel - plain| over every shape, and both times at
    its first main-path shape."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    stats = {}
    for name in KERNELS:
        main = _main_shapes()[name]
        err = _hold(name, SMALL_SHAPES + main, gen)
        stats[name] = {"max_abs_err": err, **_time_at(name, *main[0], gen)}
        st = stats[name]
        print(f"[kernel] {name}: equal to plain at (CH, W) in "
              f"{SMALL_SHAPES + main}; at {main[0]}: kernel {st['ms']:.4f} ms, "
              f"plain {st['plain_ms']:.4f} ms, bound {st['bound_ms']:.4f} ms "
              f"by {st['bound_by']}")
    # kernel 2, both entry points, timed at each of their main shapes
    for name in ("banded_compare_per_s", "banded_window_per_s"):
        stats[name]["timed"] = [{"shape": [ch, w],
                                 **_time_at(name, ch, w, gen)}
                                for ch, w in _main_shapes()[name]]
        print(f"[kernel] {name} at " + "; ".join(
            f"{tuple(st['shape'])}: kernel {st['ms']:.4f} ms, plain "
            f"{st['plain_ms']:.4f} ms, bound {st['bound_ms']:.4f} ms by "
            f"{st['bound_by']}" for st in stats[name]["timed"]))
    # the windowed kernels on edge windows: rounds past 0, empty and clamped
    # windows, W of 1, 2 and 6, an empty round
    for name in TWIN:
        for edge_round in (1, 3):
            _hold(name, WINDOW_EDGE_SHAPES, gen, edge_round=edge_round)
        print(f"[kernel] {name}: equal to plain on edge windows at (CH, W) in "
              f"{WINDOW_EDGE_SHAPES}, rounds 1 and 3")
    # the interval select at widths that are no multiple of its staging tile
    # nor even, on the engine's kind of intervals and on the edge cases
    hits = 0
    for ch, wb in INTERVAL_EDGE_SHAPES:
        for make in (_interval_args, _interval_edge_args):
            args = make(gen, ch, wb)
            got = BC.banded_interval_select(*args)
            err = _max_err(got, BC.banded_interval_select_ref(*args))
            torch.cuda.synchronize()
            if err:
                raise AssertionError(f"banded_interval_select: kernel != plain "
                                     f"at CH={ch} WB={wb}, {make.__name__} "
                                     f"(max abs err {err})")
        pos, lo, hi = args[:3]
        inb = (lo[:, None, :] <= pos[:, :, None]) & (pos[:, :, None] < hi[:, None, :])
        hits = max(hits, int(inb.sum(2).max()))
    if hits < 2:
        raise AssertionError("the edge intervals never overlap on a slot")
    print(f"[kernel] banded_interval_select: equal to plain at (CH, WB) in "
          f"{INTERVAL_EDGE_SHAPES}, disjoint intervals and overlapping (up "
          f"to {hits} on one slot), inverted and INT32_MIN / INT32_MAX ones")
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
    """(work items, rows, compares) of one call: the rows the function
    needs, each R row of a tile with work built into a table once and each
    S row of each item looked up; and the compares of the TPU kernel's
    design, TR * TS an item."""
    tile, _ = probe_ranges._items(s_start, s_nch, cols[2].shape[0], ts)
    return (tile.size, np.unique(tile).size * tr + tile.size * ts,
            tile.size * tr * ts)


# 1024 keys whose slot in kernel 5's table is its last one (2047): the
# longest probe chain, wrapping at the table's end (csrc/probe_ranges.cu:
# slot = the top 11 bits of key * 0x9E3779B1 mod 2^32)
_HASH_MUL = 0x9E3779B1
ONE_SLOT_KEYS = np.array(
    [(((2047 << 21) | j) * pow(_HASH_MUL, -1, 1 << 32)) & 0xFFFFFFFF
     for j in range(1024)], np.uint32).view(np.int32)
INT32_EDGES = (-2**31, -1, 0, 2**31 - 1)
RANGE_EDGES = ("one key", "low 13 bits", "low 18 bits", "int32 edges",
               "one slot")


def _range_edge_inputs(gen, rs: np.random.RandomState, case: str):
    """Kernel 5's table at its edges, in a synthetic plan of 6 tiles over
    8 chunks of 1024: a tile of one key; keys equal in their low 13 or 18
    bits (the radix field a tile shares); INT32_MIN, -1, 0 and INT32_MAX
    as keys; a tile of ONE_SLOT_KEYS. S draws a third of its keys from R."""
    tr = ts = 1024
    n_tiles, n_chunks = 6, 8
    n_r, n_s = n_tiles * tr, n_chunks * ts
    rk = _ints(gen, 0, 3000, (n_r,))
    if case == "one key":
        rk[tr:2 * tr] = 12345
    elif case.startswith("low"):
        bits = int(case.split()[1])
        d = _ints(gen, 0, 1 << (31 - bits), (n_r,))
        rk = (d << bits) | 0x155
        rk[::2] = -rk[::2] - 1
    elif case == "int32 edges":
        edges = torch.tensor(INT32_EDGES, dtype=torch.int32, device=DEVICE)
        rk[::5] = edges[_ints(gen, 0, 4, rk[::5].shape).long()]
    else:
        rk[:tr] = torch.from_numpy(ONE_SLOT_KEYS).to(DEVICE)
    sk = _ints(gen, 0, 3000, (n_s,))
    sk[::3] = rk[_ints(gen, 0, n_r, sk[::3].shape).long()]
    if case == "int32 edges":
        sk[1::7] = edges[_ints(gen, 0, 4, sk[1::7].shape).long()]
    cols = (rk, _full(gen, (n_r,)), sk, _full(gen, (n_s,)))
    s_start = (rs.randint(0, n_chunks, n_tiles) * ts).astype(np.int32)
    s_nch = rs.randint(1, n_chunks + 1, n_tiles).astype(np.int32)
    s_start[0], s_nch[0] = 0, n_chunks   # tile 0 against all of S
    return cols, s_start, s_nch


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
    cases += [(_range_edge_inputs(gen, rs, case), 1024, 1024)
              for case in RANGE_EDGES]
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
        items = _range_work(cols, s_start, s_nch, tr, ts)[0]
        shapes.append(f"{tr}x{ts}:{items} items, max {int(s_nch.max())} chunks")
        if err:
            raise AssertionError(f"probe_aggregate_ranges: kernel != plain at "
                                 f"{shapes[-1]} (max abs err {err})")
    (cols, s_start, s_nch), tr, ts = cases[-1]
    args = (*cols, s_start, s_nch)
    fn = lambda: probe_ranges.probe_aggregate_ranges(*args, tile_r=tr, tile_s=ts)
    ms = _time_ms(probe_bench.kernel5_launch(cols, s_start, s_nch, tr, ts), 20)
    wrapper_ms = _time_ms(fn, 20)
    plain_ms = _time_ms(lambda: probe_ranges.probe_aggregate_ranges_ref(
        *args, tile_r=tr, tile_s=ts), 3)
    items, rows, compares = _range_work(*cases[-1][0], tr, ts)
    # the four columns read once, and the scalar written
    bound = _bound(_nbytes(*cols) + 4,
                   rows * KERNEL_OPS["probe_aggregate_ranges"])
    compare_ms = _bound(0, compares * 2)["bound_ms"]
    print(f"[kernel] probe_aggregate_ranges: equal to plain at {shapes}, the "
          f"edge plans {RANGE_EDGES} among them; at "
          f"config 1's plan ({items} items, {rows} rows): kernel "
          f"{ms:.4f} ms ({_nbytes(*cols) / ms / 1e6:.1f} GB/s of its "
          f"columns; through the wrapper, items made and uploaded each call, "
          f"{wrapper_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{bound['bound_ms']:.4f} "
          f"ms by {bound['bound_by']} (the TPU design's {compares:.3e} "
          f"compares: {compare_ms:.4f} ms)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound,
            "wrapper_ms": wrapper_ms, "compare_bound_ms": compare_ms}


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
    (1 << 16, 128, 1, -2**31 + 1, 2**31 - 1),   # full range, 256-pair runs
    (1 << 17, 4096, 2, -2**31 + 1, 2**31 - 1),  # 8 blocks: odd parities
    (1 << 15, 512, 5, 0, 64),                   # five levels in one block
    (5 << 13, 2048, 2, 0, 64),                  # span 2^13, n / span odd
    (3 << 14, 2048, 3, 0, 64),                  # span 2^14, n / span odd
    (7 << 11, 256, 3, -2**31 + 1, 2**31 - 1),   # a ragged last block
    (3 << 8, 128, 1, 0, 64),                    # under one block of pairs
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
        # n is any multiple of the output run: name it as the grid tile
        span = run << levels
        _same_pairs(merge.merge_levels_vmem(es, ep, run, levels, span),
                    merge.merge_levels_vmem_ref(es, ep, run, levels, span),
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
        **_bound(16 * n, 27 * (n // 2) * KERNEL_OPS["merge_levels_vmem"]),
        "stages": 27}}
    k6s = stats["merge_levels_vmem"]
    k6s["Gelem_stage_s"] = n * k6s["stages"] / k6s["ms"] / 1e6
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
    print(f"[kernel merge] 2^{SORT_SCALE} cascade: base runs {base_ms:.3f} "
          f"ms; merge_levels_vmem (run 4096, 2 levels) {k6s['ms']:.4f} ms "
          f"({k6s['Gelem_stage_s']:.1f} Gelem-stage/s over {k6s['stages']} "
          f"stages), plain {k6s['plain_ms']:.3f} ms, bound {k6s['bound_ms']:.4f} ms by "
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
    _launches.reset(merge.LAUNCHES, merge.ROUTES)
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
        # the meter's own bound: the `reps` passes it is asked to make
        "passes_bound_ms": cases[first]["passes_bound_ms"],
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
    """The whole ladder of construct probes through its entry point, every
    probe kernel at the edges against its plain version, and each kernel's
    device time alone beside its bound. Returns (stats of the probe kernels,
    their launches on the ladder's run)."""
    cp = construct_probes
    lines, launches = _launched(lambda: cp.run_probes(device=DEVICE))
    _require(launches, "construct probes", "construct_probes",
             "merge_levels_vmem", "merge_level_hbm")
    bad = [line for line in lines if not line["ok"]]
    if bad or [line["probe"] for line in lines] != [n for n, _ in cp.PROBES]:
        raise AssertionError(f"construct probes failed: {bad or lines}")
    by_name = {line["probe"]: line for line in lines}
    mine = {name: by_name[name] for name in cp.CONSTRUCTS}
    edges = cp.hold_edges(DEVICE)
    forms = {name: cp.form(name) for name in cp.LADDERS}
    ops = sum(stages * exchanges * KERNEL_OPS["construct_probes"]
              for stages, exchanges in cp.PROBE_EXCHANGES.values())
    # what of a probe's wrapper time is its launch: an empty kernel through
    # the same launcher, timed as a probe's `ms` is
    floor_ms = cp.launch_floor_ms(DEVICE)
    # the device time of one empty launch: CUDA events around
    # EMPTY_LAUNCHES of them back to back. The ladder launches one kernel a
    # probe, so it cannot take less than that many of these.
    block = torch.zeros((cp.BLOCK_ROWS, cp.LANES), dtype=torch.int32,
                        device=DEVICE)
    empty_ms = _time_ms(lambda: cp.empty_launch(block), EMPTY_LAUNCHES)
    # the one PyTorch call that computes a probe's function: torch.cat for
    # concat_only, and a.T.T + 1 is a + 1
    a, b = cp._blocks(cp.WROW, 2, DEVICE, 0)
    library = {"concat_only": _time_ms(lambda: torch.cat([a, b]),
                                       cp.DEVICE_REPS),
               "transpose_only": _time_ms(lambda: block + 1, cp.DEVICE_REPS)}
    # `bound_ms` stays the bytes' or the operations' time, as for every
    # kernel; the floor the launches set is `bound_launches_ms` beside it
    bound = _bound(4 * sum(cp.PROBE_ELEMENTS.values()), ops)
    launches_ms = len(mine) * empty_ms
    stats = {"max_abs_err": 0,
             "ms": sum(line["device_ms"] for line in mine.values()),
             "host_ms": sum(line["ms"] for line in mine.values()),
             "plain_ms": sum(line["plain_ms"] for line in mine.values()),
             **bound, "bound_launches_ms": launches_ms,
             "empty_launch_device_ms": empty_ms,
             "probes": len(mine), "launch_floor_ms": floor_ms,
             "probe_ms": {name: line["device_ms"]
                          for name, line in by_name.items()},
             "probe_host_ms": {name: line["ms"]
                               for name, line in by_name.items()},
             "probe_plain_ms": {name: line["plain_ms"]
                                for name, line in by_name.items()},
             "probe_bound_ms": {name: line["bound_ms"]
                                for name, line in mine.items()},
             "probe_library_ms": library, "forms": forms,
             "edges_held": len(edges)}
    form = lambda name: (
        f", {forms[name]['ctas']} CTAs a problem, "
        + (f"a cluster of {forms[name]['cluster']} "
           f"(cudaOccupancyMaxActiveClusters "
           f"{forms[name]['max_active_clusters']})"
           if forms[name]["cluster"] > 1 else "no cluster")
        if name in forms else "")
    print(f"[probes] {len(lines)} probes ok, each equal to its plain version, "
          f"and {len(edges)} edge cases ({'; '.join(edges)}). Each probe "
          f"kernel alone (ms by CUDA events behind a device sleep, the "
          f"parent's recorded beside it), its bound and its form: "
          + ", ".join(
              f"{n} {l['device_ms']:.5f}, parent {PARENT_PROBE_MS[n]:.5f}, "
              f"bound {l['bound_ms']:.6f}{form(n)}" for n, l in mine.items())
          + f"; the {len(mine)} together {stats['ms']:.5f} ms (parent "
          f"{sum(PARENT_PROBE_MS.values()):.5f}, recorded), bound "
          f"{stats['bound_ms']:.6f} ms by {stats['bound_by']} "
          f"({4 * sum(cp.PROBE_ELEMENTS.values())} bytes, {ops} operations); "
          f"the floor of its launches {launches_ms:.4f} ms ({len(mine)} x "
          f"the device time of an empty launch, {empty_ms:.4f} ms by CUDA "
          f"events around {EMPTY_LAUNCHES} back to back; aim 2 x: "
          f"{2 * launches_ms:.4f}); torch.cat alone "
          f"{library['concat_only']:.5f} ms beside concat_only "
          f"{mine['concat_only']['device_ms']:.5f}, a + 1 alone "
          f"{library['transpose_only']:.5f} beside transpose_only "
          f"{mine['transpose_only']['device_ms']:.5f}; the wrappers by "
          f"the host's events: {stats['host_ms']:.4f} ms for the "
          f"{len(mine)}, an empty kernel through the same launcher "
          f"{floor_ms:.4f} ms a launch; other probes alone: " + ", ".join(
              f"{n} {l['device_ms']:.4f}" for n, l in by_name.items()
              if n not in mine)
          + f"; launches {launches}")
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


def _zipf_tables():
    """2^(MID_SCALE - 2) rows a side, S Zipf z=1.05 over R's keys,
    full-range payloads: (R keys, R payloads, S keys, S payloads), numpy."""
    n = 1 << (MID_SCALE - 2)
    rk, sk = datasets.make_pk_fk(n, n, skew=1.05, seed=SEED)
    rng = np.random.RandomState(SEED)
    rp = rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    sp = rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    return rk, rp, sk, sp


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

    rk, rp, sk, sp = _zipf_tables()
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
    _require(launches, "headline", "banded_window_sum")
    if (launches["radix_histogram"], launches["radix_pass"]) != (2, 8):
        raise AssertionError(f"headline: the radix pair sort launched "
                             f"{launches['radix_histogram']} histograms and "
                             f"{launches['radix_pass']} passes, not 2 and 8")
    if launches["banded_compare_sum"]:
        raise AssertionError(f"headline: the chunk-array kernel 1 launched "
                             f"{launches['banded_compare_sum']} times")
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


# the radix pair sort's shapes: (keys, rows)
RADIX_SORTS = (("uniform", 1 << 27), ("zipf", 1 << 29), ("uniform", 100_000_007))
RADIX_ZIPF = 1.05
RADIX_BYTES = 68   # a row: 4 for the histograms, 16 in each of four passes
_RADIX_BLOCK = 1 << 26   # Zipf rows drawn at a time


def _radix_inputs(gen, kind: str, n: int):
    """(sortvals as the engine sorts them, full-range payloads) on the card:
    keys a permutation of 0 .. n - 1, or Zipf(RADIX_ZIPF) ranks over 1 .. n
    by a search in the float64 CDF through a random permutation, as the
    benchmark's Zipf cell draws S."""
    if kind == "uniform":
        keys = torch.randperm(n, generator=gen, device=DEVICE).to(torch.int32)
    else:
        cdf = torch.arange(1, n + 1, device=DEVICE,
                           dtype=torch.float64).pow_(-RADIX_ZIPF)
        cdf = torch.cumsum(cdf, 0)
        cdf.div_(cdf[-1].clone())
        alphabet = torch.randperm(n, generator=gen, device=DEVICE) + 1
        keys = torch.empty(n, dtype=torch.int32, device=DEVICE)
        for lo in range(0, n, _RADIX_BLOCK):
            hi = min(n, lo + _RADIX_BLOCK)
            u = torch.rand(hi - lo, generator=gen, device=DEVICE,
                           dtype=torch.float64)
            pos = torch.searchsorted(cdf, u).clamp_(max=n - 1)
            keys[lo:hi] = alphabet[pos]
        del cdf, alphabet
    return band_join.rotate_keys(keys, 0, 0), _full(gen, (n,))


def _same_multisets(got, want, what: str):
    """Each key's payloads the same multiset: the sorted packed words."""
    a = torch.sort(_packed_words(*got)).values
    b = torch.sort(_packed_words(*want)).values
    same = torch.equal(a, b)
    del a, b
    if not same:
        raise AssertionError(f"{what}: (key, payload) multiset changed")


def _radix_sorts() -> dict:
    """The radix pair sort against its plain version at `RADIX_SORTS`, and
    its times; returns its stats (the first shape's at the top level)."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    timed = []
    for kind, n in RADIX_SORTS:
        sv, pv = _radix_inputs(gen, kind, n)
        what = f"radix_sort_pairs at {n} {kind}"
        got, launches = _launched(lambda: radix_pairs.radix_sort_pairs(sv, pv))
        if (launches["radix_histogram"], launches["radix_pass"]) != (1, 4):
            raise AssertionError(f"{what}: launches {launches}")
        want = radix_pairs.torch_sort_pairs(sv, pv)
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"{what}: keys != the plain version's")
        _same_multisets(got, want, what)
        del want
        idx = torch.sort(sv, stable=True).indices
        if not torch.equal(got[1], pv[idx]):
            raise AssertionError(f"{what}: payloads not in a stable order")
        del idx
        hot = int(torch.unique_consecutive(got[0], return_counts=True)[1].max())
        del got
        torch.cuda.empty_cache()
        ms = _time_ms(lambda: radix_pairs.radix_sort_pairs(sv, pv), 10)
        library_ms = _time_ms(lambda: radix_pairs.torch_sort_pairs(sv, pv), 5)
        st = {"rows": n, "keys": kind, "hot_key_share": hot / n, "ms": ms,
              # the plain version is the library call itself
              "plain_ms": library_ms, "library_ms": library_ms,
              "bound_ms": RADIX_BYTES * n / CARD["hbm_bytes_per_s"] * 1e3,
              "bound_by": "bytes",
              "roofline_ms": 16 * n / CARD["hbm_bytes_per_s"] * 1e3}
        timed.append(st)
        print(f"[sorts] {what}: keys equal to plain, payload multisets "
              f"equal, stable; hottest key {hot / n:.4f} of the rows; "
              f"kernel {ms:.4f} ms, bound {st['bound_ms']:.4f} ms "
              f"({RADIX_BYTES} B a row), 16 B roofline "
              f"{st['roofline_ms']:.4f} ms ({100 * st['roofline_ms'] / ms:.2f}%),"
              f" torch.sort + gather {library_ms:.4f} ms", flush=True)
        del sv, pv
        torch.cuda.empty_cache()
    return {"max_abs_err": 0, **timed[0], "timed": timed}


def phase_sorts(big) -> tuple:
    """The radix pair sort against its plain version; `sort_impl` "merge"
    and "packed" through the engine. Returns the launch counts of one 2^27
    aggregate under "merge" and the radix pair sort's stats."""
    radix = _radix_sorts()
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
        _require(launches, f"2^27 {impl}", "banded_window_sum")
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
    _require_windowed_per_s(launches, "config 3 packed")
    t_c3, got = _best_s(packed)
    for g, w, what in zip(got, want3, ("COUNT", "SUM")):
        if not np.array_equal(g.cpu().numpy(), w):
            raise AssertionError(f"config 3 packed {what} != oracle")
    lines.append(f"config 3 at {C3_PACKED[0]} x {C3_PACKED[1]} under 'packed' "
                 f"= direct oracle, best of {REPS} {t_c3 * 1e3:.3f} ms")
    print("[sorts] " + "; ".join(lines))
    return head, radix


def _key_payloads(r_keys, s_keys):
    """(R payloads 7k+1, S payloads k ^ KEY_MIX), numpy or torch int32."""
    if isinstance(r_keys, torch.Tensor):
        return wrap_i32(7 * r_keys.long() + 1), s_keys ^ KEY_MIX
    return ((7 * r_keys.astype(np.int64) + 1).astype(np.int32),
            s_keys ^ np.int32(KEY_MIX))


def _pair_multiset(out_r: np.ndarray, out_s: np.ndarray) -> np.ndarray:
    return np.sort((out_r.astype(np.int64) << 32)
                   | (out_s.astype(np.int64) & 0xFFFFFFFF))


def _extract_cases(n: int):
    """The extraction kernel's inputs at n S rows, by name: ((off, fm, s_p,
    r_p, capacity, total, wrap), the rows whose matches are kept). fm = off:
    each row's matches in order."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 23)
    ones = torch.ones(n, dtype=torch.int32, device=DEVICE)
    skewed = _ints(gen, 0, 3, (n,))
    skewed[::4096] = 4096
    for name, h in (("one a row", ones), ("skewed", skewed), ("ring", ones)):
        hsum = torch.cumsum(h, 0)
        total = int(hsum[-1])
        cap = RING if name == "ring" else total
        off = (hsum - h).to(torch.int32)
        rows = int(((h > 0) & (hsum > total - cap)).sum())
        del hsum
        yield name, (off, off.clone(), _full(gen, (n,)), _full(gen, (total,)),
                     cap, total, True), rows


def _extract_kernel() -> dict:
    """The extraction kernel against its plain version at 2^27 S rows (one
    launch each), and its time alone beside its bound (the off, fm and s_p
    of each row with a kept match read once, each kept match's R payload
    read once, each slot's pair written) and the plain version's. Returns
    the first case's figures (one match a row, the mat cell's shape), with
    every case's under "cases"."""
    n = 1 << HEADLINE_SCALE
    cases = {}
    for name, args, rows in _extract_cases(n):
        what = f"extract_pairs at 2^{HEADLINE_SCALE} rows, {name}"
        got, launches = _launched(lambda: extract_pairs.extract_pairs(*args))
        if launches["extract_pairs"] != 1:
            raise AssertionError(f"{what}: launches {launches}")
        want = extract_pairs.torch_extract_pairs(*args)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{what}: != the plain version")
        del got, want
        cap, total = args[4], args[5]
        nbytes = 12 * rows + 4 * min(cap, total) + 8 * cap
        ms = _time_ms(lambda: extract_pairs.extract_pairs(*args), 20)
        plain_ms = _time_ms(lambda: extract_pairs.torch_extract_pairs(*args), 3)
        bound_ms = nbytes / CARD["hbm_bytes_per_s"] * 1e3
        print(f"[materialize] {what}: {total} matches into {cap} slots, "
              f"{rows} rows' matches kept, equal "
              f"to plain; kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({nbytes} B, {100 * bound_ms / ms:.2f}%), plain "
              f"{plain_ms:.4f} ms", flush=True)
        cases[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bytes": nbytes, "matches": total, "slots": cap}
        del args
    torch.cuda.empty_cache()
    return {"max_abs_err": 0, **next(iter(cases.values())), "cases": cases}


def phase_materialize(big):
    """The extraction kernel alone; (a) the routed path and the forced fast
    path at RING rows per side; (b) the config-2 ring on the headline's
    inputs. Returns the extraction kernel's figures alone and the launch
    counts of the routed path, the forced fast path and (b)."""
    alone = _extract_kernel()
    engine = ClusteredJoin(device=DEVICE)
    n = RING
    rk, sk = datasets.make_pk_fk(n, n, seed=SEED)
    rp, sp = _key_payloads(rk, sk)
    r, s = _relations(rk, rp, sk, sp)
    res, routed = _launched(lambda: engine.materialize(r, s, capacity=RING))
    _require(routed, "materialize (a)", "banded_window_first",
             "extract_pairs")
    if routed["banded_interval_select"] or routed["banded_compare_per_s"]:
        raise AssertionError(f"materialize (a): kernels 4 or 2 ran {routed}")
    forced, fast = _launched(lambda: band_join.banded_materialize(
        r.keys, r.payload, s.keys, s.payload, capacity=RING,
        window_blocks=engine.config.band_window_blocks,
        sort_impl=engine.sort_impl, debug_force="fast"))
    _require(fast, "materialize (a), fast path forced", "banded_window_first",
             "banded_interval_select", "banded_compare_per_s")
    if fast["extract_pairs"] or not all(
            torch.equal(x, y) for x, y in zip(forced[:2], res.pairs)):
        raise AssertionError(f"materialize (a): the forced fast path's slots "
                             f"!= the kernel's, or the kernel ran ({fast})")
    del forced
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
    _require(ring, "materialize (b), ring", "banded_window_first",
             "extract_pairs")
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
          f"oracle multiset, the extraction kernel, best of {REPS} "
          f"{t_fast * 1e3:.3f} ms, launches {routed}; the fast path forced: "
          f"the same slots, launches {fast}; (b) 2^{HEADLINE_SCALE} per side, "
          f"ring {RING}: total {total} "
          f"(oracle), ring exact, the extraction kernel, best of {REPS} "
          f"{t_ring * 1e3:.3f} ms, launches {ring}")
    return alone, routed, fast, ring


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
    zk_r, zp_r, zk_s, zp_s = _zipf_tables()
    zr, zs = _relations(zk_r, zp_r, zk_s, zp_s)
    ranges = ClusteredJoin(EngineConfig(probe_mode="pallas"), device=DEVICE)
    got = ranges.aggregate(zr, zs).aggregate
    want = datagen.oracle_join_aggregate(zk_r, zp_r, zk_s, zp_s)
    if got != want:
        raise AssertionError(f"pallas zipf 1.05: {got} != C++ oracle {want}")
    ht, launches = _launched(lambda: int(perfect_hash.global_ht_join_aggregate(
        zs.keys, zs.payload, zr.keys, zr.payload)))
    _require(launches, "global_ht overflow fallback", "banded_window_sum")
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
    items, rows, compares = _range_work(cols, s_start, s_nch, RANGE_TILE,
                                        RANGE_TILE)
    k_ms = _time_ms(probe_bench.kernel5_launch(cols, s_start, s_nch), 10)
    wrapper_ms = _time_ms(lambda: probe_ranges.probe_aggregate_ranges(
        *cols, s_start, s_nch, tile_r=RANGE_TILE, tile_s=RANGE_TILE), 10)
    # the four columns read once, and the scalar written
    nbytes = _nbytes(*cols) + 4
    bound = _bound(nbytes, rows * KERNEL_OPS["probe_aggregate_ranges"])
    compare_ms = _bound(0, compares * 2)["bound_ms"]
    del cols
    lines.append(f"pallas config 2, 2^{HEADLINE_SCALE} per side at "
                 f"{CONFIG2_BITS} bits = {agg} (oracle), best of {REPS} "
                 f"{t_c2 * 1e3:.3f} ms, peak {peak / 2**30:.2f} GiB, {items} "
                 f"items, {rows} rows, kernel alone {k_ms:.4f} ms "
                 f"({nbytes / k_ms / 1e6:.1f} GB/s of its columns; "
                 f"{wrapper_ms:.4f} ms through the wrapper), bound "
                 f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} (the TPU "
                 f"design's {compares:.3e} compares: {compare_ms:.4f} ms), "
                 f"launches {launches}")

    sm = ClusteredJoin(EngineConfig(probe_mode="sort_merge"), device=DEVICE)
    t_sm, agg = _best_s(lambda: sm.aggregate(r, s).aggregate)
    if agg != want:
        raise AssertionError(f"sort_merge 2^{HEADLINE_SCALE}: {agg} != {want}")
    lines.append(f"sort_merge 2^{HEADLINE_SCALE} = oracle, best of {REPS} "
                 f"{t_sm * 1e3:.3f} ms")
    return launches, {"config2_ms": k_ms, "config2_wrapper_ms": wrapper_ms,
                      "config2_bound_ms": bound["bound_ms"],
                      "config2_bound_by": bound["bound_by"],
                      "config2_compare_bound_ms": compare_ms}


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


def _regime_call(r: Relation, s: Relation, cfg: EngineConfig, regime: str,
                 want: int, what: str) -> dict:
    """`clustered_probe_join` on the card, routed to `regime`, equal to
    `want`: the first call (its wall seconds, kernel launches, host tensors
    uploaded by memory kind, peak device memory), then best of REPS with the
    best call's phases."""
    got = dispatch_regime(r.num_rows, s.num_rows, cfg)
    if got != regime:
        raise AssertionError(f"dispatch_regime said {got!r}, not {regime!r}")
    call = lambda: clustered_probe_join(r, s, cfg, device=DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    placement.reset_copies()
    t0 = time.perf_counter()
    res, launches = _launched(call)
    first = time.perf_counter() - t0
    _require(launches, regime, "banded_window_sum")
    copies = dict(placement.COPIES)
    if copies["pageable"] or not copies["pinned"]:
        raise AssertionError(f"{regime}: uploads not all from pinned host "
                             f"memory: {copies}")
    out = {"first_s": first, "launches": launches, "copies": copies,
           "peak": torch.cuda.max_memory_allocated(), "best_s": float("inf")}
    for res in [res] + [None] * REPS:
        if res is None:
            t0 = time.perf_counter()
            res = call()
            wall = time.perf_counter() - t0
            if wall < out["best_s"]:
                out["best_s"], out["phases"] = wall, _phases_of(res)
        if res.aggregate != want:
            raise AssertionError(f"{what}: {res.aggregate} != {want}")
    return out


def _phases_of(res) -> str:
    return ", ".join(f"{p.name} {p.seconds * 1e3:.3f} ms"
                     for p in res.timer.phases)


def _regime_line(out: dict) -> str:
    return (f"first call {out['first_s'] * 1e3:.3f} ms, best of {REPS} "
            f"{out['best_s'] * 1e3:.3f} ms ({out['phases']}), "
            f"{out['copies']['pinned']} pinned uploads on the copy stream, "
            f"kernel 1 launches {out['launches']['banded_window_sum']}, peak "
            f"device memory {out['peak'] / 2**30:.2f} GiB")


def phase_streaming(big) -> int:
    """The streamed probe: R, the headline's keys with payloads 1, on the
    card; S = STREAM_COPIES copies of the headline's S keys in host memory,
    copy c with payload c + 1, so that a segment probed twice, skipped or
    overwritten changes the sum (10 x the headline's value for 4 copies).
    Routed by `dispatch_regime` with the resident limit at 2^HEADLINE_SCALE,
    at the default segments (2^HEADLINE_SCALE rows) and at 3 x
    2^(HEADLINE_SCALE - 2) rows (6 segments for 4 copies, the last a quarter
    segment padded in place); then the overlap tool's streaming leg on the
    same relations. Returns kernel 1's launches in the first call."""
    rk, sk, r_keys, _ = big
    n = 1 << HEADLINE_SCALE
    t0 = time.perf_counter()
    r = Relation(r_keys, torch.ones_like(r_keys))
    s_keys = np.tile(sk, STREAM_COPIES)
    s_pay = np.repeat(np.arange(1, STREAM_COPIES + 1, dtype=np.int32), n)
    s = Relation.from_numpy(s_keys, s_pay, device="cpu")
    t_data = time.perf_counter() - t0
    weight = STREAM_COPIES * (STREAM_COPIES + 1) // 2
    want = int(wrap_i32(torch.tensor(_oracle_value(HEADLINE_SCALE, 0.0)
                                     * weight)))
    lines, first = [], None
    for seg in (n, 3 << (HEADLINE_SCALE - 2)):
        cfg = EngineConfig(resident_limit_rows=n,
                           segment_rows=None if seg == n else seg)
        out = _regime_call(r, s, cfg, "streaming", want,
                           f"streaming, segments of {seg}")
        nseg = -(-s.num_rows // seg)
        if out["copies"]["pinned"] != 2 * nseg:
            raise AssertionError(f"streaming: {out['copies']} uploads for "
                                 f"{nseg} segments")
        first = first or out["launches"]["banded_window_sum"]
        lines.append(f"segments of {seg} rows ({nseg}) = {want} ({weight} x "
                     f"oracle); " + _regime_line(out))
    leg = overlap_bench.streaming_leg(rk, np.ones(n, np.int32), s_keys, s_pay,
                                      segments=STREAM_COPIES, expect=want,
                                      device=DEVICE)
    if not leg["correct"]:
        raise AssertionError(f"overlap streaming leg: {leg}")
    print(f"[streaming] {CARD['line']}; R 2^{HEADLINE_SCALE} on the card x S "
          f"{s.num_rows} rows in host memory; " + "; ".join(lines)
          + f"; data {t_data:.1f}s")
    print(f"[streaming] {CARD['line']}; overlap {json.dumps(leg)}")
    return first


def _coprocess_config() -> EngineConfig:
    """The default configuration where the headline's rows exceed its
    resident limit (2^27 > 128,000,001), as on the card; at a smaller
    HEADLINE_SCALE a limit below the headline's rows, so it routes the same."""
    cfg = EngineConfig()
    if (1 << HEADLINE_SCALE) <= cfg.resident_limit_rows:
        cfg = EngineConfig(resident_limit_rows=1 << (HEADLINE_SCALE - 1))
    return cfg


def phase_coprocess(big) -> int:
    """Host co-processing: the headline's relations (payloads 1) as CPU
    relations under `_coprocess_config()`, against the checked-in oracle;
    the overlap tool's co-processing leg on them; then the Zipf z=1.05
    relations of `_zipf_tables` (full-range payloads) with the resident
    limit at half their rows, against the C++ oracle. Returns kernel 1's
    launches in the first call."""
    rk, sk, _, _ = big
    ones = np.ones(1 << HEADLINE_SCALE, np.int32)
    r = Relation.from_numpy(rk, ones, device="cpu")
    s = Relation.from_numpy(sk, ones, device="cpu")
    cfg = _coprocess_config()
    want = _oracle_value(HEADLINE_SCALE, 0.0)
    out = _regime_call(r, s, cfg, "coprocess", want, "coprocess")
    leg = overlap_bench.coprocess_leg(rk, ones, sk, ones, cfg, expect=want,
                                      device=DEVICE)
    if not leg["correct"]:
        raise AssertionError(f"overlap coprocess leg: {leg}")
    print(f"[coprocess] {CARD['line']}; 2^{HEADLINE_SCALE} x "
          f"2^{HEADLINE_SCALE} from host memory, resident limit "
          f"{cfg.resident_limit_rows} = {want} (oracle), {leg['batches']} "
          f"batches, {leg['pairs']} pairs; " + _regime_line(out))
    print(f"[coprocess] {CARD['line']}; overlap {json.dumps(leg)}")

    zk_r, zp_r, zk_s, zp_s = _zipf_tables()
    zcfg = EngineConfig(resident_limit_rows=zk_r.size // 2)
    zwant = datagen.oracle_join_aggregate(zk_r, zp_r, zk_s, zp_s)
    zout = _regime_call(Relation.from_numpy(zk_r, zp_r, device="cpu"),
                        Relation.from_numpy(zk_s, zp_s, device="cpu"), zcfg,
                        "coprocess", zwant, "coprocess zipf 1.05")
    print(f"[coprocess] {CARD['line']}; 2^{MID_SCALE - 2} zipf1.05, "
          f"full-range payloads, resident limit {zcfg.resident_limit_rows} = "
          f"{zwant} (C++ oracle); " + _regime_line(zout))
    return out["launches"]["banded_window_sum"]


def _colsum_kernel():
    """The column-sum kernel against its plain version at the late cell's
    2^27 rows, 4 and 2 columns, ids in order and shuffled, and its time
    alone beside its bound (each id and column read once, one int32
    written) and the plain version's."""
    n = 1 << HEADLINE_SCALE
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    in_order = torch.arange(n, dtype=torch.int32, device=DEVICE)
    shuffled = torch.randperm(n, generator=gen, device=DEVICE).to(torch.int32)
    for c in (4, 2):
        cols = torch.randint(-2**31, 2**31 - 1, (n, c), generator=gen,
                             device=DEVICE, dtype=torch.int32)
        for ids, order in ((in_order, "in order"), (shuffled, "shuffled")):
            what = f"row_colsums at 2^{HEADLINE_SCALE} x {c}, ids {order}"
            got, launches = _launched(lambda: row_colsums.row_colsums(cols, ids))
            if launches["row_colsums"] != 1:
                raise AssertionError(f"{what}: launches {launches}")
            if not torch.equal(got, row_colsums.torch_row_colsums(cols, ids)):
                raise AssertionError(f"{what}: != the plain version")
            del got
            ms = _time_ms(lambda: row_colsums.row_colsums(cols, ids), 20)
            plain_ms = _time_ms(lambda: row_colsums.torch_row_colsums(cols, ids), 3)
            bound_ms = (4 * c + 8) * n / CARD["hbm_bytes_per_s"] * 1e3
            print(f"[late] {what}: equal to plain; kernel {ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({4 * c + 8} B a row, "
                  f"{100 * bound_ms / ms:.2f}%), plain {plain_ms:.4f} ms",
                  flush=True)
        del cols
    del in_order, shuffled
    torch.cuda.empty_cache()


def phase_late():
    _colsum_kernel()
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
    _require_windowed_per_s(launches, "late")
    _require(launches, "late", "row_colsums")
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
    _require_windowed_per_s(launches, "pipeline")
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


# ---- the distributed layer ---------------------------------------------------

def _expect_agg(what: str, want: int):
    """A check of an (aggregate, overflow, ...) result."""
    def check(out):
        agg, ov = int(out[0]), int(out[1])
        if ov != 0 or agg != want:
            raise AssertionError(f"{what}: aggregate {agg}, overflow {ov}; "
                                 f"oracle {want}, overflow 0")
    return check


# the wrappers band_join calls, and the (CH, W) of a call from its
# arguments: a chunk kernel's window array [CH, W*128]; a windowed kernel's
# ids [CH] and w
WINDOW_ARG = {
    "banded_compare_per_s": lambda a: (a[1].shape[0],
                                       a[1].shape[1] // band_compare.LANES),
    "banded_interval_select": lambda a: (a[1].shape[0],
                                         a[1].shape[1] // band_compare.LANES),
    **{name: probe_bench.SHAPE_OF[name] for name in TWIN},
}


@contextlib.contextmanager
def _shapes_seen(seen: dict):
    """While the block runs, add to seen[name] the (CH, W) that each banded
    kernel's wrapper gets from band_join: its names there are swapped for
    recorders that call the wrapper."""
    real = {name: getattr(band_join, name) for name in WINDOW_ARG}

    def recorder(name):
        def call(*args):
            seen.setdefault(name, set()).add(WINDOW_ARG[name](args))
            return real[name](*args)
        return call

    for name in WINDOW_ARG:
        setattr(band_join, name, recorder(name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(band_join, name, fn)


def _dist_leg(what: str, fn, check, kernels, report: list, counts: dict,
              seen: dict):
    """A warm-up call with its launches counted and checked and the kernels'
    shapes recorded, then the best of REPS, checked again. Records the
    launches of `kernels`; returns (the best seconds, the last result)."""
    with _shapes_seen(seen):
        out, launches = _launched(fn)
    check(out)
    _require(launches, what, *kernels)
    best, out = _best_s(fn)
    check(out)
    counts[what] = {k: launches[k] for k in kernels}
    report.append(f"{what} {best * 1e3:.3f} ms (launches "
                  f"{', '.join(f'{k} {launches[k]}' for k in kernels)})")
    return best, out


def _nccl_legs(report: list, counts: dict, seen: dict):
    """Config 5's legs in a 1-rank NCCL world, run by `run_configs`' own
    one-card code, which makes the data and the oracles and judges each
    line; each leg goes through `_dist_leg`, its warm-up and timed results
    required to agree. NCCL's init failing fails the phase."""
    k1 = ("banded_window_sum",)

    def run(tag, fn):
        first = []

        def check(out):
            got = (int(out[0]), int(out[1]))
            if first and got != first[0]:
                raise AssertionError(f"{tag}: warm-up {first[0]}, then {got}")
            first.append(got)
        return _dist_leg(f"nccl 1 rank {tag}", fn, check, k1, report, counts,
                         seen)

    lines = run_configs._one_rank_legs(1 << DIST_SCALE, DEVICE, run=run)
    bad = [line for line in lines if not line["correct"]]
    if bad:
        raise AssertionError(f"run_configs config 5: {bad}")
    return lines


def _thread_inputs():
    """The thread world's relations: 2^DIST_THREAD_SCALE a side, full-range
    payloads, and S with DIST_HOT of its rows on one key (numpy)."""
    n = 1 << DIST_THREAD_SCALE
    rk, sk = datasets.make_pk_fk(n, n, seed=SEED)
    rng = np.random.RandomState(SEED + 9)
    rp = rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    sp = rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    hot = np.where(rng.rand(n) < DIST_HOT, rk[0], sk).astype(np.int32)
    return rk, rp, sk, sp, hot


def _thread_legs(report: list, counts: dict, seen: dict, inputs, wants,
                 pairs):
    """The 8-rank thread world on the card; `wants` are the C++ oracle's
    aggregates of the uniform and the hot relations, `pairs` the numpy
    materialize oracle's (Pr, Ps) rows, sorted."""
    rk, rp, sk, sp, hot = inputs
    want, want_hot = wants
    n = rk.size
    r, p_r, s, p_s, s_hot = (torch.from_numpy(a).to(DEVICE)
                             for a in (rk, rp, sk, sp, hot))
    mesh = make_mesh(DIST_RANKS, device=DEVICE)
    mesh2 = make_mesh_2d(2, DIST_RANKS // 2, device=DEVICE)
    k1 = ("banded_window_sum",)
    tag = f"{DIST_RANKS} threads"

    _dist_leg(f"{tag} segmented", lambda: (
        dist_join.distributed_join_segmented(
            r, p_r, s, p_s, mesh, num_segments=4)),
        _expect_agg("segmented", want), k1, report, counts, seen)

    planned = mesh.run(lambda c, a, b: xplan.plan_heavy_split(
        a, b, c["x"], DIST_RANKS, segments=4).heavy_ids, r, s_hot)
    if not planned[0] or any(h != planned[0] for h in planned):
        raise AssertionError(f"heavy split not planned alike: {planned}")
    check_hot = _expect_agg("heavy split", want_hot)

    def check_loads(out):
        check_hot(out)
        loads = out[2]
        if loads.sum() != n or loads.max() > 2.0 * loads.mean():
            raise AssertionError(f"heavy split: executed loads {loads.tolist()}"
                                 f" (sum {loads.sum()}, {n} probe rows)")

    _, (_, _, loads) = _dist_leg(
        f"{tag} segmented heavy split", lambda: (
            dist_join.distributed_join_segmented(
                r, p_r, s_hot, p_s, mesh, num_segments=4, return_loads=True)),
        check_loads, k1, report, counts, seen)
    report.append(f"{DIST_HOT:.0%} of S on one key: {len(planned[0])} heavy "
                  f"fine buckets; executed per-rank loads {loads.tolist()}, "
                  f"spread max/mean {loads.max() / loads.mean():.4f}")

    _dist_leg(f"{tag} 2-level {mesh2.shape}", lambda: (
        dist_join.distributed_join_aggregate_2level(r, p_r, s, p_s, mesh2)),
        _expect_agg("2-level", want), k1, report, counts, seen)

    # as dryrun_multichip sizes it
    cap = max(128, -(-2 * max(pairs.shape[0], 1) // 128) * 128)

    def check_pairs(out):
        out_r, out_s, totals, ov = out
        totals = totals.cpu().numpy()
        if int(ov) != 0 or totals.sum() != pairs.shape[0] or totals.max() > cap:
            raise AssertionError(f"materialize: totals {totals.tolist()}, "
                                 f"overflow {int(ov)}; {pairs.shape[0]} pairs")
        out_r, out_s = out_r.cpu().numpy(), out_s.cpu().numpy()
        got = np.concatenate([np.stack([out_r[d * cap:d * cap + t],
                                        out_s[d * cap:d * cap + t]], axis=1)
                              for d, t in enumerate(totals)])
        if not np.array_equal(got[np.lexsort((got[:, 1], got[:, 0]))], pairs):
            raise AssertionError("materialize: not the oracle's multiset")

    _dist_leg(f"{tag} materialize", lambda: (
        dist_join.distributed_join_materialize(r, p_r, s, p_s, mesh,
                                               capacity_per_chip=cap)),
        check_pairs, ("banded_window_first", "extract_pairs"), report, counts,
        seen)
    # the block-windowed fast path, as the JAX engine routes it: kernels 4
    # and 2 at the shapes a rank gives them
    routed = dist_join.banded_materialize
    dist_join.banded_materialize = functools.partial(routed, debug_force="fast")
    try:
        _dist_leg(f"{tag} materialize, fast path forced", lambda: (
            dist_join.distributed_join_materialize(r, p_r, s, p_s, mesh,
                                                   capacity_per_chip=cap)),
            check_pairs, ("banded_window_first", "banded_interval_select",
                          "banded_compare_per_s"), report, counts, seen)
    finally:
        dist_join.banded_materialize = routed
    report.append(f"2^{DIST_THREAD_SCALE} x 2^{DIST_THREAD_SCALE} global, "
                  f"full-range payloads, C++ oracles {want} and {want_hot}, "
                  f"{pairs.shape[0]} pairs into {cap} a rank")

    line, launches = _launched(lambda: dryrun.dryrun_multichip(DIST_RANKS,
                                                               DEVICE))
    _require(launches, "dryrun_multichip", *k1)
    report.append(line)


def _hold_seen(seen: dict, report: list) -> dict:
    """Each banded kernel against its plain version at every (CH, W) in
    `seen`, and both times at the largest and the smallest CH (a tail
    chunk) of each width W; the chunk entry points of kernels 1 and 3 at
    their windowed twins' shapes. Per kernel: {"held_at": the shapes,
    "max_abs_err", "timed": the ends' errors and times}."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 1)
    held = {}
    twin_of = {chunk: win for win, chunk in TWIN.items()}
    for name in KERNELS:
        shapes = sorted(set(seen.get(name, ())) | seen.get(twin_of.get(name),
                                                           set()),
                        key=lambda shape: shape[::-1])
        err = _hold(name, shapes, gen)
        ends = {}
        for ch, w in shapes:
            lo, hi = ends.get(w, (ch, ch))
            ends[w] = (min(lo, ch), max(hi, ch))
        timed = []
        for ch, w in sorted({(ch, w) for w, pair in ends.items() for ch in pair},
                            key=lambda shape: shape[::-1]):
            st = {"shape": [ch, w], "max_abs_err": _hold(name, [(ch, w)], gen),
                  **_time_at(name, ch, w, gen)}
            timed.append(st)
            report.append(f"{name} at ({ch}, {w}): kernel {st['ms']:.4f} ms, "
                          f"plain {st['plain_ms']:.4f} ms, bound "
                          f"{st['bound_ms']:.4f} ms by {st['bound_by']}")
        if shapes:
            report.append(f"{name} equal to plain at all {len(shapes)} (CH, W) "
                          f"seen: {shapes}")
        held[name] = {"held_at": [list(shape) for shape in shapes],
                      "max_abs_err": max([err] + [st["max_abs_err"]
                                                  for st in timed]),
                      "timed": timed}
    return held


def phase_distributed() -> tuple:
    """Returns, for each banded kernel, its launches on each leg, and its
    holds at the shapes the legs gave it (`_hold_seen`); and config 5's
    lines. Each world's data and oracles are made before its first leg, so
    no leg is timed beside host work of the script's own."""
    report, counts, seen = [], {}, {}
    c5 = _nccl_legs(report, counts, seen)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        inputs = _thread_inputs()
        pairs = pool.submit(oracle.join_materialize, *inputs[:4])
        rk, rp, sk, sp, hot = inputs
        wants = (datagen.oracle_join_aggregate(rk, rp, sk, sp),
                 datagen.oracle_join_aggregate(rk, rp, hot, sp))
        pairs = pairs.result()
    report.append(f"thread world's data and oracles "
                  f"{time.perf_counter() - t0:.1f}s, before its legs")
    _thread_legs(report, counts, seen, inputs, wants, pairs)
    held = _hold_seen(seen, report)
    print("[distributed] " + "; ".join(report))
    return ({name: {leg: c[name] for leg, c in counts.items() if name in c}
             for name in KERNELS}, held, c5)


# ---- the surface: CLI, bench, run_configs, group-by ------------------------

def _cli_run(argv, seen: dict):
    """`cli.main(argv)` on the card, its stdout captured and its banded
    kernels' shapes recorded; returns (the `N results` number, the lines,
    the launch counts of the call)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), _shapes_seen(seen):
        rc, launches = _launched(lambda: cli.main(argv, device=DEVICE))
    lines = out.getvalue().splitlines()
    if rc != 0:
        raise AssertionError(f"cli {argv}: exit {rc}: {lines}")
    (result,) = [int(line.split()[0]) for line in lines
                 if line.endswith(" results")]
    return result, lines, launches


def _surface_cli(report: list, k1: dict, seen: dict):
    """The reference's invocation (-b 7), then --materialize and -b 8, each
    equal to the C++ oracle on the relations the CLI reads."""
    n_r, n_s = int(SURFACE_CLI[3]), int(SURFACE_CLI[5])
    rk, sk = datasets.make_pk_fk(n_r, n_s, seed=SEED)   # the CLI's .bin files
    want = datagen.oracle_join_aggregate(rk, np.ones(n_r, np.int32), sk,
                                         np.ones(n_s, np.int32))
    for tag, argv, kernels in (
            ("cli -b 7", ["-b", "7"], ("banded_window_sum",)),
            ("cli --materialize", ["-b", "7", "--materialize"],
             ("banded_window_first",)),
            ("cli -b 8", ["-b", "8"], ())):
        got, lines, launches = _cli_run(argv + SURFACE_CLI, seen)
        if got & 0xFFFFFFFF != want & 0xFFFFFFFF:
            raise AssertionError(f"{tag}: {got} results, C++ oracle {want}")
        _require(launches, tag, *kernels)
        k1[tag] = launches["banded_window_sum"]
        ran = {k: v for k, v in launches.items() if v}
        report.append(f"{tag} {n_r} x {n_s}: {got} results = C++ oracle "
                      f"({'; '.join(lines[2:5])}; launches {ran})")


def _surface_groupby(report: list):
    """Both group-by paths at 2^24 rows on the card against
    `oracle.groupby_aggregate`, with their device times."""
    n, groups, hi = SURFACE_GROUPBY
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 10)
    g = _ints(gen, 0, groups, (n,))
    v = _ints(gen, 0, hi, (n,))
    want = oracle.groupby_aggregate(g.cpu().numpy(), v.cpu().numpy(), groups)
    for name, fn in (("sort", groupby.groupby_count_sum),
                     ("one-hot", groupby.groupby_count_sum_onehot)):
        got = fn(g, v, groups)
        for col, w, what in zip(got, want, ("COUNT", "SUM")):
            if not np.array_equal(col.cpu().numpy(), w):
                raise AssertionError(f"group-by {name} {what} != oracle")
        ms = _time_ms(lambda: fn(g, v, groups), REPS)
        report.append(f"group-by {name} 2^{n.bit_length() - 1} rows x "
                      f"{groups} groups = oracle, {ms:.3f} ms")
    # the profiler hooks: one call traced under an annotation; the Chrome
    # trace must hold the span and, on the card, the card's kernels
    logdir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        with profiling.maybe_trace("surface", logdir, device=DEVICE):
            with profiling.annotate("surface.groupby", device=DEVICE):
                groupby.groupby_count_sum(g, v, groups)
                torch.cuda.synchronize()
        (trace,) = os.listdir(os.path.join(logdir, "surface"))
        with open(os.path.join(logdir, "surface", trace)) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    spans = sum(e.get("name") == "surface.groupby" for e in events)
    kernels = sum(e.get("cat") == "kernel" for e in events)
    if not spans or (DEVICE == "cuda" and not kernels):
        raise AssertionError(f"profiler trace: {spans} spans, {kernels} kernels")
    report.append(f"profiler trace of the sort group-by: its span and "
                  f"{kernels} kernels")


def _check_shares(line: dict):
    """The bench's speed-of-light shares each in (0, 1], its memory rate
    the data sheet's for the card's name, its measured sort rate > 0."""
    bad = [key for key in bench.SHARES if not 0 < line[key] <= 1]
    if bad:
        raise AssertionError(f"bench: shares {bad} outside (0, 1]: {line}")
    sheet = timing.datasheet_hbm_gbps(torch.cuda.get_device_name(0))
    if line["hbm_gbps"] != sheet:
        raise AssertionError(f"bench: hbm_gbps {line['hbm_gbps']}, the data "
                             f"sheet's {sheet}")
    if not line["sort_frontier_rows_s"] > 0:
        raise AssertionError(f"bench: sort rate {line['sort_frontier_rows_s']}")


def phase_surface(c5=None) -> tuple:
    """The user surface on the card: the CLI, the bench at 2^27, run_configs
    configs 1 and 2 at their default sizes, the group-by; `c5` is config 5's
    lines from the distributed phase, reported here. Returns kernel 1's
    launches on each call, and the banded kernels' holds at the shapes the calls
    gave them (`_hold_seen`)."""
    report, k1, seen = [], {}, {}
    _surface_cli(report, k1, seen)

    with _shapes_seen(seen):
        line, launches = _launched(lambda: bench.run(
            scale=SURFACE_BENCH_SCALE, reps=REPS, sort_impl="lax",
            device=DEVICE))
    want = _oracle_value(SURFACE_BENCH_SCALE, 0.0)
    if not line["correct"] or line["aggregate"] != want:
        raise AssertionError(f"bench: {line}; checked-in oracle {want}")
    _require(launches, "bench", "banded_window_sum")
    k1["bench"] = launches["banded_window_sum"]
    print(json.dumps(line))
    _check_shares(line)
    report.append("bench shares " + ", ".join(
        f"{key} {line[key]:.4f}" for key in bench.SHARES))

    for tag, fn in (
            ("config 1", lambda: [run_configs.config1(DEVICE, *SURFACE_CONFIG1)]),
            ("config 2", lambda: run_configs.config2(SURFACE_CONFIG2_SCALE,
                                                     DEVICE))):
        with _shapes_seen(seen):
            lines, launches = _launched(fn)
        bad = [ln for ln in lines if not ln["correct"]]
        if bad:
            raise AssertionError(f"run_configs {tag}: {bad}")
        _require(launches, tag, "banded_window_sum")
        k1[tag] = launches["banded_window_sum"]
        report.append(f"run_configs {tag}: {len(lines)} lines correct")
    if c5 is not None:
        report.append(f"run_configs config 5: {len(c5)} lines correct, in "
                      f"the distributed phase, with dryrun_multichip(8)")

    held = _hold_seen(seen, report)
    _surface_groupby(report)
    report.append(f"kernel 1 launches {k1}")
    print("[surface] " + "; ".join(report))
    return k1, held


def phase_rates():
    """The three rate tools at 2^RATES_SCALE rows through their entry
    points: exit 0, every line with its keys, every time > 0, every
    grouping's output holding the input's rows (`ok`), the card's line
    last. Their lines are printed as they come."""
    for name, (tool, argv, keys) in RATE_TOOLS.items():
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = tool.main(argv + [str(RATES_SCALE), "--device", DEVICE])
        text = out.getvalue().splitlines()
        print("\n".join(text), flush=True)
        lines = [json.loads(line) for line in text[:-1]]
        if rc != 0 or not lines or text[-1] != CARD["line"]:
            raise AssertionError(f"{name}: exit {rc}, {len(lines)} lines, "
                                 f"last {text[-1:]}")
        for line in lines:
            if (keys - set(line) or line["tool"] != name
                    or not line["ms"] > 0 or line.get("ok") is False):
                raise AssertionError(f"{name}: {line}")
        print(f"[rates] {name}: {len(lines)} lines", flush=True)


def _timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase] {name} {time.perf_counter() - t0:.1f}s", flush=True)
    return out


PHASES = ("kernel", "kernel ranges", "kernel merge", "kernel sort tiles",
          "kernel stage", "probes", "sort tools", "mid", "headline", "sorts",
          "materialize", "partitioned", "streaming", "coprocess", "late",
          "pipeline", "distributed", "surface", "rates")
# phases that join the headline's 2^27 relations, which `headline` makes
NEED_HEADLINE = ("sorts", "materialize", "partitioned", "streaming",
                 "coprocess")


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
             "late": phase_late, "pipeline": phase_pipeline,
             "distributed": phase_distributed, "surface": phase_surface,
             "rates": phase_rates}
    with_big = {"sorts": phase_sorts, "materialize": phase_materialize,
                "partitioned": phase_partitioned,
                "streaming": phase_streaming, "coprocess": phase_coprocess}
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
    sorts, kstats["radix_sort_pairs"] = _timed("sorts", phase_sorts, big)
    (kstats["extract_pairs"], routed, fast,
     ring) = _timed("materialize", phase_materialize, big)
    # kernels 4 and 2's chunk entry on the fast path, forced
    for name in ("banded_interval_select", "banded_compare_per_s"):
        kstats[name]["launches_fast_forced"] = fast[name]
    part, at_config2 = _timed("partitioned", phase_partitioned, big)
    kstats["probe_aggregate_ranges"].update(at_config2)
    # kernel 1's launches in the out-of-memory regimes, beside the headline's
    kstats["banded_window_sum"]["launches_streaming"] = _timed(
        "streaming", phase_streaming, big)
    kstats["banded_window_sum"]["launches_coprocess"] = _timed(
        "coprocess", phase_coprocess, big)
    del big
    torch.cuda.empty_cache()
    late = _timed("late", phase_late)
    pipe = _timed("pipeline", phase_pipeline)
    kstats["banded_window_per_s"]["launches_late"] = late["banded_window_per_s"]
    torch.cuda.empty_cache()
    legs, held, c5 = _timed("distributed", phase_distributed)
    torch.cuda.empty_cache()
    k1_surface, at_surface = _timed("surface", phase_surface, c5)
    kstats["banded_window_sum"]["launches_surface"] = k1_surface
    _timed("rates", phase_rates)
    for name in KERNELS:
        kstats[name]["launches_distributed"] = legs[name]
        kstats[name]["at_distributed"] = held[name]
        kstats[name]["at_surface"] = at_surface[name]
        kstats[name]["max_abs_err"] = max(kstats[name]["max_abs_err"],
                                          held[name]["max_abs_err"],
                                          at_surface[name]["max_abs_err"])
    # each kernel's launches on its path: the aggregate, the config-3
    # pipeline, the config-2 ring, the routed 2^24 materialize, the config-2
    # "pallas" aggregate, the 2^27 aggregate under "merge"; the tile sort's
    # call, `bench_stages`, the probe ladder. The chunk entry points of
    # kernels 1 and 3 lie on no path now (0 on the aggregate and the ring,
    # where their windowed twins run); nor do kernel 4 and kernel 2's chunk
    # entry (0 on the routed materialize, where the extraction kernel runs;
    # their counts with the fast path forced under "launches_fast_forced");
    # kernel 2's windowed twin on the config-3 pipeline
    launches = {"banded_compare_sum": head["banded_compare_sum"],
                "banded_compare_per_s": routed["banded_compare_per_s"],
                "banded_window_per_s": pipe["banded_window_per_s"],
                "banded_compare_first": ring["banded_compare_first"],
                "banded_window_sum": head["banded_window_sum"],
                "banded_window_first": ring["banded_window_first"],
                "banded_interval_select": routed["banded_interval_select"],
                "extract_pairs": routed["extract_pairs"],
                "probe_aggregate_ranges": part["probe_aggregate_ranges"],
                "merge_levels_vmem": sorts["merge_levels_vmem"],
                "merge_level_hbm": sorts["merge_level_hbm"],
                # a histogram and four passes a side of the 2^27 aggregate
                "radix_sort_pairs": (head["radix_histogram"]
                                     + head["radix_pass"]), **tools}
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
