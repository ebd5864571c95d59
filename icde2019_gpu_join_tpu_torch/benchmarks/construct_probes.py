"""A ladder of minimal kernels, each one construct of the merge kernels more
than the last.

Counterpart of `benchmarks/mosaic_bisect.py`; the CUDA kernels are in
`csrc/construct_probes.cu` (`tj_probe_*`). On the TPU the ladder only
compiled: it found the construct that crashed the kernel compiler. `nvcc`
has no such crash to find, so here every probe runs its construct on seeded
random int32 blocks and is held against its plain version; each kernel is
built around the Hopper construct that stands for the TPU construct the
reference's probe isolated:

  min_dma          a meta-indexed window of [64, 128] copied by the Tensor
                   Memory Accelerator (a 1-D bulk copy onto an mbarrier, a
                   bulk store back out at the same rows); the kernel zeroes
                   the other rows itself;
  min_dma_compute  two such windows on two mbarriers, the merge-path masking
                   on the way into registers, a bitonic merge in registers,
                   key + payload out by a bulk store;
  concat_only      the concatenation of two blocks through registers, 16
                   bytes a thread;
  concat_merge     concatenation and the merge ladder, two windows a launch;
  lane_64 / lane_16 / lane_1   one stage at that distance, spread over
                   blocks, four exchanges a thread in 16-byte loads;
  sublane_ladder   the stages at distance 2^13 .. 128;
  dirmask_stage    one stage at distance 128, direction from the row parity;
  transpose_only   `a.T.T + 1` through padded shared-memory tiles, a
                   [32, 32] sub-tile a block;
  lane_ladder_T    the stages at distance 64 .. 1, which the TPU ran as row
                   stages on the transposed tile: here in shuffles and
                   registers;
  full_merge_T     the merge of two [128, 128] blocks (2^15 pairs);
  merge_T_dm       the same with every stage's direction from the row parity.

The five ladders and min_dma_compute hold their pairs in registers, a
problem cut into slices, one a CTA, with the stages between slices through
distributed shared memory in a thread-block cluster. How many CTAs is a
constant of each kernel (`ladder_spec` in the CUDA source), the count
measured fastest alone (PERF.md, section 6); `form` reads it back from the
build, with `cudaOccupancyMaxActiveClusters` of a cluster.

Seven more probes run the in-block merge kernel and the merge-path kernel
(`ops/merge.py`) at the reference's geometries against their plain versions:
`vmem`, `vmem_lt`, `vmem_one_level`, `vmem_lt_1`, `vmem_lt_param`, `hbm`,
`hbm_db`. `lane_transpose` and `double_buffer` select nothing on this card,
so `vmem_lt`, `vmem_lt_1` and `hbm_db` are the launches of `vmem`,
`vmem_one_level` and `hbm`. `vmem_lt_param` takes its geometry from
`--run`, `--levels` and `--tile` (log2 of the run and of the tile); a
geometry whose output run does not fit a thread block reports the wrapper's
`ValueError` in its line and does not count as a failure.

`min_dma_compute` reads one [7, ntiles] table, the layout of
`merge.merge_level_meta` (rows 0, 1 the windows' first rows, 2..5 the valid
spans, 6 the output row). The reference's probe indexed a [2, 7] table as
`meta[t, 0]` while its masking read `meta[k, t]`; it only ever compiled.

On CUDA tensors a construct launches its kernel (built with nvcc at first
use) or raises, a refused cluster launch included; on CPU tensors it runs
the plain version. `LAUNCHES` counts the probe kernels launched.

The blocks are so small that a probe's time is mostly its launch. Each
probe's line says how much: `ms` is its wrapper's time by CUDA events around
one call (the host's allocation and launch inside), `device_ms` its kernel
alone, the mean of `DEVICE_REPS` launches on a preallocated output queued
while the card sleeps (`utils.timing.queued_ms`), `floor_ms` the same for an
empty kernel
through the same launcher (`empty_launch`: no probe, not counted), and
`bound_ms` its bytes and exchanges (`PROBE_ELEMENTS`, `PROBE_EXCHANGES`)
over the card's rates. The device numbers are `null` on the CPU.

Usage: python -m icde2019_gpu_join_tpu_torch.benchmarks.construct_probes
           [probe ...] [--device cpu] [--run 12 --levels 1 --tile 14]
           [--kernels]
(no names = all probes in order). Prints one JSON line per probe,
`{"probe": name, "ok": true, "ms": ..., "plain_ms": ..., "device_ms": ...}`
(`ms` the best of 5 calls, `plain_ms` of 2 of the plain version), goes on
after a failing probe and exits 1 if any failed. `--kernels` prints instead
one line of each construct kernel's `device_ms` and nothing else of the
module's own (it runs on any build of `csrc/construct_probes.cu` whose entry
points take these operands, an older one included).
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import sys
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from icde2019_gpu_join_tpu_torch.ops import _build, _launches, merge
from icde2019_gpu_join_tpu_torch.utils import timing
from icde2019_gpu_join_tpu_torch.utils.timing import best_ms, queued_ms

LANES = 128
WROW = 64                   # rows of a copy window
WINDOW = WROW * LANES       # 8192 elements
BLOCK_ROWS = 2 * WROW       # rows of a full block
BLOCK = BLOCK_ROWS * LANES  # 2^14 elements

# the C entry points `tj_probe_<name>` of csrc/construct_probes.cu
ENTRY_POINTS = ("min_dma", "min_dma_compute", "concat_only", "concat_merge",
                "stage", "sublane_ladder", "dirmask_stage", "transpose_only",
                "lane_ladder_T", "full_merge_T", "merge_T_dm", "empty")

# the probes whose kernel is the ladders' (`tj_probe_form` takes them)
LADDERS = ("sublane_ladder", "lane_ladder_T", "concat_merge", "full_merge_T",
           "merge_T_dm", "min_dma_compute")

# The exchanges of each construct probe, (stages, exchanges a stage), and the
# int32 elements it reads and writes (each input read once, each output
# written once; of x, min_dma and min_dma_compute read only the windows of
# their default table, two and four distinct ones of 64 rows, and their
# table): its bound. An exchange is a compare and four selects.
PROBE_EXCHANGES = {
    "transpose_only": (0, 0), "concat_only": (0, 0), "min_dma": (0, 0),
    "lane_64": (1, 1 << 13), "lane_16": (1, 1 << 13), "lane_1": (1, 1 << 13),
    "dirmask_stage": (1, 1 << 13), "sublane_ladder": (7, 1 << 13),
    "lane_ladder_T": (7, 1 << 13), "concat_merge": (14, 1 << 14),
    "min_dma_compute": (14, 1 << 14), "full_merge_T": (15, 1 << 14),
    "merge_T_dm": (15, 1 << 14)}
PROBE_ELEMENTS = {
    "transpose_only": 2 << 14, "concat_only": 2 << 14,
    "min_dma": (3 << 14) + 4,
    "lane_64": 3 << 14, "lane_16": 3 << 14, "lane_1": 3 << 14,
    "dirmask_stage": 3 << 14, "sublane_ladder": 3 << 14,
    "lane_ladder_T": 3 << 14, "concat_merge": 4 << 14,
    "min_dma_compute": (2 << 15) + 14, "full_merge_T": 3 << 14,
    "merge_T_dm": 3 << 14}
OPS_PER_EXCHANGE = 5

# the launches a device time is the mean of
DEVICE_REPS = 50

# Probe kernels launched since the last reset.
LAUNCHES: Dict[str, int] = {"construct_probes": 0}


def reset_launches():
    _launches.reset(LAUNCHES)


# ---------------------------------------------------------------------------
# plain versions: whole-array torch operations on the flat blocks
# ---------------------------------------------------------------------------

def _row_parity(n: int, d: int, device) -> torch.Tensor:
    """bool [n / 2d, d]: per exchange of a stage at distance d over n flat
    elements, the parity of the row (of 128) that holds its lower element:
    the per-row direction mask."""
    lo = (torch.arange(n // (2 * d), device=device) * (2 * d))[:, None] \
        + torch.arange(d, device=device)
    return ((lo >> 7) & 1).bool()


def _ladder(sv: torch.Tensor, pv: torch.Tensor, d_hi: int, d_lo: int = 1,
            row_mask: bool = False):
    """The stages at distance d_hi .. d_lo over the flat arrays."""
    d = d_hi
    while d >= d_lo:
        flip = _row_parity(sv.shape[0], d, sv.device) if row_mask else None
        sv, pv = merge._cx(sv, pv, d, flip=flip)
        d //= 2
    return sv, pv


def _flat(*blocks: torch.Tensor):
    return tuple(x.reshape(-1) for x in blocks)


def min_dma_ref(meta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    o = torch.zeros_like(x)
    for t in range(2):
        r0 = int(meta[t, 0])
        o[r0:r0 + WROW] = x[r0:r0 + WROW]
    return o


def min_dma_compute_ref(meta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    o = torch.zeros_like(x)
    idx = torch.arange(WINDOW, device=x.device)
    for t in range(meta.shape[1]):
        a_row, b_row, a_lo, a_hi, b_wlo, b_whi, out_row = (
            int(v) for v in meta[:, t])
        a_raw = x[a_row:a_row + WROW].reshape(-1)
        b_raw = x[b_row:b_row + WROW].reshape(-1)
        a = torch.where(idx < a_lo, merge.INT_MIN, a_raw)
        a = torch.where(idx >= a_hi, merge.INT_MAX, a)
        b = torch.where(idx < b_wlo, merge.INT_MAX, ~b_raw)   # stored -> working
        b = torch.where(idx >= b_whi, merge.INT_MIN, b)
        sv, pv = _ladder(torch.cat([a, b]), torch.cat([a_raw, b_raw]), WINDOW)
        o[out_row:out_row + WROW] = (sv + pv)[:WINDOW].view(WROW, LANES)
    return o


def concat_only_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.cat([a, b], 0)


def concat_merge_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per window t of 64 rows: keys a_t over b_t, payloads b_t over a_t."""
    at, bt = a.view(2, WROW, LANES), b.view(2, WROW, LANES)
    sv, pv = _ladder(*_flat(torch.stack([at, bt], 1), torch.stack([bt, at], 1)),
                     BLOCK // 2)
    return (sv + pv).view(2 * BLOCK_ROWS, LANES)


def stage_ref(a: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    sv, pv = _ladder(*_flat(a, b), d, d)
    return (sv + pv).view_as(a)


def sublane_ladder_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    sv, pv = _ladder(*_flat(a, b), BLOCK // 2, LANES)
    return (sv + pv).view_as(a)


def dirmask_stage_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    sv, pv = _ladder(*_flat(a, b), LANES, LANES, row_mask=True)
    return (sv + pv).view_as(a)


def transpose_only_ref(a: torch.Tensor) -> torch.Tensor:
    return a.t().contiguous().t().contiguous() + 1


def lane_ladder_T_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A row stage on the transposed tile is a stage at a distance below 128
    on the tile itself."""
    sv, pv = _ladder(*_flat(a, b), LANES // 2)
    return (sv + pv).view_as(a)


def full_merge_T_ref(a: torch.Tensor, b: torch.Tensor,
                     row_mask: bool = False) -> torch.Tensor:
    sv, pv = _ladder(*_flat(torch.cat([a, b], 0), torch.cat([b, a], 0)), BLOCK,
                     row_mask=row_mask)
    return (sv[:BLOCK] + pv[BLOCK:]).view_as(a)


def merge_T_dm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return full_merge_T_ref(a, b, row_mask=True)


# ---------------------------------------------------------------------------
# the constructs: kernel on the card, plain version on the CPU
# ---------------------------------------------------------------------------

def _check_block(name: str, x: torch.Tensor, rows: Optional[int], like=None):
    if (x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != LANES
            or not x.is_contiguous()
            or (rows is not None and x.shape[0] != rows)):
        raise ValueError(f"{name}: expected a contiguous int32 "
                         f"[{rows or 'rows'}, {LANES}] tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda") or (
            like is not None and x.device != like.device):
        raise ValueError(f"{name}: on {x.device}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned (the kernels copy and "
                         f"load 16 bytes at a time)")


@functools.lru_cache(maxsize=None)
def _kernel(entry: str):
    """The C entry point `tj_probe_<entry>`; all share one signature."""
    fn = getattr(_build.kernel_lib(), f"tj_probe_{entry}")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(entry: str, o: torch.Tensor, meta=None, a=None, b=None,
            arg: int = 0, counted: bool = True) -> torch.Tensor:
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(entry)(*(None if x is None else x.data_ptr()
                               for x in (meta, a, b)), o.data_ptr(), arg,
                             stream)
    if err != 0:
        raise RuntimeError(f"tj_probe_{entry} launch failed: CUDA error {err}")
    _launches.count(LAUNCHES, "construct_probes", counted)
    return o


def form(name: str) -> dict:
    """The form the kernel of a probe in LADDERS runs in, read from the
    build: `ctas` a problem, `cluster` (the cluster's size; 1, none) and,
    for a cluster, `max_active_clusters` (`cudaOccupancyMaxActiveClusters`:
    how many the card holds at once; else 0). Needs the card; raises on a
    CUDA error."""
    if name not in LADDERS:
        raise ValueError(f"{name}: not a probe on the ladders' kernel")
    fn = _build.kernel_lib().tj_probe_form
    fn.argtypes = [ctypes.c_char_p] + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    ctas, cluster, clusters = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = fn(name.encode(), ctypes.byref(ctas), ctypes.byref(cluster),
             ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f"tj_probe_form({name}): CUDA error {err}")
    return {"ctas": ctas.value, "cluster": cluster.value,
            "max_active_clusters": clusters.value}


def _check_meta(meta: torch.Tensor, shape, x: torch.Tensor):
    if (meta.dtype != torch.int32 or tuple(meta.shape) != shape
            or not meta.is_contiguous() or meta.device != x.device):
        raise ValueError(f"meta: expected a contiguous int32 {list(shape)} "
                         f"tensor on {x.device}, got {meta.dtype} "
                         f"{tuple(meta.shape)} on {meta.device}")
    _check_block("x", x, None)
    if x.shape[0] < WROW:
        raise ValueError(f"x: at least {WROW} rows, got {x.shape[0]}")


def min_dma(meta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """meta int32 [2, 2], x int32 [rows, 128] -> zeros [rows, 128] with the
    window of 64 rows from row meta[t, 0] copied, t = 0, 1. A window outside
    x traps the kernel, and the next synchronisation raises."""
    _check_meta(meta, (2, 2), x)
    if not x.is_cuda:
        return min_dma_ref(meta, x)
    return _launch("min_dma", torch.empty_like(x), meta=meta, a=x,
                   arg=x.shape[0])


def min_dma_compute(meta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """meta int32 [7, 2] (the module docstring), x int32 [rows, 128] ->
    zeros [rows, 128] with, per column t, the first 64 rows of key + payload
    of the merged masked windows at its output row."""
    _check_meta(meta, (7, 2), x)
    if not x.is_cuda:
        return min_dma_compute_ref(meta, x)
    return _launch("min_dma_compute", torch.empty_like(x), meta=meta, a=x,
                   arg=x.shape[0])


def _run(entry: str, plain: Callable, in_rows: int, out_rows: int,
         blocks: Sequence[torch.Tensor], arg: int = 0) -> torch.Tensor:
    """A construct over blocks of [in_rows, 128] that gives one block of
    [out_rows, 128]."""
    for name, x in zip("ab", blocks):
        _check_block(name, x, in_rows, like=blocks[0])
    if not blocks[0].is_cuda:
        return plain(*blocks)
    o = blocks[0].new_empty((out_rows, LANES))
    return _launch(entry, o, **dict(zip("ab", blocks)), arg=arg)


def concat_only(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a over b, [64, 128] each."""
    return _run("concat_only", concat_only_ref, WROW, BLOCK_ROWS, (a, b))


def concat_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b [128, 128] -> [256, 128]: per window t of 64 rows, keys a_t over
    b_t and payloads b_t over a_t through the merge ladder at distance
    2^13 .. 1; key + payload."""
    return _run("concat_merge", concat_merge_ref, BLOCK_ROWS, 2 * BLOCK_ROWS,
                (a, b))


def stage(a: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    """One stage at distance d (a power of two up to 2^13) over the keys a
    and payloads b, [128, 128] each; key + payload."""
    if not merge._is_pow2(d) or d > BLOCK // 2:
        raise ValueError(f"d must be a power of two <= {BLOCK // 2}, got {d}")
    return _run("stage", functools.partial(stage_ref, d=d), BLOCK_ROWS,
                BLOCK_ROWS, (a, b), arg=d)


def sublane_ladder(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The stages at distance 2^13 .. 128 (whole rows); key + payload."""
    return _run("sublane_ladder", sublane_ladder_ref, BLOCK_ROWS, BLOCK_ROWS,
                (a, b))


def dirmask_stage(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One stage at distance 128, descending where the lower element's row
    is odd; key + payload."""
    return _run("dirmask_stage", dirmask_stage_ref, BLOCK_ROWS, BLOCK_ROWS,
                (a, b))


def transpose_only(a: torch.Tensor) -> torch.Tensor:
    """a.T.T + 1 for a [128, 128]: a real transpose both ways."""
    return _run("transpose_only", transpose_only_ref, BLOCK_ROWS, BLOCK_ROWS,
                (a,))


def lane_ladder_T(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The stages at distance 64 .. 1, which the TPU ran as row stages on
    the transposed tile; key + payload."""
    return _run("lane_ladder_T", lane_ladder_T_ref, BLOCK_ROWS, BLOCK_ROWS,
                (a, b))


def full_merge_T(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Keys a over b, payloads b over a ([256, 128]) through the merge ladder
    at distance 2^14 .. 1; the keys' first half + the payloads' second
    half."""
    return _run("full_merge_T", full_merge_T_ref, BLOCK_ROWS, BLOCK_ROWS,
                (a, b))


def merge_T_dm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`full_merge_T` with every stage descending where the lower element's
    row is odd."""
    return _run("merge_T_dm", merge_T_dm_ref, BLOCK_ROWS, BLOCK_ROWS, (a, b))


def empty_launch(a: torch.Tensor) -> torch.Tensor:
    """An output block allocated as a construct allocates it and, on the
    card, an empty kernel launched on it through the same launcher: nothing
    is computed and the block is left as allocated. It is no probe and is
    not counted in `LAUNCHES`; its time is the floor under a probe's."""
    _check_block("a", a, BLOCK_ROWS)
    o = a.new_empty((BLOCK_ROWS, LANES))
    return _launch("empty", o, counted=False) if a.is_cuda else o


def launch_floor_ms(device="cuda", seed: int = 0) -> float:
    """`empty_launch` timed by the clock `probe` times a construct's `ms`
    with (`_held`): what of a probe's `ms` is allocation and launch. The
    host's work between the two events is most of it and now and then takes
    several times as long, so this is the best of 25 calls, not of 5."""
    (a,) = _blocks(BLOCK_ROWS, 1, device, seed)
    return best_ms(lambda: empty_launch(a), device, reps=25)


def empty_device_ms(device="cuda") -> Optional[float]:
    """One empty launch's device time (`device_ms`), the floor under every
    probe kernel's; None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    o = torch.empty((BLOCK_ROWS, LANES), dtype=torch.int32, device=device)
    return queued_ms(lambda: _launch("empty", o, counted=False), device,
                     DEVICE_REPS)


def bound_ms(name: str, device="cuda") -> Optional[float]:
    """The least time the card could take for a construct probe: its bytes
    over the memory rate or its exchanges' operations over the integer rate,
    whichever is larger; None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    stages, exchanges = PROBE_EXCHANGES[name]
    by_bytes = 4 * PROBE_ELEMENTS[name] / (timing.detect_hbm_gbps(device) * 1e9)
    by_ops = (stages * exchanges * OPS_PER_EXCHANGE
              / timing.int_ops_per_s(device))
    return max(by_bytes, by_ops) * 1e3


# ---------------------------------------------------------------------------
# the probes: seeded inputs, the construct against its plain version, a time
# ---------------------------------------------------------------------------

def _blocks(rows: int, count: int, device, seed: int) -> List[torch.Tensor]:
    """`count` seeded int32 [rows, 128] blocks: half the elements full range,
    half from [-64, 64), so that equal keys and both signs occur."""
    rng = np.random.RandomState(seed)
    shape = (count, rows, LANES)
    x = np.where(rng.rand(*shape) < 0.5,
                 rng.randint(-64, 64, shape),
                 rng.randint(-2**31, 2**31, shape, dtype=np.int64))
    return list(torch.from_numpy(x.astype(np.int32)).to(device))


def _keys(kind: str, rows: int, count: int, device, seed: int):
    """Blocks whose keys (the first) are `kind`: "random" (`_blocks`),
    "equal" (every key 7) or "extreme" (INT32_MIN, INT32_MAX and their
    neighbours, 0 and -1); the other blocks stay random."""
    blocks = _blocks(rows, count, device, seed)
    if kind == "equal":
        blocks[0] = torch.full_like(blocks[0], 7)
    elif kind == "extreme":
        values = np.array([-2**31, -2**31 + 1, -1, 0, 2**31 - 2, 2**31 - 1],
                          np.int64)
        rng = np.random.RandomState(seed + 1)
        blocks[0] = torch.from_numpy(
            values[rng.randint(0, values.size, (rows, LANES))]
            .astype(np.int32)).to(device)
    elif kind != "random":
        raise ValueError(f"unknown key kind {kind!r}")
    return blocks


def _encoded_runs(n: int, run: int, device, seed: int):
    """Seeded pairs as sorted runs of `run` in the cascade's layout (run r
    ascending by stored = actual ^ -(r & 1)); no key is a masking sentinel."""
    rng = np.random.RandomState(seed)
    sv = torch.from_numpy(rng.randint(-2**31 + 1, 2**31 - 1, n, dtype=np.int64)
                          .astype(np.int32)).to(device)
    pv = torch.from_numpy(rng.randint(-2**31, 2**31, n, dtype=np.int64)
                          .astype(np.int32)).to(device)
    s2, idx = torch.sort(
        sv.view(-1, run) ^ merge._run_parity_mask(n, run, sv.device), dim=1)
    return s2.view(-1), torch.gather(pv.view(-1, run), 1, idx).view(-1)


# The two tiles of min_dma_compute's default table: each an ascending A
# window and a complement-encoded descending B window of one run pair, part
# of each masked off; rows a_row, b_row, a_lo, a_hi, b_wlo, b_whi, out_row.
MERGE_META = [[0, 3 * WROW], [WROW, 2 * WROW], [0, 1000], [WINDOW, 7000],
              [128, 0], [WINDOW, 5000], [0, 2 * WROW]]


class Case(NamedTuple):
    """A construct probe on its inputs: `call` through its wrapper, `plain`
    its plain version, and what `_launch` needs to run its kernel alone on a
    preallocated output (`entry`, `operands`, `out_shape`)."""
    entry: str
    call: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    operands: dict
    out_shape: Tuple[int, int]


# name: (C entry, wrapper, plain, rows of an input block, input blocks, rows
# of the output, the stage's distance for the stage probes)
_BLOCK_PROBES = {
    "transpose_only": ("transpose_only", transpose_only, transpose_only_ref,
                       BLOCK_ROWS, 1, BLOCK_ROWS, 0),
    "merge_T_dm": ("merge_T_dm", merge_T_dm, merge_T_dm_ref, BLOCK_ROWS, 2,
                   BLOCK_ROWS, 0),
    "lane_ladder_T": ("lane_ladder_T", lane_ladder_T, lane_ladder_T_ref,
                      BLOCK_ROWS, 2, BLOCK_ROWS, 0),
    "full_merge_T": ("full_merge_T", full_merge_T, full_merge_T_ref,
                     BLOCK_ROWS, 2, BLOCK_ROWS, 0),
    "concat_only": ("concat_only", concat_only, concat_only_ref, WROW, 2,
                    BLOCK_ROWS, 0),
    **{f"lane_{d}": ("stage", functools.partial(stage, d=d),
                     functools.partial(stage_ref, d=d), BLOCK_ROWS, 2,
                     BLOCK_ROWS, d) for d in (64, 16, 1)},
    "sublane_ladder": ("sublane_ladder", sublane_ladder, sublane_ladder_ref,
                       BLOCK_ROWS, 2, BLOCK_ROWS, 0),
    "dirmask_stage": ("dirmask_stage", dirmask_stage, dirmask_stage_ref,
                      BLOCK_ROWS, 2, BLOCK_ROWS, 0),
    "concat_merge": ("concat_merge", concat_merge, concat_merge_ref,
                     BLOCK_ROWS, 2, 2 * BLOCK_ROWS, 0),
}


def construct_case(name: str, device, seed: int, keys: str = "random",
                   meta=None) -> Case:
    """Construct probe `name` on seeded inputs: keys of `keys` kind
    (`_keys`) for the block probes; for min_dma and min_dma_compute their
    table `meta` (a nested list; default the probe's own)."""
    if name == "min_dma":
        (x,) = _blocks(4 * WROW, 1, device, seed)
        # default: two windows that are not grid-aligned and do not overlap
        meta = torch.tensor(meta or [[8, 0], [136, 0]], dtype=torch.int32,
                            device=device)
        return Case("min_dma", lambda: min_dma(meta, x),
                    lambda: min_dma_ref(meta, x),
                    {"meta": meta, "a": x, "arg": x.shape[0]}, tuple(x.shape))
    if name == "min_dma_compute":
        sv, _ = _encoded_runs(4 * WINDOW, WINDOW, device, seed)
        x = sv.view(4 * WROW, LANES)
        meta = torch.tensor(meta or MERGE_META, dtype=torch.int32,
                            device=device)
        return Case("min_dma_compute", lambda: min_dma_compute(meta, x),
                    lambda: min_dma_compute_ref(meta, x),
                    {"meta": meta, "a": x, "arg": x.shape[0]}, tuple(x.shape))
    entry, wrapper, plain, rows, count, out_rows, d = _BLOCK_PROBES[name]
    blocks = _keys(keys, rows, count, device, seed)
    return Case(entry, lambda: wrapper(*blocks), lambda: plain(*blocks),
                {**dict(zip("ab", blocks)), "arg": d}, (out_rows, LANES))


def case_device_ms(case: Case, device) -> float:
    """A case's kernel alone: `queued_ms` of DEVICE_REPS launches on an
    output allocated once, none of them counted in `LAUNCHES`."""
    o = torch.empty(case.out_shape, dtype=torch.int32, device=device)
    return queued_ms(lambda: _launch(case.entry, o, **case.operands,
                                     counted=False), device, DEVICE_REPS)


def _equal(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return all(g.shape == w.shape and torch.equal(g, w)
               for g, w in zip(got, want))


def _held(fn: Callable, plain: Callable, device) -> dict:
    """fn's result equal to plain's, element for element, and both times."""
    if not _equal(fn(), plain()):
        raise AssertionError("the construct differs from its plain version")
    return {"ms": best_ms(fn, device),
            "plain_ms": best_ms(plain, device, reps=2)}


def _p_construct(name: str):
    def run(device, seed, floor=None, **_):
        case = construct_case(name, device, seed)
        line = _held(case.call, case.plain, device)
        on_card = torch.device(device).type == "cuda"
        return {**line, "device_ms": case_device_ms(case, device)
                if on_card else None, "floor_ms": floor,
                "bound_ms": bound_ms(name, device)}
    return run


def _on_card(fn: Callable, device) -> Optional[float]:
    """fn's kernels alone (`queued_ms`; None on the CPU), their launches
    taken back out of the merge kernels' counts."""
    if torch.device(device).type != "cuda":
        return None
    counts = dict(merge.LAUNCHES), dict(merge.ROUTES)
    ms = queued_ms(fn, device, DEVICE_REPS)
    merge.LAUNCHES.update(counts[0])
    merge.ROUTES.update(counts[1])
    return ms


def _p_levels(n: int, run: int, levels: int, tile: int):
    """The in-block merge kernel at one geometry."""
    def go(device, seed, **_):
        sv, pv = _encoded_runs(n, run, device, seed)
        fn = lambda: merge.merge_levels_vmem(sv, pv, run, levels,
                                             tile_elems=tile)
        line = _held(fn, lambda: merge.merge_levels_vmem_ref(
            sv, pv, run, levels, tile_elems=tile), device)
        return {**line, "device_ms": _on_card(fn, device)}
    return go


def p_vmem_lt_param(device, seed, run=12, levels=1, tile=14, **_):
    run, tile = 1 << run, 1 << tile
    geometry = {"run": run, "levels": levels, "tile": tile}
    try:
        return {**_p_levels(max(tile, run << levels), run, levels, tile)(
            device, seed), **geometry}
    except ValueError as e:   # a geometry the wrapper does not take
        return {"ok": False, "error": " ".join(str(e).split())[:220],
                "expected_to_fit": (run << levels) <= merge.MAX_BLOCK_ELEMS,
                "device_ms": None, **geometry}


def _p_hbm(double_buffer: bool):
    def go(device, seed, **_):
        sv, pv = _encoded_runs(1 << 14, 8192, device, seed)
        fn = lambda: merge.merge_level_hbm(sv, pv, 8192,
                                           double_buffer=double_buffer)
        line = _held(fn, lambda: merge.merge_level_hbm_ref(sv, pv, 8192),
                     device)
        return {**line, "device_ms": _on_card(fn, device)}
    return go


N = 1 << 16   # pairs of the `vmem` probes

# The reference's order and names; `vmem_lt`, which the reference left out of
# its list because it hung the TPU compiler, stands where its note stood.
PROBES = [
    ("transpose_only", _p_construct("transpose_only")),
    ("merge_T_dm", _p_construct("merge_T_dm")),
    ("vmem_lt_1", _p_levels(1 << 14, 4096, 1, 1 << 13)),
    ("vmem_lt_param", p_vmem_lt_param),
    ("lane_ladder_T", _p_construct("lane_ladder_T")),
    ("full_merge_T", _p_construct("full_merge_T")),
    ("concat_only", _p_construct("concat_only")),
    ("lane_64", _p_construct("lane_64")),
    ("lane_16", _p_construct("lane_16")),
    ("lane_1", _p_construct("lane_1")),
    ("sublane_ladder", _p_construct("sublane_ladder")),
    ("dirmask_stage", _p_construct("dirmask_stage")),
    ("concat_merge", _p_construct("concat_merge")),
    ("vmem_one_level", _p_levels(1 << 14, 4096, 1, 1 << 13)),
    ("vmem", _p_levels(N, 4096, 2, N)),
    ("vmem_lt", _p_levels(N, 4096, 2, N)),
    ("min_dma", _p_construct("min_dma")),
    ("min_dma_compute", _p_construct("min_dma_compute")),
    ("hbm", _p_hbm(False)),
    ("hbm_db", _p_hbm(True)),
]
# the probes that launch a kernel of `csrc/construct_probes.cu`
CONSTRUCTS = ("transpose_only", "merge_T_dm", "lane_ladder_T", "full_merge_T",
              "concat_only", "lane_64", "lane_16", "lane_1", "sublane_ladder",
              "dirmask_stage", "concat_merge", "min_dma", "min_dma_compute")


def probe(name: str, fn: Callable, **kw) -> dict:
    """Run one probe, print its line and return it. An exception is reported
    in the line and the ladder goes on."""
    try:
        line = {"probe": name, "ok": True, **fn(**kw)}
    except Exception as e:  # noqa: BLE001: report and continue
        line = {"probe": name, "ok": False, "device_ms": None,
                "error": " ".join(str(e).split())[:220]}
    print(json.dumps(line), flush=True)
    return line


def failed(line: dict) -> bool:
    """A probe failed unless it is ok or reports a geometry that was not
    expected to fit."""
    return not line["ok"] and line.get("expected_to_fit", True)


def run_probes(names: Sequence[str] = (), device="cuda", seed: int = 0,
               **geometry) -> List[dict]:
    """The named probes (all if none is named) in the ladder's order; one
    line each. `geometry` (run, levels, tile) goes to `vmem_lt_param`. A
    construct probe's line carries `floor_ms`, one empty launch's device
    time (None on the CPU)."""
    unknown = set(names) - {name for name, _ in PROBES}
    if unknown:
        raise ValueError(f"unknown probes {sorted(unknown)}")
    floor = empty_device_ms(device)
    return [probe(name, fn, device=device, seed=seed + i, floor=floor,
                  **geometry)
            for i, (name, fn) in enumerate(PROBES)
            if not names or name in names]


# ---------------------------------------------------------------------------
# the kernels alone, and the edges
# ---------------------------------------------------------------------------

def kernel_times(device="cuda", seed: int = 0) -> dict:
    """Each construct kernel's device time alone on its probe's inputs and
    one empty launch's, through `_launch` only, so that the same timer runs
    on any build of the kernels with these entry points."""
    seeds = {name: seed + i for i, (name, _) in enumerate(PROBES)}
    (x,) = _blocks(4 * WROW, 1, device, seed)
    return {"device_ms": {name: case_device_ms(
                construct_case(name, device, seeds[name]), device)
                for name in CONSTRUCTS},
            "empty_ms": empty_device_ms(device),
            # the fill an older min_dma or min_dma_compute wrapper launched
            # before its kernel, which wrote only the windows' rows
            "zeros_like_ms": queued_ms(lambda: torch.zeros_like(x), device,
                                       DEVICE_REPS)}


def edge_cases(device, seed: int = 0) -> List[Tuple[str, str, Case]]:
    """(probe, what, case): min_dma's windows at the first and the last rows,
    overlapping and equal; min_dma_compute with a fully masked and an
    unmasked tile, its windows and output rows at the first and the last
    rows; every block probe on equal keys and on extreme keys."""
    last = 4 * WROW - WROW
    cases = [("min_dma", what, construct_case("min_dma", device, seed,
                                              meta=meta))
             for what, meta in (
                 ("first and last rows", [[0, 0], [last, 0]]),
                 ("overlapping", [[8, 0], [40, 0]]),
                 ("one window twice", [[100, 0], [100, 0]]))]
    masked = [[last, 0], [0, last], [0, 0], [0, WINDOW], [WINDOW, 0],
              [WINDOW, WINDOW], [last, 0]]
    cases.append(("min_dma_compute",
                  "tile 0 fully masked, tile 1 unmasked, first and last rows",
                  construct_case("min_dma_compute", device, seed,
                                 meta=masked)))
    cases += [(name, f"{keys} keys",
               construct_case(name, device, seed, keys=keys))
              for keys in ("equal", "extreme") for name in _BLOCK_PROBES]
    return cases


def hold_edges(device, seed: int = 0) -> List[str]:
    """Every edge case's construct equal to its plain version; raises at the
    first that differs. Returns what was held."""
    held = []
    for name, what, case in edge_cases(device, seed):
        if not _equal(case.call(), case.plain()):
            raise AssertionError(f"{name} ({what}) differs from its plain "
                                 f"version")
        held.append(f"{name}: {what}")
    return held


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("probes", nargs="*", metavar="probe")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--run", type=int, default=12,
                        help="vmem_lt_param: log2 of the run length")
    parser.add_argument("--levels", type=int, default=1)
    parser.add_argument("--tile", type=int, default=14,
                        help="vmem_lt_param: log2 of the tile")
    parser.add_argument("--kernels", action="store_true",
                        help="only each construct kernel's device time")
    args = parser.parse_args(argv)
    if args.kernels:
        if torch.device(args.device).type != "cuda":
            parser.error("--kernels times the card")
        print(json.dumps(kernel_times(args.device)), flush=True)
        return 0
    try:
        lines = run_probes(args.probes, args.device, run=args.run,
                           levels=args.levels, tile=args.tile)
    except ValueError as e:
        parser.error(str(e))
    return 1 if any(failed(line) for line in lines) else 0


if __name__ == "__main__":
    sys.exit(main())
