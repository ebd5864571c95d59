"""A ladder of minimal kernels, each one construct of the merge kernels more
than the last.

Counterpart of `benchmarks/mosaic_bisect.py`; the CUDA kernels are in
`csrc/construct_probes.cu` (`tj_probe_*`). On the TPU the ladder only
compiled: it found the construct that crashed the kernel compiler. `nvcc`
has no such crash to find, so here every probe runs its construct on seeded
random int32 blocks and is held against its plain version; each is the
smallest working example of one construct on this card:

  min_dma          a meta-indexed window of [64, 128] copied from device
                   memory into shared memory with the asynchronous copy
                   (cp.async and a wait) and back out at the same rows;
  min_dma_compute  two such windows, the merge-path masking, their
                   concatenation, a bitonic merge, key + payload out;
  concat_only      the concatenation of two blocks alone;
  concat_merge     concatenation and the merge ladder, two blocks a launch;
  lane_64 / lane_16 / lane_1   one stage at that distance;
  sublane_ladder   the stages at distance 2^13 .. 128;
  dirmask_stage    one stage at distance 128, direction from the row parity;
  transpose_only   `a.T.T + 1` through a padded shared-memory tile;
  lane_ladder_T    the stages at distance 64 .. 1 as row stages on the
                   transposed tile;
  full_merge_T     the merge of two [128, 128] blocks (2^15 pairs: the first
                   stage runs from device memory) with the small stages on
                   the transposed tile;
  merge_T_dm       the same with every stage's direction from the row parity.

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
use) or raises; on CPU tensors it runs the plain version. `LAUNCHES` counts
the probe kernels launched.

Usage: python -m icde2019_gpu_join_tpu_torch.benchmarks.construct_probes
           [probe ...] [--device cpu] [--run 12 --levels 1 --tile 14]
(no names = all probes in order). Prints one JSON line per probe,
`{"probe": name, "ok": true, "ms": ..., "plain_ms": ...}` (the best of 5
calls and of 2 of the plain version), goes on after a failing probe and exits
1 if any failed.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from icde2019_gpu_join_tpu_torch.ops import _build, merge
from icde2019_gpu_join_tpu_torch.utils.timing import best_ms

LANES = 128
WROW = 64                   # rows of a copy window
WINDOW = WROW * LANES       # 8192 elements
BLOCK_ROWS = 2 * WROW       # rows of a full block
BLOCK = BLOCK_ROWS * LANES  # 2^14 elements

# the C entry points `tj_probe_<name>` of csrc/construct_probes.cu
ENTRY_POINTS = ("min_dma", "min_dma_compute", "concat_only", "concat_merge",
                "stage", "sublane_ladder", "dirmask_stage", "transpose_only",
                "lane_ladder_T", "full_merge_T", "merge_T_dm")

# Probe kernels launched since the last reset.
LAUNCHES: Dict[str, int] = {"construct_probes": 0}


def reset_launches():
    LAUNCHES["construct_probes"] = 0


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


@functools.lru_cache(maxsize=None)
def _kernel(entry: str):
    """The C entry point `tj_probe_<entry>`; all share one signature."""
    fn = getattr(_build.kernel_lib(), f"tj_probe_{entry}")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(entry: str, o: torch.Tensor, meta=None, a=None, b=None,
            arg: int = 0) -> torch.Tensor:
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(entry)(*(None if x is None else x.data_ptr()
                               for x in (meta, a, b)), o.data_ptr(), arg,
                             stream)
    if err != 0:
        raise RuntimeError(f"tj_probe_{entry} launch failed: CUDA error {err}")
    LAUNCHES["construct_probes"] += 1
    return o


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
    return _launch("min_dma", torch.zeros_like(x), meta=meta, a=x,
                   arg=x.shape[0])


def min_dma_compute(meta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """meta int32 [7, 2] (the module docstring), x int32 [rows, 128] ->
    zeros [rows, 128] with, per column t, the first 64 rows of key + payload
    of the merged masked windows at its output row."""
    _check_meta(meta, (7, 2), x)
    if not x.is_cuda:
        return min_dma_compute_ref(meta, x)
    return _launch("min_dma_compute", torch.zeros_like(x), meta=meta, a=x,
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
    """a over b, [64, 128] each, through shared memory."""
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
    """The stages at distance 64 .. 1 as row stages on the transposed tile;
    key + payload."""
    return _run("lane_ladder_T", lane_ladder_T_ref, BLOCK_ROWS, BLOCK_ROWS,
                (a, b))


def full_merge_T(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Keys a over b, payloads b over a ([256, 128]) through the merge ladder
    at distance 2^14 .. 1, the stages below 128 on the transposed tile; the
    keys' first half + the payloads' second half."""
    return _run("full_merge_T", full_merge_T_ref, BLOCK_ROWS, BLOCK_ROWS,
                (a, b))


def merge_T_dm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`full_merge_T` with every stage descending where the lower element's
    row is odd."""
    return _run("merge_T_dm", merge_T_dm_ref, BLOCK_ROWS, BLOCK_ROWS, (a, b))


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


def _held(fn: Callable, plain: Callable, device) -> dict:
    """fn's result equal to plain's, element for element, and both times."""
    got, want = fn(), plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if not all(g.shape == w.shape and torch.equal(g, w)
               for g, w in zip(got, want)):
        raise AssertionError("the construct differs from its plain version")
    return {"ms": best_ms(fn, device),
            "plain_ms": best_ms(plain, device, reps=2)}


def _p_construct(fn: Callable, plain: Callable, rows: int, operands: int = 2):
    def run(device, seed, **_):
        blocks = _blocks(rows, operands, device, seed)
        return _held(lambda: fn(*blocks), lambda: plain(*blocks), device)
    return run


def _p_stage(d: int):
    def run(device, seed, **_):
        a, b = _blocks(BLOCK_ROWS, 2, device, seed)
        return _held(lambda: stage(a, b, d), lambda: stage_ref(a, b, d), device)
    return run


def p_min_dma(device, seed, **_):
    (x,) = _blocks(4 * WROW, 1, device, seed)
    # two windows that are not grid-aligned and do not overlap
    meta = torch.tensor([[8, 0], [136, 0]], dtype=torch.int32, device=device)
    return _held(lambda: min_dma(meta, x), lambda: min_dma_ref(meta, x), device)


def p_min_dma_compute(device, seed, **_):
    """Two tiles, each with an ascending A window and a complement-encoded
    descending B window of one run pair, part of each masked off."""
    sv, _ = _encoded_runs(4 * WINDOW, WINDOW, device, seed)
    x = sv.view(4 * WROW, LANES)
    meta = torch.tensor([[0, 3 * WROW],        # A window's first row
                         [WROW, 2 * WROW],     # B window's first row
                         [0, 1000], [WINDOW, 7000],     # a_lo, a_hi
                         [128, 0], [WINDOW, 5000],      # b_wlo, b_whi
                         [0, 2 * WROW]],       # output row
                        dtype=torch.int32, device=device)
    return _held(lambda: min_dma_compute(meta, x),
                 lambda: min_dma_compute_ref(meta, x), device)


def _p_levels(n: int, run: int, levels: int, tile: int):
    """The in-block merge kernel at one geometry."""
    def go(device, seed, **_):
        sv, pv = _encoded_runs(n, run, device, seed)
        return _held(
            lambda: merge.merge_levels_vmem(sv, pv, run, levels, tile_elems=tile),
            lambda: merge.merge_levels_vmem_ref(sv, pv, run, levels,
                                                tile_elems=tile), device)
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
                **geometry}


def _p_hbm(double_buffer: bool):
    def go(device, seed, **_):
        sv, pv = _encoded_runs(1 << 14, 8192, device, seed)
        return _held(
            lambda: merge.merge_level_hbm(sv, pv, 8192,
                                          double_buffer=double_buffer),
            lambda: merge.merge_level_hbm_ref(sv, pv, 8192), device)
    return go


N = 1 << 16   # pairs of the `vmem` probes

# The reference's order and names; `vmem_lt`, which the reference left out of
# its list because it hung the TPU compiler, stands where its note stood.
PROBES = [
    ("transpose_only", _p_construct(transpose_only, transpose_only_ref,
                                    BLOCK_ROWS, 1)),
    ("merge_T_dm", _p_construct(merge_T_dm, merge_T_dm_ref, BLOCK_ROWS)),
    ("vmem_lt_1", _p_levels(1 << 14, 4096, 1, 1 << 13)),
    ("vmem_lt_param", p_vmem_lt_param),
    ("lane_ladder_T", _p_construct(lane_ladder_T, lane_ladder_T_ref,
                                   BLOCK_ROWS)),
    ("full_merge_T", _p_construct(full_merge_T, full_merge_T_ref, BLOCK_ROWS)),
    ("concat_only", _p_construct(concat_only, concat_only_ref, WROW)),
    ("lane_64", _p_stage(64)),
    ("lane_16", _p_stage(16)),
    ("lane_1", _p_stage(1)),
    ("sublane_ladder", _p_construct(sublane_ladder, sublane_ladder_ref,
                                    BLOCK_ROWS)),
    ("dirmask_stage", _p_construct(dirmask_stage, dirmask_stage_ref,
                                   BLOCK_ROWS)),
    ("concat_merge", _p_construct(concat_merge, concat_merge_ref, BLOCK_ROWS)),
    ("vmem_one_level", _p_levels(1 << 14, 4096, 1, 1 << 13)),
    ("vmem", _p_levels(N, 4096, 2, N)),
    ("vmem_lt", _p_levels(N, 4096, 2, N)),
    ("min_dma", p_min_dma),
    ("min_dma_compute", p_min_dma_compute),
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
        line = {"probe": name, "ok": False,
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
    line each. `geometry` (run, levels, tile) goes to `vmem_lt_param`."""
    unknown = set(names) - {name for name, _ in PROBES}
    if unknown:
        raise ValueError(f"unknown probes {sorted(unknown)}")
    return [probe(name, fn, device=device, seed=seed + i, **geometry)
            for i, (name, fn) in enumerate(PROBES)
            if not names or name in names]


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("probes", nargs="*", metavar="probe")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--run", type=int, default=12,
                        help="vmem_lt_param: log2 of the run length")
    parser.add_argument("--levels", type=int, default=1)
    parser.add_argument("--tile", type=int, default=14,
                        help="vmem_lt_param: log2 of the tile")
    args = parser.parse_args(argv)
    try:
        lines = run_probes(args.probes, args.device, run=args.run,
                           levels=args.levels, tile=args.tile)
    except ValueError as e:
        parser.error(str(e))
    return 1 if any(failed(line) for line in lines) else 0


if __name__ == "__main__":
    sys.exit(main())
