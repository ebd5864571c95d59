"""Merge-tree sort of (sortval, payload) pairs, and the packed one-operand
sort: the engine's sort alternates (`sort_impl="merge"` / `"packed"`).

Counterpart of `icde2019_gpu_join_tpu/ops/merge_pallas.py`; its three CUDA
kernels are in `csrc/merge.cu`. The cascade:

  1. base runs:  `encode_base_runs`, one segmented `torch.sort` into runs of
                 BASE_RUN (no hand kernel: the reference leaves this sort to
                 its compiler's library sort too);
  2. `merge_levels_vmem` (kernel `tj_merge_levels`): each thread block holds
     one output run in shared memory and merges `levels` levels there;
  3. `merge_level_hbm`: runs too long for a block merge by merge-path
     planning, two launches a level on the card with no host work between
     them. `merge_level_plan` (kernel `tj_merge_level_plan`, a thread an
     output tile) finds the exact diagonal split of every tile and writes
     the plan table; `merge_tiles` (kernel `tj_merge_level_hbm`) loads the
     two 128-aligned windows, masks the rows off the diagonal to -inf / +inf
     sentinels, runs one bitonic merge of 2 * window elements in registers
     and writes the valid rows. `merge_level_meta` (a vectorised binary
     search in torch) is the planner's plain version.

DIRECTION ENCODING (kept from the reference, so that every level can be held
against it element for element): run r of the cascade is stored sorted
ascending by `stored = actual ^ -(r & 1)`; an odd run holds complemented
keys, which makes its actual keys descending in position, the second half of
a bitonic sequence, without reversing anything. The base-run sort produces
the layout, kernel 6 decodes on load and re-encodes on store, and the
merge-path planner reads the descending side through `~` and swaps the two
physical runs by pair parity, so kernel 7 needs no direction at all. The last
level's single output run has index 0: plain ascending keys.

The compare-exchange is `swap = (hi < lo) ^ direction`: strict `<`, so equal
keys stay where they are in an ascending run and do swap in a descending
one. That fixes where the payloads of equal keys land; the plain versions
and the kernels keep it bit for bit.

Sentinels: window masking uses INT32_MIN / INT32_MAX as -inf / +inf, and a
real key equal to one could tie with junk and trade payloads with it. So
`merge_sort_pairs` falls back to `torch.sort` when any sortval equals a
sentinel (one host read), as the reference falls back to its library sort.
The engine sorts sign-flipped keys: key 0 becomes INT32_MIN and the pad key
-1 INT32_MAX, so a relation that holds key 0 or needs padding takes the
fallback. `ROUTES` counts which way each call went.

On CUDA tensors `merge_levels_vmem`, `merge_level_plan` and `merge_tiles`
(the two steps of `merge_level_hbm`) launch their kernels (built with nvcc
at first use) or raise; on CPU tensors they run the plain versions (`*_ref`,
`merge_level_meta`). `LAUNCHES` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from icde2019_gpu_join_tpu_torch.ops import _build
from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32

INT_MIN = -0x80000000
INT_MAX = 0x7FFFFFFF

BASE_RUN = 4096             # run length of the segmented base sort
DEVICE_VMEM_TILE = 1 << 14  # longest run kernel 6 builds; kernel 7 above it
HBM_WINDOW = 8192           # per-side window of the merge-path kernel
HBM_TILE_OUT = HBM_WINDOW - 128   # valid output rows of a full tile
# The reference's bound, from the scalar memory its TPU kernel's meta table
# must fit, not a limit of this card. Kept, with the rule in
# `merge_sort_pairs`, so that what the card routes to `torch.sort` is what
# the TPU routes to its library sort.
CASCADE_MAX_N = 1 << 27

# Elements (key, payload pairs) one thread block can hold: 2^14 pairs are
# 128 KB of the 227 KB of shared memory a block may use; 2^15 do not fit.
MAX_BLOCK_ELEMS = 1 << 14

# Kernel launches since the last reset, by kernel; only the CUDA path adds.
LAUNCHES: Dict[str, int] = {"merge_levels_vmem": 0, "merge_level_plan": 0,
                            "merge_level_hbm": 0}
# Calls of `merge_sort_pairs` since the last reset, by the way they went.
ROUTES: Dict[str, int] = {"cascade": 0, "fallback": 0}

# The plain version of the merge-path level walks the tiles in batches whose
# [tiles, 2 * window] arrays hold at most this many elements.
_REF_ELEMS = 1 << 24


def reset_launches():
    """Zero the launch counts and the route counts."""
    for counts in (LAUNCHES, ROUTES):
        for name in counts:
            counts[name] = 0


def _is_pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


def _check_pairs(sv: torch.Tensor, pv: torch.Tensor):
    for name, x in (("sv", sv), ("pv", pv)):
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous 1-D int32 "
                             f"tensor, got {x.dtype} {tuple(x.shape)}")
    if sv.shape != pv.shape or sv.device != pv.device:
        raise ValueError(f"sv {tuple(sv.shape)} on {sv.device} and pv "
                         f"{tuple(pv.shape)} on {pv.device} differ")
    if sv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {sv.device}")


def _check_aligned(*named: Tuple[str, torch.Tensor]):
    """The kernels that load 16-byte vectors need their arrays to start on a
    16-byte boundary."""
    for name, x in named:
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel loads 16-byte vectors and "
                             f"needs a tensor that starts on a 16-byte "
                             f"boundary, got an offset of {x.data_ptr() % 16} "
                             f"bytes (a view that starts at row "
                             f"{x.storage_offset()} of its storage); pass a "
                             f"whole tensor or a .clone()")


# ---------------------------------------------------------------------------
# stage arithmetic of the plain versions (flat int32 arrays)
# ---------------------------------------------------------------------------

def _cx(sv: torch.Tensor, pv: torch.Tensor, d: int, out_run: int = 0,
        flip: Optional[torch.Tensor] = None):
    """One compare-exchange stage at distance d over flat arrays: in every
    2d-aligned group the smaller key lands in the low half. With out_run,
    the direction flips in the odd runs of that length, counted from the
    arrays' first element (2d <= out_run, so a group lies in one run). With
    flip (bool, broadcastable to [groups, d]), it flips per exchange."""
    a = sv.view(-1, 2, d)
    p = pv.view(-1, 2, d)
    lo, hi = a[:, 0], a[:, 1]
    swap = hi < lo
    if out_run:
        group = torch.arange(a.shape[0], device=sv.device)
        swap ^= (((group * (2 * d)) // out_run) & 1).bool()[:, None]
    if flip is not None:
        swap ^= flip
    nsv = torch.stack([torch.where(swap, hi, lo), torch.where(swap, lo, hi)], 1)
    plo, phi = p[:, 0], p[:, 1]
    npv = torch.stack([torch.where(swap, phi, plo), torch.where(swap, plo, phi)], 1)
    return nsv.view(-1), npv.view(-1)


def _bitonic_merge_pairs(sv: torch.Tensor, pv: torch.Tensor, run_len: int,
                         directed: bool = False):
    """Merge every adjacent (ascending, descending) pair of run_len-runs of
    the flat arrays into sorted runs of 2 * run_len: the stages at distances
    run_len .. 1, all in one direction (no mirror stage), or, if directed,
    descending in the odd output runs."""
    d = run_len
    while d >= 1:
        sv, pv = _cx(sv, pv, d, 2 * run_len if directed else 0)
        d //= 2
    return sv, pv


def _run_parity_mask(n: int, run_len: int, device) -> torch.Tensor:
    """[n / run_len, 1] int32: -1 for odd runs, 0 for even ones."""
    return -(torch.arange(n // run_len, dtype=torch.int32, device=device)
             & 1)[:, None]


# ---------------------------------------------------------------------------
# kernel 6: `levels` merge levels inside one thread block
# ---------------------------------------------------------------------------

def _check_levels(sv, pv, run_len: int, levels: int, tile_elems: int) -> int:
    """The reference's contract; returns the output run length."""
    _check_pairs(sv, pv)
    n = sv.shape[0]
    span = run_len << levels
    tile = min(tile_elems, n)
    if not (_is_pow2(run_len) and run_len >= 128 and levels >= 1
            and _is_pow2(tile)):
        raise ValueError(f"run_len (>= 128) and tile_elems must be powers of "
                         f"two and levels >= 1: {run_len}, {tile_elems}, "
                         f"{levels}")
    if tile < span or n % tile:
        raise ValueError(f"need min(tile_elems, n) >= run_len << levels and "
                         f"n a multiple of it: n={n}, tile={tile}, span={span}")
    return span


def merge_levels_vmem_ref(sv: torch.Tensor, pv: torch.Tensor, run_len: int,
                          levels: int, tile_elems: int = DEVICE_VMEM_TILE
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `merge_levels_vmem`: every stage over the
    whole arrays at once."""
    span = _check_levels(sv, pv, run_len, levels, tile_elems)
    n = sv.shape[0]
    # stored -> actual keys: odd input runs are complement-encoded
    sv = (sv.view(-1, run_len) ^ _run_parity_mask(n, run_len, sv.device)).view(-1)
    length = run_len
    for _ in range(levels):
        sv, pv = _bitonic_merge_pairs(sv, pv, length, directed=True)
        length *= 2
    # actual -> stored: re-encode the odd output runs
    sv = (sv.view(-1, span) ^ _run_parity_mask(n, span, sv.device)).view(-1)
    return sv, pv


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    """The C entry point `tj_<name>`, bound with its argument types."""
    fn = getattr(_build.kernel_lib(), f"tj_{name}")
    pointers, sizes = {"merge_levels": (4, 3), "merge_level_plan": (2, 4),
                       "merge_level_hbm": (5, 3)}[name]
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int64] * sizes
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, counter: str, tensors, *sizes: int):
    with torch.cuda.device(tensors[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(name)(*(x.data_ptr() for x in tensors), *sizes, stream)
    if err != 0:
        raise RuntimeError(f"tj_{name} launch failed: CUDA error {err}")
    LAUNCHES[counter] += 1


def merge_levels_vmem(sv: torch.Tensor, pv: torch.Tensor, run_len: int,
                      levels: int, tile_elems: int = DEVICE_VMEM_TILE
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge complement-encoded alternating runs of run_len into runs of
    run_len << levels (same encoding): run r is sorted ascending by its
    stored value, stored = actual ^ -(r & 1).

    `tile_elems` is the reference's grid tile (n a multiple of
    min(tile_elems, n), which must hold an output run). The result does not
    depend on it: every compared pair lies inside one output run and the
    parities come from the global row. On the card a thread block takes one
    output run, so run_len << levels may be at most MAX_BLOCK_ELEMS there;
    the plain version takes any size."""
    span = _check_levels(sv, pv, run_len, levels, tile_elems)
    if not sv.is_cuda:
        return merge_levels_vmem_ref(sv, pv, run_len, levels, tile_elems)
    if span > MAX_BLOCK_ELEMS:
        raise ValueError(f"an output run of {span} pairs does not fit a "
                         f"thread block's shared memory (at most "
                         f"{MAX_BLOCK_ELEMS}); use merge_level_hbm")
    osv, opv = torch.empty_like(sv), torch.empty_like(pv)
    _launch("merge_levels", "merge_levels_vmem", (sv, pv, osv, opv),
            sv.shape[0], run_len, levels)
    return osv, opv


# ---------------------------------------------------------------------------
# kernel 7: one merge-path level
# ---------------------------------------------------------------------------

def _merge_path_splits(sv: torch.Tensor, run_len: int, tile_out: int):
    """For every output tile boundary, the exact diagonal split (a, b) with
    a + b = o over the working domain of each pair: a vectorised binary
    search, about log2(run_len) gather rounds over all tiles at once.

    Encoding algebra: pair p merges runs 2p and 2p+1. Define the working
    domain w = actual ^ -(p & 1). In it exactly one physical run ascends in
    position (the A side: run 2p for even p, run 2p+1 for odd p) and its
    stored values equal its working values; the other run (B) descends and
    its stored values are the complement of its working values, for both
    parities. The output run (index p at the next level) must be stored as
    working values. So the planner reads A as sv[.] and B as ~sv[.], swaps
    the physical bases by parity, and the kernel is parity-free.

    Returns int32 tensors [ntiles]: a, b (the split at the tile's start,
    local to the run pair, in ascending-view coordinates), the pair index
    p, the output offset o, and the physical A / B base offsets."""
    n = sv.shape[0]
    pair = 2 * run_len
    npairs = n // pair
    tiles_per_pair = -(-pair // tile_out)
    t = torch.arange(npairs * tiles_per_pair, device=sv.device)
    p = t // tiles_per_pair
    j = t % tiles_per_pair
    # ragged tail: the last tile of each pair re-covers rows, so that every
    # tile ends tile_out rows after its start
    o = torch.clamp(j * tile_out, max=pair - tile_out)
    par = p & 1
    abase = p * pair + par * run_len        # working-ascending physical run
    bbase = p * pair + (1 - par) * run_len  # working-descending physical run
    lo = torch.clamp(o - run_len, min=0)
    hi = torch.clamp(o, max=run_len)
    # invariant: the split lies in [lo, hi]; A[a-1] <= Bv[o-a] in
    # ascending-view coordinates, where A[i] = sv[abase+i] and the ascending
    # view of B is Bv[i] = ~sv[bbase + run_len-1-i] (B descends physically)
    iters = max(1, math.ceil(math.log2(run_len + 1)) + 1)
    for _ in range(iters):
        mid = (lo + hi + 1) >> 1   # upper-bound search: the largest a
        a_prev = torch.where(
            mid >= 1, sv[torch.clamp(abase + mid - 1, 0, n - 1)], INT_MIN)
        bj = o - mid
        b_at = torch.where(
            bj < run_len,
            ~sv[torch.clamp(bbase + run_len - 1 - bj, 0, n - 1)], INT_MAX)
        ok = a_prev <= b_at        # A[mid-1] <= Bv[o-mid]: a can be >= mid
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid - 1)
    a = lo
    return tuple(x.to(torch.int32) for x in (a, o - a, p, o, abase, bbase))


def _check_level(sv, pv, run_len: int, window: int):
    _check_pairs(sv, pv)
    if not (_is_pow2(run_len) and _is_pow2(window) and window >= 256):
        raise ValueError(f"run_len and window (>= 256) must be powers of "
                         f"two: {run_len}, {window}")
    if run_len < window or sv.shape[0] == 0 or sv.shape[0] % (2 * run_len):
        raise ValueError(f"need run_len >= window and n a positive multiple "
                         f"of 2 * run_len: n={sv.shape[0]}, run_len={run_len}, "
                         f"window={window}")


def merge_level_meta(sv: torch.Tensor, run_len: int,
                     window: int = HBM_WINDOW) -> torch.Tensor:
    """The merge-path plan of one level, int32 [7, ntiles], one column per
    output tile (the reference's scalar-prefetch table, same layout):

      0  A window's first row (of 128), physical
      1  B window's first row, physical (B is addressed in ascending-view
         coordinates [b0, b0 + window): the physical span
         [run_len - b0 - window, run_len - b0) of the descending run)
      2  a_lo, 3  a_hi: the tile's rows within the A window
      4  b_wlo, 5  b_whi: the tile's rows within the B window (descending
         coordinates)
      6  the tile's first output row (of 128)

    Windows start on 128-row boundaries and are clamped into their runs."""
    n = sv.shape[0]
    tile_out = window - 128
    a, b, p, o, abase, bbase = _merge_path_splits(sv, run_len, tile_out)
    pair = 2 * run_len
    a0 = torch.clamp(a & ~127, max=run_len - window)
    b0 = torch.clamp(b & ~127, max=run_len - window)
    # exact ends: the split at the next tile's start within the same pair;
    # the last tile of a pair ends where the runs end
    tiles_per_pair = a.shape[0] // (n // pair)
    ends = a.new_full((n // pair, 1), run_len)
    a_hi = torch.cat([a.view(-1, tiles_per_pair)[:, 1:], ends], 1).view(-1)
    b_hi = torch.cat([b.view(-1, tiles_per_pair)[:, 1:], ends], 1).view(-1)
    return torch.stack([
        (abase + a0) // 128,
        (bbase + run_len - b0 - window) // 128,
        a - a0,
        a_hi - a0,
        window - (b_hi - b0),
        window - (b - b0),
        (p * pair + o) // 128,
    ])


def level_tiles(n: int, run_len: int, window: int = HBM_WINDOW) -> int:
    """Output tiles of one merge-path level: the plan's columns."""
    pair = 2 * run_len
    return n // pair * -(-pair // (window - 128))


def merge_level_plan(sv: torch.Tensor, run_len: int,
                     window: int = HBM_WINDOW) -> torch.Tensor:
    """The merge-path plan of one level, the table of `merge_level_meta`.
    On the card one launch of `tj_merge_level_plan` (a thread an output
    tile, all searches side by side, nothing read back by the host); on CPU
    tensors `merge_level_meta`, its plain version."""
    _check_level(sv, sv, run_len, window)
    if not sv.is_cuda:
        return merge_level_meta(sv, run_len, window)
    ntiles = level_tiles(sv.shape[0], run_len, window)
    meta = torch.empty((7, ntiles), dtype=torch.int32, device=sv.device)
    _launch("merge_level_plan", "merge_level_plan", (sv, meta), sv.shape[0],
            run_len, window, ntiles)
    return meta


def _check_tiles(sv, pv, meta: torch.Tensor, window: int):
    _check_pairs(sv, pv)
    if (meta.dtype != torch.int32 or meta.dim() != 2 or meta.shape[0] != 7
            or not meta.is_contiguous() or meta.device != sv.device):
        raise ValueError(f"meta: expected a contiguous int32 [7, ntiles] "
                         f"tensor on {sv.device}, got {meta.dtype} "
                         f"{tuple(meta.shape)} on {meta.device}")
    if not _is_pow2(window) or window < 256 or sv.shape[0] < 2 * window:
        raise ValueError(f"window must be a power of two >= 256 and n >= "
                         f"2 * window: {window}, n={sv.shape[0]}")


def merge_tiles_ref(sv: torch.Tensor, pv: torch.Tensor, meta: torch.Tensor,
                    window: int = HBM_WINDOW
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `merge_tiles`, in the reference's order of
    writes: every tile writes window - 128 rows from the end of its merged
    -inf front, junk included, and each pair's last tile, which re-covers
    the +inf tail of the tile before it, writes after all the others (tiles
    that are not the last of their pair never overlap)."""
    _check_tiles(sv, pv, meta, window)
    dev = sv.device
    tile_out = window - 128
    ntiles = meta.shape[1]
    osv, opv = torch.empty_like(sv), torch.empty_like(pv)
    m = meta.long()
    # a re-covering tile starts less than tile_out rows after the one before
    out0 = m[6] * 128
    late = torch.zeros(ntiles, dtype=torch.bool, device=dev)
    late[1:] = out0[1:] - out0[:-1] < tile_out
    widx = torch.arange(window, device=dev)
    oidx = torch.arange(tile_out, device=dev)
    step = max(1, _REF_ELEMS // (2 * window))
    for order in (~late, late):
        tiles = torch.nonzero(order).view(-1)
        for i in range(0, tiles.shape[0], step):
            c = m[:, tiles[i:i + step]]
            ia = (c[0] * 128)[:, None] + widx
            ib = (c[1] * 128)[:, None] + widx
            # A ascends (stored == working); B is complement-encoded and
            # descends in working values: junk before its valid rows is
            # larger (+inf), junk after them smaller (-inf), which keeps
            # [A | B] bitonic
            ka = torch.where(widx < c[2][:, None], INT_MIN, sv[ia])
            ka = torch.where(widx >= c[3][:, None], INT_MAX, ka)
            kb = torch.where(widx < c[4][:, None], INT_MAX, ~sv[ib])
            kb = torch.where(widx >= c[5][:, None], INT_MIN, kb)
            k = torch.cat([ka, kb], 1).view(-1)
            q = torch.cat([pv[ia], pv[ib]], 1).view(-1)
            k, q = _bitonic_merge_pairs(k, q, window)
            # valid rows start after the merged -inf front
            front = c[2] + window - c[5]
            src = (torch.arange(c.shape[1], device=dev) * (2 * window)
                   + front)[:, None] + oidx
            dst = (c[6] * 128)[:, None] + oidx
            osv[dst.view(-1)] = k[src.view(-1)]
            opv[dst.view(-1)] = q[src.view(-1)]
    return osv, opv


def merge_tiles(sv: torch.Tensor, pv: torch.Tensor, meta: torch.Tensor,
                window: int = HBM_WINDOW
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel step of one merge-path level: for every column of `meta`
    (`merge_level_plan` or `merge_level_meta`) merge the two masked windows
    and write the tile's rows of the output runs. On the card a block holds
    both windows in registers with a shared-memory exchange buffer of their
    size, so `window` may be at most MAX_BLOCK_ELEMS / 2 there; the plain
    version takes any size. The tiles of a plan cover every output row, so
    the outputs are allocated empty; a column that points outside the arrays
    traps the kernel, and the next synchronisation raises. The kernel reads
    16 bytes a load, so on the card `sv` and `pv` must start on a 16-byte
    boundary (a whole tensor does; a view that starts at an odd row may
    not)."""
    _check_tiles(sv, pv, meta, window)
    if not sv.is_cuda:
        return merge_tiles_ref(sv, pv, meta, window)
    if 2 * window > MAX_BLOCK_ELEMS:
        raise ValueError(f"two windows of {window} pairs do not fit a thread "
                         f"block (at most {MAX_BLOCK_ELEMS // 2} each)")
    _check_aligned(("sv", sv), ("pv", pv))
    osv, opv = torch.empty_like(sv), torch.empty_like(pv)
    _launch("merge_level_hbm", "merge_level_hbm", (meta, sv, pv, osv, opv),
            sv.shape[0], meta.shape[1], window)
    return osv, opv


def merge_level_hbm_ref(sv: torch.Tensor, pv: torch.Tensor, run_len: int,
                        window: int = HBM_WINDOW
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `merge_level_hbm`."""
    _check_level(sv, pv, run_len, window)
    return merge_tiles_ref(sv, pv, merge_level_meta(sv, run_len, window),
                           window)


def merge_level_hbm(sv: torch.Tensor, pv: torch.Tensor, run_len: int,
                    window: int = HBM_WINDOW, double_buffer: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cascade level for runs too long to merge inside a block:
    complement-encoded alternating runs of run_len -> runs of 2 * run_len
    (same encoding; the output run's index is the pair's). run_len >= window,
    n a multiple of 2 * run_len.

    `double_buffer` chose, on the TPU, a kernel body that overlapped one
    grid step's copies with the next one's merge; both bodies computed the
    same arrays. Thread blocks run side by side, so one kernel is the
    counterpart of both, and the argument changes nothing here.

    On the card a level is two launches, the plan and the merge, and the
    host reads nothing between them."""
    del double_buffer
    _check_level(sv, pv, run_len, window)
    return merge_tiles(sv, pv, merge_level_plan(sv, run_len, window), window)


# ---------------------------------------------------------------------------
# the cascade and the sorts
# ---------------------------------------------------------------------------

def encode_base_runs(sv: torch.Tensor, pv: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort BASE_RUN segments into the complement-encoded alternating
    layout: odd runs' keys are complemented before the sort, so the sort
    itself produces the descending-by-actual-key layout."""
    n = sv.shape[0]
    sv2, idx = torch.sort(
        sv.view(-1, BASE_RUN) ^ _run_parity_mask(n, BASE_RUN, sv.device), dim=1)
    return sv2.view(-1), torch.gather(pv.view(-1, BASE_RUN), 1, idx).view(-1)


def _merge_sort_cascade(sv: torch.Tensor, pv: torch.Tensor,
                        vmem_tile: int = DEVICE_VMEM_TILE,
                        vmem_levels_per_call: int = 2,
                        hbm_window: int = HBM_WINDOW,
                        lane_transpose: bool = True,
                        hbm_double_buffer: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Base runs, then in-block levels (`vmem_levels_per_call` a launch) up
    to runs of `vmem_tile`, then merge-path levels with windows of
    `hbm_window`. n must be a power of two >= 2 * BASE_RUN. The last level's
    single output run has an even index, so the result is plain ascending
    keys. Each level's inputs are freed as the next is made.

    The result does not depend on the geometry; what fits a thread block
    does. On the card a geometry whose output run or window pair passes
    MAX_BLOCK_ELEMS raises the `ValueError` of `merge_levels_vmem` /
    `merge_tiles`; no other geometry is picked in its place.

    `lane_transpose` and `hbm_double_buffer` chose, on the TPU, between
    formulations of one kernel body that compute the same arrays (the small
    stages on a transposed tile; one grid step's copies overlapped with the
    next one's merge). One kernel stands for each pair here, so the two
    arguments select nothing."""
    del lane_transpose, hbm_double_buffer
    n = sv.shape[0]
    sv, pv = encode_base_runs(sv, pv)
    run = BASE_RUN
    tile = min(vmem_tile, n)
    while run < tile:
        levels = min(vmem_levels_per_call,
                     int(math.log2(tile)) - int(math.log2(run)))
        sv, pv = merge_levels_vmem(sv, pv, run, levels, tile_elems=tile)
        run <<= levels
    while run < n:
        sv, pv = merge_level_hbm(sv, pv, run, window=hbm_window)
        run <<= 1
    return sv, pv


def packed_sort_pairs(sv: torch.Tensor, pv: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-operand alternative: sort (sortval << 32 | payload) packed into
    one word, then unpack. The reference packs a biased sortval into a
    uint64; torch sorts no uint64, and the signed int64 with the signed
    sortval on top and the payload as uint32 below has the same order. The
    payloads of equal keys come out ascending as uint32."""
    w, _ = torch.sort((sv.long() << 32) | (pv.long() & 0xFFFFFFFF))
    return (w >> 32).to(torch.int32), wrap_i32(w)


def torch_sort_pairs(sv: torch.Tensor, pv: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The library sort (`sort_impl="lax"`): `torch.sort` of the keys and a
    gather of the payloads."""
    sv_s, idx = torch.sort(sv)
    return sv_s, pv[idx]


def merge_sort_pairs(sv: torch.Tensor, pv: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort (sv, pv) by sv ascending (signed int32), unstable: a drop-in for
    the two-operand `torch.sort` + gather. Falls back to that when n is not
    a power of two of at least 2 * BASE_RUN, when n > CASCADE_MAX_N on the
    card (see the constant), or when any sortval equals a masking sentinel
    (one host read; the reference: `lax.cond`). `ROUTES` counts both ways."""
    _check_pairs(sv, pv)
    n = sv.shape[0]
    if (n < 2 * BASE_RUN or not _is_pow2(n)
            or (n > CASCADE_MAX_N and sv.is_cuda)
            or bool(((sv == INT_MIN) | (sv == INT_MAX)).any())):
        ROUTES["fallback"] += 1
        return torch_sort_pairs(sv, pv)
    ROUTES["cascade"] += 1
    return _merge_sort_cascade(sv, pv)
