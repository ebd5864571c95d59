"""Full bitonic sort of every tile of (sortval, payload) pairs.

Counterpart of `benchmarks/experimental_sort_pallas.py` (`sort_tiles`); its
CUDA kernel is `csrc/sort_tiles.cu` (`tj_sort_tiles`). Experimental: it is
not on any path of the engine. It is the instrument for the question whether
a sort written by hand can beat `torch.sort` along a tile; `chip_smoke.py`
times both.

The network is the classic one over the flat index within a tile: for
k = 1 .. log2(tile), stages at distance 2^(k-1) .. 1, and a group ascends
iff bit k of its elements' index is 0, so the last merge ascends in every
tile.

KNOWN DEFECT, kept from the reference (experimental_sort_pallas.py:70-75):
the exchange is element-wise, not a swap. Each element takes its partner's
key and payload iff (partner_key < own_key) == keep_small. On distinct keys
that is an ordinary swap. On equal keys the element that keeps the small key
keeps its payload and the one that keeps the large key takes its partner's,
so one payload is written twice and the other is lost: the keys come out
sorted and every payload is one of a row with that key, but the payloads are
no longer a permutation of the input's. The kernel and the plain version do
exactly that, so that both equal the reference on every input. The merge
kernels' exchange (`ops/merge.py`, `_cx`) swaps a pair as one and does not
have this.

On CUDA tensors `sort_tiles` launches its kernel (built with nvcc at first
use) or raises; on CPU tensors it runs the plain version. `LAUNCHES` counts
the calls that launched.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from icde2019_gpu_join_tpu_torch.ops import _build
from icde2019_gpu_join_tpu_torch.ops.merge import _check_pairs, _is_pow2

DEFAULT_TILE = 1 << 20
MIN_TILE = 1024

# Calls of `sort_tiles` that launched the kernel since the last reset.
LAUNCHES: Dict[str, int] = {"sort_tiles": 0}


def reset_launches():
    LAUNCHES["sort_tiles"] = 0


def _check(sv: torch.Tensor, pay: torch.Tensor, tile_elems: int):
    """The reference's contract (its assertion, and its docstring's lower
    bound on the tile)."""
    _check_pairs(sv, pay)
    if not _is_pow2(tile_elems) or tile_elems < MIN_TILE:
        raise ValueError(f"tile_elems must be a power of two >= {MIN_TILE}, "
                         f"got {tile_elems}")
    if sv.shape[0] == 0 or sv.shape[0] % tile_elems:
        raise ValueError(f"n must be a positive multiple of tile_elems: "
                         f"n={sv.shape[0]}, tile_elems={tile_elems}")


def _stage(sv: torch.Tensor, pay: torch.Tensor, j: int, k: int,
           tile_elems: int):
    """One stage at distance 2^j of merge k over the flat arrays, with the
    reference's element-wise exchange."""
    d = 1 << j
    a = sv.view(-1, 2, d)
    p = pay.view(-1, 2, d)
    lo, hi = a[:, 0], a[:, 1]
    plo, phi = p[:, 0], p[:, 1]
    # bit k of the group's first index within its tile; k > j, so it is the
    # bit of every element of the group
    first = torch.arange(a.shape[0], device=sv.device) * (2 * d)
    ascending = ((((first & (tile_elems - 1)) >> k) & 1) == 0)[:, None]
    take_lo = (hi < lo) == ascending      # the lower element keeps small
    take_hi = (lo < hi) != ascending      # the upper element keeps large
    nsv = torch.stack([torch.where(take_lo, hi, lo),
                       torch.where(take_hi, lo, hi)], 1)
    npay = torch.stack([torch.where(take_lo, phi, plo),
                        torch.where(take_hi, plo, phi)], 1)
    return nsv.view(-1), npay.view(-1)


def sort_tiles_ref(sv: torch.Tensor, pay: torch.Tensor,
                   tile_elems: int = DEFAULT_TILE
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `sort_tiles`: every stage of the network
    over the whole arrays at once."""
    _check(sv, pay, tile_elems)
    for k in range(1, tile_elems.bit_length()):
        for j in reversed(range(k)):
            sv, pay = _stage(sv, pay, j, k, tile_elems)
    return sv, pay


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.kernel_lib().tj_sort_tiles
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sort_tiles(sv: torch.Tensor, pay: torch.Tensor,
               tile_elems: int = DEFAULT_TILE, unroll: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort each tile of tile_elems pairs of (sv, pay) by sv ascending
    (signed int32), tiles independently. n must be a multiple of tile_elems,
    a power of two of at least 1024. Equal keys: see the module docstring.

    `unroll` chose, on the TPU, between a stage loop and a statically
    unrolled network that compute the same arrays; there is one kernel
    here and the argument selects nothing."""
    del unroll
    _check(sv, pay, tile_elems)
    if not sv.is_cuda:
        return sort_tiles_ref(sv, pay, tile_elems)
    osv, opay = torch.empty_like(sv), torch.empty_like(pay)
    with torch.cuda.device(sv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(sv.data_ptr(), pay.data_ptr(), osv.data_ptr(),
                        opay.data_ptr(), sv.shape[0], tile_elems, stream)
    if err != 0:
        raise RuntimeError(f"tj_sort_tiles launch failed: CUDA error {err}")
    LAUNCHES["sort_tiles"] += 1
    return osv, opay
