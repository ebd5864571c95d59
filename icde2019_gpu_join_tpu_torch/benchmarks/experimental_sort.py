"""Full bitonic sort of every tile of (sortval, payload) pairs.

Counterpart of `benchmarks/experimental_sort_pallas.py` (`sort_tiles`); its
CUDA kernels are in `csrc/sort_tiles.cu` (`tj_sort_chunks`,
`tj_sort_strided`). Experimental: it is
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

On the card a thread block holds at most 2^14 pairs, so the network is cut
into launches: `launch_schedule` lists them for a tile size, and
`strided_block_elements` is the map of a strided pass from a block's local
index to the tile. Both are plain Python and what the CPU tests hold against
the network. The schedule exists here only: `sort_tiles` walks it and calls
one C entry point per launch, so what the tests hold is what the card runs.

On CUDA tensors `sort_tiles` launches its kernels (built with nvcc at first
use) or raises; on CPU tensors it runs the plain version. `LAUNCHES` counts
the calls that launched.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

import torch

from icde2019_gpu_join_tpu_torch.ops import _build
from icde2019_gpu_join_tpu_torch.ops.merge import (_check_aligned,
                                                   _check_pairs, _is_pow2)

DEFAULT_TILE = 1 << 20
MIN_TILE = 1024

LOG_BLOCK = 14           # log2 of the most pairs one thread block holds
LOG_PASS = 13            # log2 of a block's pairs in a pass of a merge k > 14
MAX_STRIDED_BITS = 7     # stage bits of one strided pass: segments >= 128

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


class Launch(NamedTuple):
    """One kernel launch of the tile sort on the card: for every merge k in
    [k_lo, k_hi], the stages at index bits min(k - 1, bit_hi) .. bit_lo, by
    blocks of 2^log_block pairs. kind "chunks": a block holds a chunk of
    neighbours (bit_hi = log_block - 1, bit_lo = 0); kind "strided": a block
    holds the pairs that agree outside the stage bits
    (`strided_block_elements`)."""
    kind: str
    k_lo: int
    k_hi: int
    bit_hi: int
    bit_lo: int
    log_block: int

    def stages(self) -> List[Tuple[int, int]]:
        """The (k, j) stages the launch runs, in order."""
        return [(k, j) for k in range(self.k_lo, self.k_hi + 1)
                for j in range(min(k - 1, self.bit_hi), self.bit_lo - 1, -1)]


def launch_schedule(log_tile: int) -> List[Launch]:
    """The launches that sort tiles of 2^log_tile pairs: the merges that fit
    a chunk of 2^LOG_BLOCK in one launch; then for each longer merge k its
    stages at bits >= LOG_PASS in strided passes of at most
    MAX_STRIDED_BITS bits over blocks of 2^LOG_BLOCK, and the rest in one
    pass over chunks of 2^LOG_PASS (two such blocks share a multiprocessor,
    so one's loads run under the other's stages)."""
    log_chunk = min(log_tile, LOG_BLOCK)
    launches = [Launch("chunks", 1, log_chunk, log_chunk - 1, 0, log_chunk)]
    for k in range(log_chunk + 1, log_tile + 1):
        hi = k - 1
        while hi >= LOG_PASS:
            bits = min(hi - LOG_PASS + 1, MAX_STRIDED_BITS)
            launches.append(Launch("strided", k, k, hi, hi - bits + 1,
                                   LOG_BLOCK))
            hi -= bits
        launches.append(Launch("chunks", k, k, LOG_PASS - 1, 0, LOG_PASS))
    return launches


def strided_block_elements(block: int, bit_hi: int, bit_lo: int) -> np.ndarray:
    """The flat indices of the 2^LOG_BLOCK pairs that block `block` of a
    strided pass over index bits bit_hi .. bit_lo holds, by local index:
    local = segment << seg_log | offset, the segment spells the stage bits,
    the block's number the bits between the segment's offset and bit_lo and
    those above bit_hi."""
    bits = bit_hi - bit_lo + 1
    seg_log = LOG_BLOCK - bits
    low = block & ((1 << (bit_lo - seg_log)) - 1)
    base = (low << seg_log) | ((block >> (bit_lo - seg_log)) << (bit_hi + 1))
    local = np.arange(1 << LOG_BLOCK, dtype=np.int64)
    return (base | (local & ((1 << seg_log) - 1))
            | ((local >> seg_log) << bit_lo))


@functools.lru_cache(maxsize=None)
def _kernel(kind: str):
    """The C entry point of one launch kind, bound with its argument
    types."""
    fn = getattr(_build.kernel_lib(), f"tj_sort_{kind}")
    pointers, sizes = {"chunks": (4, 5), "strided": (2, 6)}[kind]
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int64] * sizes
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def sort_tiles(sv: torch.Tensor, pay: torch.Tensor,
               tile_elems: int = DEFAULT_TILE, unroll: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort each tile of tile_elems pairs of (sv, pay) by sv ascending
    (signed int32), tiles independently. n must be a multiple of tile_elems,
    a power of two of at least 1024. Equal keys: see the module docstring.
    On the card the first launch of `launch_schedule` reads the inputs and
    the others work in place on the outputs; the kernels load 16-byte
    vectors, so `sv` and `pay` must start on a 16-byte boundary there.

    `unroll` chose, on the TPU, between a stage loop and a statically
    unrolled network that compute the same arrays; there is one kernel
    here and the argument selects nothing."""
    del unroll
    _check(sv, pay, tile_elems)
    if not sv.is_cuda:
        return sort_tiles_ref(sv, pay, tile_elems)
    _check_aligned(("sv", sv), ("pay", pay))
    n, log_tile = sv.shape[0], tile_elems.bit_length() - 1
    osv, opay = torch.empty_like(sv), torch.empty_like(pay)
    out = (osv.data_ptr(), opay.data_ptr())
    src = (sv.data_ptr(), pay.data_ptr())
    with torch.cuda.device(sv.device):
        stream = torch.cuda.current_stream().cuda_stream
        for launch in launch_schedule(log_tile):
            if launch.kind == "chunks":
                err = _kernel("chunks")(*src, *out, n, log_tile,
                                        launch.log_block, launch.k_lo,
                                        launch.k_hi, stream)
            else:
                err = _kernel("strided")(
                    *out, n, log_tile, launch.log_block, launch.bit_lo,
                    launch.bit_hi - launch.bit_lo + 1, launch.k_lo, stream)
            if err != 0:
                raise RuntimeError(f"tj_sort_{launch.kind} launch failed at "
                                   f"{launch}: CUDA error {err}")
            src = out
    LAUNCHES["sort_tiles"] += 1
    return osv, opay
