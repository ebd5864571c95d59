"""The engine's (sortval, payload) pair sort on the card: an LSD radix sort
that carries the payload through every pass.

    radix_sort_pairs(sv, pv) -> (sv sorted ascending as signed int32,
                                 the payloads in the same order)

sv and pv are contiguous 1-D int32 tensors of the same length, under 2^31
rows. On CUDA tensors the kernels of `csrc/radix_pairs.cu` run on the
current stream: one histogram launch and four digit passes (8 bits each,
the sign bit flipped at digit extraction), with outputs, one scratch pair
and the zeroed look-back state allocated here per call, so that callers on
several streams never share state. The sort is stable: the payloads of
equal keys keep their input order. On CPU tensors the plain version runs:
`torch_sort_pairs`, `torch.sort` of the keys and a gather of the payloads,
which is not stable. Callers may rely on
neither order among equal keys: they compare results as sums or multisets.

It replaces no TPU kernel: the JAX package sorts with the library's
`lax.sort`, whose counterpart on the card was `torch.sort` of the keys with
an int64 index and a gather of the payloads through it (ROADMAP R1).

`LAUNCHES` counts kernel launches, five a sort of at least one row.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from icde2019_gpu_join_tpu_torch.ops import _build, _launches

DIGITS = 256
PASSES = 4
TILE = 8192          # rows a block of a pass takes (`kTile` in the source)

# Each C entry point's pointer arguments, then its int64 arguments; a stream
# follows.
_ENTRIES = {"radix_histogram": (2, 1), "radix_pass": (7, 2)}

# Kernel launches since the last reset, by kernel; only the CUDA path adds.
LAUNCHES = _launches.table(__name__, _ENTRIES, _ENTRIES)


def torch_sort_pairs(sv: torch.Tensor, pv: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The library sort, `radix_sort_pairs`' plain version: `torch.sort` of
    the keys and a gather of the payloads."""
    sv_s, idx = torch.sort(sv)
    return sv_s, pv[idx]


def check_pairs(sv: torch.Tensor, pv: torch.Tensor):
    """Raise unless (sv, pv) are contiguous 1-D int32 tensors of one length
    under 2^31 rows, both on the CPU or on one card."""
    for name, x in (("sv", sv), ("pv", pv)):
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous 1-D int32 "
                             f"tensor, got {x.dtype} {tuple(x.shape)}")
    if sv.shape != pv.shape or sv.device != pv.device:
        raise ValueError(f"sv {tuple(sv.shape)} on {sv.device} and pv "
                         f"{tuple(pv.shape)} on {pv.device} differ")
    if sv.shape[0] >= 1 << 31:
        raise ValueError(f"{sv.shape[0]} rows: the sort takes fewer than 2^31")
    if sv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {sv.device}")


@functools.lru_cache(maxsize=None)
def _configure(device_index: int):
    """Once a card: let the pass kernels take their shared memory there."""
    fn = _build.entry("radix_configure", args=())
    with torch.cuda.device(device_index):
        err = fn()
    if err != 0:
        raise RuntimeError(f"tj_radix_configure failed: CUDA error {err}")


def radix_sort_pairs(sv: torch.Tensor, pv: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sv, pv) sorted by sv ascending (signed int32), stably on the card;
    see the module doc."""
    check_pairs(sv, pv)
    if not sv.is_cuda:
        return torch_sort_pairs(sv, pv)
    n = sv.shape[0]
    keys_out, vals_out = torch.empty_like(sv), torch.empty_like(pv)
    if n == 0:
        return keys_out, vals_out
    tiles = -(-n // TILE)
    keys_tmp, vals_tmp = torch.empty_like(sv), torch.empty_like(pv)
    # int64 words: the look-back status [tiles, 256], then hist [4, 256] and
    # the passes' tile counters [4] as uint32
    state = torch.zeros(tiles * DIGITS + (PASSES * DIGITS + PASSES) // 2,
                        dtype=torch.int64, device=sv.device)
    hist = state.data_ptr() + 8 * tiles * DIGITS
    counters = hist + 4 * PASSES * DIGITS
    at = _launches.Address
    _configure(sv.device.index)
    with torch.cuda.device(sv.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launches.launch(LAUNCHES, "radix_histogram", (sv, at(hist)), n,
                         stream=stream)
        src = (sv, pv)
        for p in range(PASSES):
            dst = (keys_tmp, vals_tmp) if p % 2 == 0 else (keys_out, vals_out)
            _launches.launch(LAUNCHES, "radix_pass",
                             (*src, *dst, at(hist + 4 * DIGITS * p), state,
                              at(counters + 4 * p)), n, p, stream=stream)
            src = dst
    return keys_out, vals_out
