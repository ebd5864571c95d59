"""The banded probe's compare/select kernels over one chunk.

Counterparts of the TPU kernels in
`icde2019_gpu_join_tpu/ops/band_compare_pallas.py`. A chunk has CH rows;
S-side (or slot-side) arrays are [CH, 128] int32 and R-side (window) arrays
[CH, WB] int32. Sums wrap mod 2^32 (two's-complement int32 is bit-identical
to the uint32 sum).

    banded_compare_sum(sk, sp, rk, rp)
        = SUM_{i,l,j} [sk[i,l] == rk[i,j]] * sp[i,l] * rp[i,j]      0-d
    banded_compare_per_s(sk, rk, rp) -> (h, t)                      [CH, 128]
        h = number of j with sk[i,l] == rk[i,j]; t = SUM of those rp[i,j]
    banded_compare_first(sk, rk, gidx) -> (h, fm)                   [CH, 128]
        fm = MIN of the matching gidx[i,j], INT32_MAX when none
    banded_interval_select(pos, lo, hi, p1, p2, p3) -> (o1, o2, o3)  [CH, 128]
        o_k = SUM of p_k[i,j] over j with lo[i,j] <= pos[i,l] < hi[i,j]

On CUDA tensors each wrapper launches its kernel in `csrc/band_compare.cu`
(built with nvcc at first use) and raises if it cannot; on CPU tensors it
runs the plain version (`*_ref`). `LAUNCHES` counts kernel launches per
kernel.

Caller contract: R columns outside a window carry a key that matches
nothing real and rp == 0; pad rows a sentinel key with payload 0.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from icde2019_gpu_join_tpu_torch.ops import _build, _launches
from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32

LANES = 128
INT32_MAX = 0x7FFFFFFF

# Kernel launches since the last reset, by kernel; only the CUDA path adds.
LAUNCHES: Dict[str, int] = {
    "banded_compare_sum": 0,
    "banded_compare_per_s": 0,
    "banded_compare_first": 0,
    "banded_interval_select": 0,
}

# Number of pointer arguments (inputs and outputs) of each C entry point.
_POINTERS = {
    "banded_compare_sum": 5,
    "banded_compare_per_s": 5,
    "banded_compare_first": 5,
    "banded_interval_select": 9,
}

# A plain version walks a chunk in row steps whose [rows, 128, WB] compare
# tensor holds at most this many elements.
_REF_ELEMS = 1 << 26


def reset_launches():
    _launches.reset(LAUNCHES)


def _row_steps(ch: int, wb: int):
    step = max(1, _REF_ELEMS // (LANES * max(wb, 1)))
    return [slice(i, i + step) for i in range(0, ch, step)]


def banded_compare_sum_ref(sk: torch.Tensor, sp: torch.Tensor,
                           rk: torch.Tensor, rp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a [CH, 128, WB] broadcast compare."""
    eq = sk[:, :, None] == rk[:, None, :]
    t = (eq * rp[:, None, :]).sum(2)              # int64: exact per-lane sums
    # int32 x int32 products fit in int64; keep each one's low 32 bits so
    # the final sum cannot overflow
    prod = wrap_i32(t).long() * sp.long()
    return wrap_i32((prod & 0xFFFFFFFF).sum())


def banded_compare_per_s_ref(sk, rk, rp) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `banded_compare_per_s`."""
    h, t = torch.empty_like(sk), torch.empty_like(sk)
    for sl in _row_steps(*rk.shape):
        eq = sk[sl, :, None] == rk[sl, None, :]
        h[sl] = eq.sum(2)
        t[sl] = wrap_i32((eq * rp[sl, None, :]).sum(2))
    return h, t


def banded_compare_first_ref(sk, rk, gidx) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `banded_compare_first`."""
    h, fm = torch.empty_like(sk), torch.empty_like(sk)
    for sl in _row_steps(*rk.shape):
        eq = sk[sl, :, None] == rk[sl, None, :]
        h[sl] = eq.sum(2)
        fm[sl] = torch.where(eq, gidx[sl, None, :], INT32_MAX).amin(2)
    return h, fm


def banded_interval_select_ref(pos, lo, hi, p1, p2, p3):
    """Plain PyTorch version of `banded_interval_select`."""
    outs = tuple(torch.empty_like(pos) for _ in range(3))
    for sl in _row_steps(*lo.shape):
        p = pos[sl, :, None]
        inb = (lo[sl, None, :] <= p) & (p < hi[sl, None, :])
        for o, pay in zip(outs, (p1, p2, p3)):
            o[sl] = wrap_i32((inb * pay[sl, None, :]).sum(2))
    return outs


def _check(lane_cols: dict, window_cols: dict):
    """Every array int32, 2-D, contiguous, on one device, with CH rows;
    lane arrays 128 wide, window arrays all of one shape."""
    first = next(iter(lane_cols.values()))
    ch = first.shape[0] if first.dim() == 2 else -1
    wshape = next(iter(window_cols.values())).shape
    for name, x in (*lane_cols.items(), *window_cols.items()):
        if x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != ch:
            raise ValueError(f"{name}: expected int32 [{ch}, *], got "
                             f"{x.dtype} {tuple(x.shape)}")
        if name in lane_cols and x.shape[1] != LANES:
            raise ValueError(f"{name}: expected width {LANES}, got {x.shape[1]}")
        if name in window_cols and x.shape != wshape:
            raise ValueError(f"{name} {tuple(x.shape)} differs from "
                             f"{tuple(wshape)}")
        if x.device != first.device:
            raise ValueError(f"{name} is on {x.device}, not {first.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {first.device}")


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    """The C entry point `tj_<name>`, bound with its argument types."""
    fn = getattr(_build.kernel_lib(), f"tj_{name}")
    fn.argtypes = [ctypes.c_void_p] * _POINTERS[name] + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, tensors, wb: int):
    """Launch kernel `name` over tensors (inputs, then outputs) on the
    current stream; chunks of no rows launch nothing."""
    ch = tensors[0].shape[0]
    if ch == 0:
        return
    with torch.cuda.device(tensors[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(name)(*(x.data_ptr() for x in tensors), ch, wb, stream)
    if err != 0:
        raise RuntimeError(f"tj_{name} launch failed: CUDA error {err}")
    _launches.count(LAUNCHES, name)


def banded_compare_sum(sk: torch.Tensor, sp: torch.Tensor,
                       rk: torch.Tensor, rp: torch.Tensor) -> torch.Tensor:
    """SUM over (i, l, j) of [sk==rk]*sp*rp for one chunk; int32 0-d tensor."""
    _check({"sk": sk, "sp": sp}, {"rk": rk, "rp": rp})
    if not sk.is_cuda:
        return banded_compare_sum_ref(sk, sp, rk, rp)
    out = torch.zeros(1, dtype=torch.int32, device=sk.device)
    _launch("banded_compare_sum", (sk, sp, rk, rp, out), rk.shape[1])
    return out[0]


def banded_compare_per_s(sk: torch.Tensor, rk: torch.Tensor,
                         rp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per S lane: (match count h, SUM of matched rp t), both [CH, 128]."""
    _check({"sk": sk}, {"rk": rk, "rp": rp})
    if not sk.is_cuda:
        return banded_compare_per_s_ref(sk, rk, rp)
    h, t = torch.empty_like(sk), torch.empty_like(sk)
    _launch("banded_compare_per_s", (sk, rk, rp, h, t), rk.shape[1])
    return h, t


def banded_compare_first(sk: torch.Tensor, rk: torch.Tensor,
                         gidx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per S lane: (match count h, least matching gidx fm), both [CH, 128]."""
    _check({"sk": sk}, {"rk": rk, "gidx": gidx})
    if not sk.is_cuda:
        return banded_compare_first_ref(sk, rk, gidx)
    h, fm = torch.empty_like(sk), torch.empty_like(sk)
    _launch("banded_compare_first", (sk, rk, gidx, h, fm), rk.shape[1])
    return h, fm


def banded_interval_select(pos, lo, hi, p1, p2, p3):
    """Per slot: the payload triple summed over the window columns whose
    [lo, hi) holds the slot (intervals of a row are disjoint), [CH, 128]."""
    _check({"pos": pos}, {"lo": lo, "hi": hi, "p1": p1, "p2": p2, "p3": p3})
    if not pos.is_cuda:
        return banded_interval_select_ref(pos, lo, hi, p1, p2, p3)
    outs = tuple(torch.empty_like(pos) for _ in range(3))
    _launch("banded_interval_select", (pos, lo, hi, p1, p2, p3, *outs),
            lo.shape[1])
    return outs
