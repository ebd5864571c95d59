"""The banded probe's fused compare x multiply x sum over one chunk.

    banded_compare_sum(sk, sp, rk, rp)
        = SUM_{i,l,j} [sk[i,l] == rk[i,j]] * sp[i,l] * rp[i,j]    (mod 2^32)

sk, sp: [CH, 128] int32; rk, rp: [CH, WB] int32. Returns a 0-d int32
tensor on the inputs' device (two's-complement wraparound is bit-identical
to the uint32 sum). Counterpart of the TPU kernel
`icde2019_gpu_join_tpu/ops/band_compare_pallas.py` `banded_compare_sum`.

On CUDA tensors the wrapper launches `csrc/band_compare.cu` (built with
nvcc at first use) and raises if it cannot; on CPU tensors it runs the
plain version, `banded_compare_sum_ref`. `LAUNCHES` counts kernel launches.

Caller contract: R columns outside a window carry rp == 0, and pad rows a
sentinel key with payload 0.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from icde2019_gpu_join_tpu_torch.ops import _build
from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32

LANES = 128

# Kernel launches since the last reset; only the CUDA path adds to it.
LAUNCHES = 0


def banded_compare_sum_ref(sk: torch.Tensor, sp: torch.Tensor,
                           rk: torch.Tensor, rp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a [CH, 128, WB] broadcast compare."""
    eq = sk[:, :, None] == rk[:, None, :]
    t = (eq * rp[:, None, :]).sum(2)              # int64: exact per-lane sums
    # int32 x int32 products fit in int64; keep each one's low 32 bits so
    # the final sum cannot overflow
    prod = wrap_i32(t).long() * sp.long()
    return wrap_i32((prod & 0xFFFFFFFF).sum())


def _check(sk, sp, rk, rp):
    ch = sk.shape[0] if sk.dim() == 2 else -1
    for name, x, width in (("sk", sk, LANES), ("sp", sp, LANES),
                           ("rk", rk, None), ("rp", rp, None)):
        if x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != ch:
            raise ValueError(f"{name}: expected int32 [{ch}, *], got "
                             f"{x.dtype} {tuple(x.shape)}")
        if width is not None and x.shape[1] != width:
            raise ValueError(f"{name}: expected width {width}, got {x.shape[1]}")
        if x.device != sk.device:
            raise ValueError(f"{name} is on {x.device}, sk on {sk.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rk.shape != rp.shape:
        raise ValueError(f"rk {tuple(rk.shape)} and rp {tuple(rp.shape)} differ")
    if sk.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {sk.device}")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.kernel_lib().tj_band_compare_sum
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(sk, sp, rk, rp) -> torch.Tensor:
    global LAUNCHES
    out = torch.zeros(1, dtype=torch.int32, device=sk.device)
    ch, wb = rk.shape
    if ch == 0:
        return out[0]
    with torch.cuda.device(sk.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(sk.data_ptr(), sp.data_ptr(), rk.data_ptr(),
                        rp.data_ptr(), out.data_ptr(), ch, wb, stream)
    if err != 0:
        raise RuntimeError(f"tj_band_compare_sum launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out[0]


def banded_compare_sum(sk: torch.Tensor, sp: torch.Tensor,
                       rk: torch.Tensor, rp: torch.Tensor) -> torch.Tensor:
    """SUM over (i, l, j) of [sk==rk]*sp*rp for one chunk; int32 0-d tensor.

    CUDA tensors go to the kernel, CPU tensors to the plain version."""
    _check(sk, sp, rk, rp)
    if sk.is_cuda:
        return _launch(sk, sp, rk, rp)
    return banded_compare_sum_ref(sk, sp, rk, rp)
