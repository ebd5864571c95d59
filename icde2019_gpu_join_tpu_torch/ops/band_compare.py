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

Kernels 1, 2 and 3 take WB a multiple of 128 (window_blocks * 128, as in
JAX). Their windowed entry points read the sorted, 128-padded block views
themselves, so the probe gathers no chunk:

    banded_window_sum(s_svb, s_payb, r_svb, r_payb, ids, lo, hi, r, w, acc)
        acc += banded_compare_sum of the round's chunk                 [1]
    banded_window_per_s(s_svb, r_svb, r_payb, ids, lo, hi, r, w, h, t)
        h[ids] += and t[ids] += its banded_compare_per_s     [S blocks, 128]
    banded_window_first(s_svb, r_svb, ids, lo, hi, r, w, h, fm)
        h[ids] += and fm[ids] = min with its banded_compare_first  [S blocks, 128]

where chunk row i is S block ids[i] against R blocks lo[ids[i]] + r*w + k,
k < w, each clamped into [0, R blocks), and a block at or past hi[ids[i]] is
masked: its rp is 0, its key R_PAD_SV (`*_ref` spell the gathers out).

On CUDA tensors each wrapper launches its kernel in `csrc/band_compare.cu`
(built with nvcc at first use) and raises if it cannot; on CPU tensors it
runs the plain version (`*_ref`); a call of no chunk rows launches
nothing. `LAUNCHES` counts kernel launches per kernel.

Caller contract: R columns outside a window carry a key that matches
nothing real and rp == 0; pad rows a sentinel key with payload 0.
"""

from __future__ import annotations

from typing import Tuple

import torch

from icde2019_gpu_join_tpu_torch.ops import _launches
from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32

LANES = 128
INT32_MAX = 0x7FFFFFFF
R_PAD_SV = INT32_MAX   # sortval of the R-pad key -1: a masked window column

# Each C entry point's pointer arguments (inputs and outputs), then its
# int64 arguments; a stream follows.
_ENTRIES = {
    "banded_compare_sum": (5, 2),
    "banded_compare_per_s": (5, 2),
    "banded_compare_first": (5, 2),
    "banded_interval_select": (9, 2),
    "banded_window_sum": (8, 5),
    "banded_window_per_s": (8, 5),
    "banded_window_first": (7, 5),
}

# Kernel launches since the last reset, by kernel; only the CUDA path adds.
LAUNCHES = _launches.table(__name__, _ENTRIES, _ENTRIES)

# A plain version walks a chunk in row steps whose [rows, 128, WB] compare
# tensor holds at most this many elements.
_REF_ELEMS = 1 << 26


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


def window_plan(ids, lo, hi, r: int, w: int, nrb: int):
    """The R blocks of a round's chunk rows, [n, w], clamped into [0, nrb),
    and whether each lies before its S block's hi."""
    base = lo[ids].long() + r * w
    bidx = base[:, None] + torch.arange(w, device=ids.device)
    valid = bidx < hi[ids].long()[:, None]
    return bidx.clamp_(0, nrb - 1), valid


def gather_window(blocks, bidx, valid, fill: int):
    """The [n, w*128] rows of 128-wide `blocks` at bidx, `fill` outside the
    windows."""
    n, w = bidx.shape
    x = blocks[bidx.view(-1)].view(n, w, LANES)
    x.masked_fill_(~valid[:, :, None], fill)
    return x.view(n, w * LANES)


def _check_ids(ids, nsb: int):
    """What the kernels check on the card (a device-side assert): every id
    names an S block."""
    if ids.numel() and not (0 <= int(ids.min()) and int(ids.max()) < nsb):
        raise ValueError(f"ids outside [0, {nsb}): {int(ids.min())} .. "
                         f"{int(ids.max())}")


def banded_window_sum_ref(s_svb, s_payb, r_svb, r_payb, ids, lo, hi, r: int,
                          w: int, acc):
    """Plain version of `banded_window_sum`: the gathers, then
    `banded_compare_sum_ref`; masked columns keep their keys, rp 0."""
    _check_ids(ids, s_svb.shape[0])
    bidx, valid = window_plan(ids, lo, hi, r, w, r_svb.shape[0])
    rp = gather_window(r_payb, bidx, valid, 0)
    rk = r_svb[bidx.view(-1)].view(rp.shape)
    got = banded_compare_sum_ref(s_svb[ids], s_payb[ids], rk, rp)
    acc.copy_(wrap_i32(acc.long() + got.long()))
    return acc


def banded_window_per_s_ref(s_svb, r_svb, r_payb, ids, lo, hi, r: int,
                            w: int, h, t):
    """Plain version of `banded_window_per_s`: the gathers (masked keys
    R_PAD_SV, rp 0), `banded_compare_per_s_ref`, then `index_add_` at the
    ids."""
    _check_ids(ids, s_svb.shape[0])
    bidx, valid = window_plan(ids, lo, hi, r, w, r_svb.shape[0])
    hc, tc = banded_compare_per_s_ref(
        s_svb[ids], gather_window(r_svb, bidx, valid, R_PAD_SV),
        gather_window(r_payb, bidx, valid, 0))
    h.index_add_(0, ids, hc)
    t.index_add_(0, ids, tc)
    return h, t


def banded_window_first_ref(s_svb, r_svb, ids, lo, hi, r: int, w: int, h,
                            fm):
    """Plain version of `banded_window_first`: the gathers (masked keys
    R_PAD_SV, gidx of the clamped blocks), `banded_compare_first_ref`, then
    `index_add_` and `minimum` at the ids."""
    _check_ids(ids, s_svb.shape[0])
    bidx, valid = window_plan(ids, lo, hi, r, w, r_svb.shape[0])
    lane = torch.arange(LANES, dtype=torch.int32, device=ids.device)
    gidx = (bidx.to(torch.int32)[:, :, None] * LANES + lane).view(
        ids.numel(), w * LANES)
    hc, fc = banded_compare_first_ref(
        s_svb[ids], gather_window(r_svb, bidx, valid, R_PAD_SV), gidx)
    h.index_add_(0, ids, hc)
    fm[ids] = torch.minimum(fm[ids], fc)
    return h, fm


def _aligned(name: str, x: torch.Tensor):
    """Kernels 1, 2 and 3 copy 16-byte pieces of 512-byte rows."""
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _check(lane_cols: dict, window_cols: dict, blocks: bool = False):
    """Every array int32, 2-D, contiguous, on one device, with CH rows;
    lane arrays 128 wide, window arrays all of one shape. With `blocks`
    (kernels 1, 2 and 3), WB is a multiple of 128 and every array starts on a
    16-byte boundary."""
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
        if blocks:
            _aligned(name, x)
    if blocks and wshape[1] % LANES:
        raise ValueError(f"window width {wshape[1]} is no multiple of {LANES}")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {first.device}")


def _check_blocks(arrays: dict, device) -> int:
    """Each array int32 [rows, 128] of one shape, contiguous, on `device`,
    on a 16-byte boundary; returns rows."""
    shape = tuple(next(iter(arrays.values())).shape)
    for name, x in arrays.items():
        if (x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != LANES
                or tuple(x.shape) != shape):
            raise ValueError(f"{name}: expected int32 [{shape[0]}, {LANES}], "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, not {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        _aligned(name, x)
    return shape[0]


def _check_window(s_side: dict, r_side: dict, ids, lo, hi, r, w,
                  acc=None) -> Tuple[int, int]:
    """The windowed entry points' arguments: the S block views and the
    outputs h, t, fm [S blocks, 128], the R block views [R blocks >= 1, 128],
    all as `_check_blocks` asks; ids int64 [n]; lo, hi int32 [S blocks];
    acc int32 [1]; r >= 0, w >= 1; one device. Returns (S blocks, R
    blocks)."""
    dev = ids.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    nsb = _check_blocks(s_side, dev)
    nrb = _check_blocks(r_side, dev)
    if nrb < 1:
        raise ValueError("the R side has no block")
    if ids.dtype != torch.int64 or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError(f"ids: expected contiguous int64 [n], got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    ends = {"lo": (lo, (nsb,)), "hi": (hi, (nsb,))}
    if acc is not None:
        ends["acc"] = (acc, (1,))
    for name, (x, shape) in ends.items():
        if (x.dtype != torch.int32 or tuple(x.shape) != shape
                or not x.is_contiguous() or x.device != dev):
            raise ValueError(f"{name}: expected contiguous int32 {list(shape)}"
                             f" on {dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    if not (isinstance(r, int) and isinstance(w, int) and r >= 0 and w >= 1):
        raise ValueError(f"round {r!r} and width {w!r}: need r >= 0, w >= 1")
    return nsb, nrb


def banded_compare_sum(sk: torch.Tensor, sp: torch.Tensor,
                       rk: torch.Tensor, rp: torch.Tensor) -> torch.Tensor:
    """SUM over (i, l, j) of [sk==rk]*sp*rp for one chunk; int32 0-d tensor."""
    _check({"sk": sk, "sp": sp}, {"rk": rk, "rp": rp}, blocks=True)
    if not sk.is_cuda:
        return banded_compare_sum_ref(sk, sp, rk, rp)
    out = torch.zeros(1, dtype=torch.int32, device=sk.device)
    if rk.shape[0]:
        _launches.launch(LAUNCHES, "banded_compare_sum", (sk, sp, rk, rp, out),
                         *rk.shape)
    return out[0]


def banded_compare_per_s(sk: torch.Tensor, rk: torch.Tensor,
                         rp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per S lane: (match count h, SUM of matched rp t), both [CH, 128]."""
    _check({"sk": sk}, {"rk": rk, "rp": rp}, blocks=True)
    if not sk.is_cuda:
        return banded_compare_per_s_ref(sk, rk, rp)
    h, t = torch.empty_like(sk), torch.empty_like(sk)
    if rk.shape[0]:
        _launches.launch(LAUNCHES, "banded_compare_per_s", (sk, rk, rp, h, t),
                         *rk.shape)
    return h, t


def banded_compare_first(sk: torch.Tensor, rk: torch.Tensor,
                         gidx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per S lane: (match count h, least matching gidx fm), both [CH, 128]."""
    _check({"sk": sk}, {"rk": rk, "gidx": gidx}, blocks=True)
    if not sk.is_cuda:
        return banded_compare_first_ref(sk, rk, gidx)
    h, fm = torch.empty_like(sk), torch.empty_like(sk)
    if rk.shape[0]:
        _launches.launch(LAUNCHES, "banded_compare_first",
                         (sk, rk, gidx, h, fm), *rk.shape)
    return h, fm


def banded_interval_select(pos, lo, hi, p1, p2, p3):
    """Per slot: the payload triple summed over the window columns whose
    [lo, hi) holds the slot (intervals of a row are disjoint), [CH, 128]."""
    _check({"pos": pos}, {"lo": lo, "hi": hi, "p1": p1, "p2": p2, "p3": p3})
    if not pos.is_cuda:
        return banded_interval_select_ref(pos, lo, hi, p1, p2, p3)
    outs = tuple(torch.empty_like(pos) for _ in range(3))
    if lo.shape[0]:
        _launches.launch(LAUNCHES, "banded_interval_select",
                         (pos, lo, hi, p1, p2, p3, *outs), *lo.shape)
    return outs


def banded_window_sum(s_svb: torch.Tensor, s_payb: torch.Tensor,
                      r_svb: torch.Tensor, r_payb: torch.Tensor,
                      ids: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                      r: int, w: int, acc: torch.Tensor) -> torch.Tensor:
    """Adds round r's chunk sum over S blocks `ids` (unique) to acc, an
    int32 [1] holding uint32 bits, and returns acc."""
    nsb, nrb = _check_window({"s_svb": s_svb, "s_payb": s_payb},
                             {"r_svb": r_svb, "r_payb": r_payb}, ids, lo, hi,
                             r, w, acc)
    if not ids.is_cuda:
        return banded_window_sum_ref(s_svb, s_payb, r_svb, r_payb, ids, lo, hi,
                                     r, w, acc)
    if ids.numel():
        _launches.launch(LAUNCHES, "banded_window_sum",
                         (s_svb, s_payb, r_svb, r_payb, ids, lo, hi, acc),
                         ids.numel(), nsb, nrb, r, w)
    return acc


def banded_window_per_s(s_svb: torch.Tensor, r_svb: torch.Tensor,
                        r_payb: torch.Tensor, ids: torch.Tensor,
                        lo: torch.Tensor, hi: torch.Tensor, r: int, w: int,
                        h: torch.Tensor, t: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adds round r's chunk match counts to h and matched-rp sums to t
    [S blocks, 128] at the S blocks `ids` (unique); returns (h, t)."""
    nsb, nrb = _check_window({"s_svb": s_svb, "h": h, "t": t},
                             {"r_svb": r_svb, "r_payb": r_payb}, ids, lo, hi,
                             r, w)
    if not ids.is_cuda:
        return banded_window_per_s_ref(s_svb, r_svb, r_payb, ids, lo, hi, r, w,
                                       h, t)
    if ids.numel():
        _launches.launch(LAUNCHES, "banded_window_per_s",
                         (s_svb, r_svb, r_payb, ids, lo, hi, h, t),
                         ids.numel(), nsb, nrb, r, w)
    return h, t


def banded_window_first(s_svb: torch.Tensor, r_svb: torch.Tensor,
                        ids: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                        r: int, w: int, h: torch.Tensor, fm: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Updates h (+=) and fm (min) [S blocks, 128] at the S blocks `ids`
    (unique) with round r's chunk; returns (h, fm)."""
    nsb, nrb = _check_window({"s_svb": s_svb, "h": h, "fm": fm},
                             {"r_svb": r_svb}, ids, lo, hi, r, w)
    if not ids.is_cuda:
        return banded_window_first_ref(s_svb, r_svb, ids, lo, hi, r, w, h, fm)
    if ids.numel():
        _launches.launch(LAUNCHES, "banded_window_first",
                         (s_svb, r_svb, ids, lo, hi, h, fm), ids.numel(), nsb,
                         nrb, r, w)
    return h, fm
