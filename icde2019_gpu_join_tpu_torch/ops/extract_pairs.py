"""Materialize's extraction: every output slot's matched (Pr, Ps) pair.

    extract_pairs(off, fm, s_p, r_p, capacity, total, wrap)
        -> (out_r, out_s), int32 [capacity] each

Both relations are sorted by key: S row i matches the sorted-R rows
[fm[i], fm[i] + h[i]), and off (the exclusive sum of h) is where those
matches begin in the S-sorted match stream of `total` matches. Slot pos
holds match m = pos, or with `wrap` and more matches than slots the last
lap's, m = pos + capacity * floor((total - 1 - pos) / capacity). Its owner
is the last S row i with off[i] <= m (clamped into [0, n_s - 1]), and the
slot gets (r_p[fm[i] + m - off[i]], s_p[i]), the R position clamped into
[0, n_r - 1]; a slot with no match (pos >= total) gets (0, 0).

off, fm, s_p and r_p are 1-D int32 tensors on the CPU or on one card, off,
fm and s_p of one length. On CUDA tensors one launch of the kernel of
`csrc/extract_pairs.cu` runs on the current stream: a load-balanced search
over the merge of matches and S rows, each input read once, each slot
written once. On CPU tensors the plain version runs: `torch_extract_pairs`,
the slot path's searchsorted formula.

It replaces no TPU kernel: on the TPU, which cannot gather, the JAX package
extracts by block windows (`band_join._extract_blocked`, with kernels 4 and
2) behind a span check, and by this module's formula where the check fails.

`LAUNCHES` counts kernel launches: one a call with at least one slot.
"""

from __future__ import annotations

from typing import Tuple

import torch

from icde2019_gpu_join_tpu_torch.ops import _launches

# Kernel launches since the last reset; only the CUDA path adds. With the C
# entry point's (pointers, int64 values); a stream follows them.
LAUNCHES = _launches.table(__name__, ("extract_pairs",),
                           {"extract_pairs": (6, 5)})


def torch_extract_pairs(off: torch.Tensor, fm: torch.Tensor, s_p: torch.Tensor,
                        r_p: torch.Tensor, capacity: int, total: int,
                        wrap: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """`extract_pairs`' plain version: each slot's match, then its owner by
    one searchsorted over off, so the cost is O(capacity log n_s) whatever
    the total. Both sides hold a row: a total at or below 0 then gives every
    slot (0, 0) with no case of its own, and an empty side, whose total is
    0, is its caller's (`banded_materialize` returns zeros before it
    extracts)."""
    dev = off.device
    pos = torch.arange(capacity, dtype=torch.int64, device=dev)
    m = pos
    if wrap:
        m = pos + torch.clamp(total - 1 - pos, min=0) // capacity * capacity
    s_row = torch.clamp(
        torch.searchsorted(off, m.to(torch.int32), right=True) - 1,
        0, off.shape[0] - 1)
    r_pos = torch.clamp(fm[s_row].long() + m - off[s_row], 0, r_p.shape[0] - 1)
    valid = pos < total
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return (torch.where(valid, r_p[r_pos], zero),
            torch.where(valid, s_p[s_row], zero))


def _check(off, fm, s_p, r_p, capacity: int):
    named = {"off": off, "fm": fm, "s_p": s_p, "r_p": r_p}
    for name, x in named.items():
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous 1-D int32 tensor, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.device != off.device:
            raise ValueError(f"{name} on {x.device}, off on {off.device}")
    if not off.shape == fm.shape == s_p.shape:
        raise ValueError(f"off, fm, s_p: lengths {off.shape[0]}, "
                         f"{fm.shape[0]}, {s_p.shape[0]} differ")
    if off.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {off.device}")
    if capacity < 0:
        raise ValueError(f"capacity {capacity} < 0")


def extract_pairs(off: torch.Tensor, fm: torch.Tensor, s_p: torch.Tensor,
                  r_p: torch.Tensor, capacity: int, total: int,
                  wrap: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every slot's (Pr, Ps) pair; see the module doc."""
    _check(off, fm, s_p, r_p, capacity)
    if not off.is_cuda:
        return torch_extract_pairs(off, fm, s_p, r_p, capacity, total, wrap)
    out_r = torch.empty(capacity, dtype=torch.int32, device=off.device)
    out_s = torch.empty_like(out_r)
    if capacity:
        _launches.launch(LAUNCHES, "extract_pairs",
                         (off, fm, s_p, r_p, out_r, out_s), off.shape[0],
                         r_p.shape[0], capacity, total, int(wrap))
    return out_r, out_s
