"""The stream-range probe: SUM(Pr*Ps) of CSR-partitioned R tiles against
the S ranges of their partitions.

Counterpart of `icde2019_gpu_join_tpu/ops/probe_pallas.py` (the TPU kernel
`probe_aggregate_ranges`, `_probe_agg_kernel`); its CUDA kernel is
`csrc/probe_ranges.cu`. Both relations are radix-partitioned on the same
field, so R tile t (rows [t*TR, (t+1)*TR)) can only match the S rows of the
partitions it spans, one contiguous range `plan_ranges` finds on the host.
No masks: keys of different partitions never match, and pad rows carry
payload 0.

Work items: the TPU kernel walks R tiles on a sequential grid and streams
each tile's range in TS-row chunks. Here the host flattens the plan into one
item per (R tile, S chunk) pair (`_items`, from the numpy plan), tile by
tile; a thread block takes a few consecutive items, so a skewed tile with
hundreds of chunks spreads over many blocks. Where the TPU kernel compares
every R row of a tile with every S row of a chunk, the CUDA kernel builds a
shared-memory hash table of the tile (1024 rows at a time) once for each
run of its items in a block and looks each S row up in it, as the
reference's join_partitioned_aggregate does. Sums wrap mod 2^32;
SUM_s sp * SUM_r [eq] rp equals the TPU's SUM_r rp * SUM_s [eq] sp bit for
bit, whatever the order of the rows.

On CUDA tensors `probe_aggregate_ranges` launches the kernel (built with
nvcc at first use) and raises if it cannot; on CPU tensors it runs the plain
version `probe_aggregate_ranges_ref`. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from icde2019_gpu_join_tpu_torch.ops import _launches
from icde2019_gpu_join_tpu_torch.ops.bits import wrap_i32

# Kernel launches since the last reset; only the CUDA path adds. With the C
# entry point's (pointers, int64 values); a stream follows them.
LAUNCHES = _launches.table(__name__, ("probe_aggregate_ranges",),
                           {"probe_aggregate_ranges": (7, 3)})

# The plain version walks the items in batches whose [items, TR, TS]
# compare tensor holds at most this many elements.
_REF_ELEMS = 1 << 26


def plan_ranges(offsets_r: np.ndarray, offsets_s: np.ndarray, n_r: int,
                tile_r: int, tile_s: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-R-tile S ranges: (s_start[t], s_nchunks[t]) as int32 numpy.

    R tile t covers rows [t*TR, (t+1)*TR); its S range spans the partitions
    of those rows: [offsets_s[p_first], offsets_s[p_last+1]), its start
    aligned down to a multiple of tile_s (over-reading neighbouring
    partitions is harmless: their keys cannot match)."""
    offsets_r = np.asarray(offsets_r, dtype=np.int64)
    offsets_s = np.asarray(offsets_s, dtype=np.int64)
    num_tiles = -(-n_r // tile_r)
    t = np.arange(num_tiles, dtype=np.int64)
    row_lo = t * tile_r
    row_hi = np.minimum((t + 1) * tile_r, n_r) - 1
    p_first = np.searchsorted(offsets_r, row_lo, side="right") - 1
    p_last = np.searchsorted(offsets_r, row_hi, side="right") - 1
    s_lo = offsets_s[p_first]
    s_hi = offsets_s[p_last + 1]
    s_lo = (s_lo // tile_s) * tile_s
    nch = -(-(s_hi - s_lo) // tile_s)
    return s_lo.astype(np.int32), nch.astype(np.int32)


def pad_for_probe(keys: torch.Tensor, pays: torch.Tensor, tile: int,
                  extra: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad (keys, pays) to a multiple of `tile` (+ extra rows) with rows of
    key 0, payload 0."""
    n = keys.shape[0]
    pad = -(-n // tile) * tile + extra - n
    if pad == 0:
        return keys, pays
    return (torch.nn.functional.pad(keys, (0, pad)),
            torch.nn.functional.pad(pays, (0, pad)))


def _check(r_keys, r_pay, s_keys, s_pay, s_start, s_nch, tile_r, tile_s):
    """The TPU kernel's contract, checked: int32 1-D contiguous columns on
    one device, R padded to tile_r (a multiple of 1024), S to tile_s (a
    multiple of 128), one range per R tile starting on a tile_s boundary."""
    if tile_r <= 0 or tile_r % 1024 or tile_s <= 0 or tile_s % 128:
        raise ValueError(f"tile_r must be a multiple of 1024 and tile_s of "
                         f"128, got {tile_r}, {tile_s}")
    dev = r_keys.device
    for name, x in (("r_keys", r_keys), ("r_pay", r_pay),
                    ("s_keys", s_keys), ("s_pay", s_pay)):
        if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous 1-D int32 "
                             f"tensor, got {x.dtype} {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, not {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if r_pay.shape != r_keys.shape or s_pay.shape != s_keys.shape:
        raise ValueError("keys and payloads differ in length")
    n_r, n_s = r_keys.shape[0], s_keys.shape[0]
    if n_r % tile_r or n_s % tile_s:
        raise ValueError(f"pad R to a multiple of {tile_r} and S to a "
                         f"multiple of {tile_s} (payload 0): {n_r}, {n_s}")
    if s_start.shape != (n_r // tile_r,) or s_nch.shape != s_start.shape:
        raise ValueError(f"need one S range per R tile ({n_r // tile_r}), "
                         f"got {s_start.shape}, {s_nch.shape}")
    if (s_start < 0).any() or (s_start % tile_s).any():
        raise ValueError("S range starts must be non-negative multiples "
                         "of tile_s")


def _items(s_start: np.ndarray, s_nch: np.ndarray, n_s: int, tile_s: int):
    """(R tile, S chunk start row) of every work item, int64 numpy, tiles
    in order. Chunk counts are clamped to the chunks that lie inside S
    (the TPU kernel's defensive clamp)."""
    start = s_start.astype(np.int64)
    nch = np.clip(np.minimum(s_nch.astype(np.int64), (n_s - start) // tile_s),
                  0, None)
    tile = np.repeat(np.arange(start.shape[0], dtype=np.int64), nch)
    first = np.cumsum(nch) - nch
    chunk = np.arange(tile.shape[0], dtype=np.int64) - np.repeat(first, nch)
    return tile, start[tile] + chunk * tile_s


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def probe_aggregate_ranges_ref(r_keys, r_pay, s_keys, s_pay, s_start, s_nch,
                               tile_r: int = 1024, tile_s: int = 2048
                               ) -> torch.Tensor:
    """Plain PyTorch version: batches of items, each a [TR, TS] compare."""
    s_start, s_nch = _host(s_start), _host(s_nch)
    _check(r_keys, r_pay, s_keys, s_pay, s_start, s_nch, tile_r, tile_s)
    dev = r_keys.device
    tile, s0 = (torch.from_numpy(a).to(dev) for a in
                _items(s_start, s_nch, s_keys.shape[0], tile_s))
    rk2, rp2 = r_keys.view(-1, tile_r), r_pay.view(-1, tile_r)
    iota = torch.arange(tile_s, dtype=torch.int64, device=dev)
    step = max(1, _REF_ELEMS // (tile_r * tile_s))
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(0, tile.shape[0], step):
        t = tile[i:i + step]
        sidx = s0[i:i + step, None] + iota
        eq = rk2[t][:, :, None] == s_keys[sidx][:, None, :]
        per_s = wrap_i32(torch.where(eq, rp2[t][:, :, None], 0).sum(1))
        acc += ((per_s.long() * s_pay[sidx].long()) & 0xFFFFFFFF).sum()
    return wrap_i32(acc)


def probe_aggregate_ranges(r_keys: torch.Tensor, r_pay: torch.Tensor,
                           s_keys: torch.Tensor, s_pay: torch.Tensor,
                           s_start, s_nch, tile_r: int = 1024,
                           tile_s: int = 2048) -> torch.Tensor:
    """SUM(Pr*Ps) over matches (int32 wraparound, 0-d int32 tensor) of
    CSR-partitioned inputs, given each R tile's S range (`plan_ranges`:
    s_start, s_nch, host numpy; a tensor is read back to the host).

    Caller contract: r_* padded to a multiple of tile_r and s_* to a
    multiple of tile_s (`pad_for_probe`), pad rows with payload 0."""
    s_start, s_nch = _host(s_start), _host(s_nch)
    _check(r_keys, r_pay, s_keys, s_pay, s_start, s_nch, tile_r, tile_s)
    if not r_keys.is_cuda:
        return probe_aggregate_ranges_ref(r_keys, r_pay, s_keys, s_pay,
                                          s_start, s_nch, tile_r, tile_s)
    dev = r_keys.device
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    tile, s0 = _items(s_start, s_nch, s_keys.shape[0], tile_s)
    if tile.shape[0] == 0:
        return out[0]
    if tile.shape[0] >= 1 << 31:
        raise ValueError(f"too many work items: {tile.shape[0]}")
    tile_d, s0_d = (torch.from_numpy(a).to(dev) for a in (tile, s0))
    _launches.launch(LAUNCHES, "probe_aggregate_ranges",
                     (r_keys, r_pay, s_keys, s_pay, tile_d, s0_d, out),
                     tile.shape[0], tile_r, tile_s)
    return out[0]
