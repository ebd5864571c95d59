"""NumPy oracles for radix partitioning, the join count, aggregate,
materialization, late materialization, the group-by aggregate, the
selection and the fused filter -> probe -> group-by pipeline.

Ported as written from `icde2019_gpu_join_tpu/utils/oracle.py`. Semantics
(src/join-primitives.cu:1052-1092): equi-join on int32 keys;
aggregate = SUM(Pr * Ps) over matching pairs with int32 wraparound, so any
evaluation order gives the same value; materialization = the multiset of
matched (Pr, Ps) pairs (the reference's output order is nondeterministic,
src/join-primitives.cu:1358-1373, so parity is order-insensitive).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def partition_ids(keys: np.ndarray, total_bits: int, first_bit: int) -> np.ndarray:
    """Radix partition id of each key: (uint32(hasht(k)) >> first_bit) & mask."""
    u = keys.astype(np.int64).view(np.uint64) if keys.dtype == np.int64 else keys.view(np.uint32)
    return ((u >> np.uint32(first_bit)) & np.uint32((1 << total_bits) - 1)).astype(np.int64)


def rotate_keys(keys: np.ndarray, total_bits: int, first_bit: int) -> np.ndarray:
    """Bijective packing: rotr(uint32(key), first_bit+total_bits), the radix
    field in the top bits (ops/bits.rotate_keys without the sign flip:
    numpy compares uint32 directly)."""
    s = (first_bit + total_bits) % 32
    u = keys.view(np.uint32) if keys.dtype == np.int32 else keys.astype(np.uint32)
    if s:
        u = (u >> np.uint32(s)) | (u << np.uint32(32 - s))
    return u


def radix_partition(
    keys: np.ndarray, payload: np.ndarray, total_bits: int, first_bit: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """CSR partition in the engine's canonical layout: rows ordered by the
    rotated key (grouped by partition, key-sorted within for first_bit=0;
    ties keep arrival order). Returns (keys', payload', counts, offsets)."""
    p = partition_ids(keys, total_bits, first_bit)
    order = np.argsort(rotate_keys(keys, total_bits, first_bit), kind="stable")
    counts = np.bincount(p, minlength=1 << total_bits).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return keys[order], payload[order], counts, offsets


def _match_ranges(r_keys: np.ndarray, s_keys: np.ndarray):
    """For each s, the [lo, hi) range of matches in sorted R order."""
    order = np.argsort(r_keys, kind="stable")
    rk = r_keys[order]
    lo = np.searchsorted(rk, s_keys, side="left")
    hi = np.searchsorted(rk, s_keys, side="right")
    return order, lo, hi


def join_count(r_keys: np.ndarray, s_keys: np.ndarray) -> int:
    """Number of matching (r, s) pairs."""
    _, lo, hi = _match_ranges(r_keys, s_keys)
    return int(np.sum(hi - lo, dtype=np.int64))


def join_aggregate(
    r_keys: np.ndarray, r_pay: np.ndarray, s_keys: np.ndarray, s_pay: np.ndarray
) -> int:
    """SUM(Pr * Ps) over matches, int32 wraparound; returns the int32 value."""
    order, lo, hi = _match_ranges(r_keys, s_keys)
    rp = r_pay[order].astype(np.uint64)
    # prefix sums mod 2^64, built explicitly: concatenating [0] with uint64
    # would promote to float64 and lose precision past 2^53
    pref = np.zeros(rp.shape[0] + 1, dtype=np.uint64)
    np.cumsum(rp, out=pref[1:])
    sub = (pref[hi] - pref[lo]).astype(np.uint32)  # sum of Pr per s, mod 2^32
    total = np.sum(sub * s_pay.astype(np.uint32), dtype=np.uint64)
    return int(np.uint32(total).view(np.int32))


def join_materialize(
    r_keys: np.ndarray, r_pay: np.ndarray, s_keys: np.ndarray, s_pay: np.ndarray
) -> np.ndarray:
    """All matched (Pr, Ps) pairs as an [m, 2] int32 array (canonical order:
    sorted lexicographically, since reference output order is undefined)."""
    order, lo, hi = _match_ranges(r_keys, s_keys)
    counts = hi - lo
    m = int(counts.sum())
    s_idx = np.repeat(np.arange(s_keys.shape[0]), counts)
    # ranges lo[i]..hi[i) flattened:
    starts = np.repeat(lo, counts)
    within = np.arange(m) - np.repeat(np.concatenate([[0], np.cumsum(counts)])[:-1], counts)
    r_idx = order[starts + within]
    pairs = np.stack([r_pay[r_idx], s_pay[s_idx]], axis=1).astype(np.int32)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


def join_late_materialize_sum(
    r_keys, r_rowid, s_keys, s_rowid, r_cols: np.ndarray, s_cols: np.ndarray
) -> int:
    """Late materialization: payloads are row ids; after a match, gather and
    sum extra columns (reference join_partitioned_varpayload,
    src/join-primitives.cu:1420-1557: sums col_num1/col_num2 extra columns).

    r_cols: [n_r, c1], s_cols: [n_s, c2]. Returns int32-wraparound sum of all
    gathered column values over matches."""
    order, lo, hi = _match_ranges(r_keys, s_keys)
    counts = hi - lo
    m = int(counts.sum())
    s_idx = np.repeat(np.arange(s_keys.shape[0]), counts)
    starts = np.repeat(lo, counts)
    within = np.arange(m) - np.repeat(np.concatenate([[0], np.cumsum(counts)])[:-1], counts)
    r_idx = order[starts + within]
    rsel = r_rowid[r_idx]
    ssel = s_rowid[s_idx]
    total = np.uint64(0)
    if r_cols.size:
        total += np.sum(r_cols[rsel].astype(np.uint32), dtype=np.uint64)
    if s_cols.size:
        total += np.sum(s_cols[ssel].astype(np.uint32), dtype=np.uint64)
    return int(np.uint32(total).view(np.int32))


def groupby_aggregate(
    keys: np.ndarray, vals: np.ndarray, num_groups: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Hash aggregate: per-group COUNT and SUM(vals) (int32 wraparound)."""
    cnt = np.bincount(keys, minlength=num_groups).astype(np.int32)
    sums = np.zeros(num_groups, dtype=np.uint64)
    np.add.at(sums, keys, vals.astype(np.uint32).astype(np.uint64))
    return cnt, sums.astype(np.uint32).view(np.int32)


def filter_rows(keys: np.ndarray, vals: np.ndarray, lo: int, hi: int):
    """Selection: rows with lo <= key < hi, order-preserving."""
    m = (keys >= lo) & (keys < hi)
    return keys[m], vals[m]


def filter_probe_groupby(r_keys, r_pay, s_keys, s_filter, s_gid, lo, hi,
                         num_groups) -> Tuple[np.ndarray, np.ndarray]:
    """Oracle for the fused filter -> probe -> group-by pipeline:
    per-group COUNT of matching (r, s) pairs and SUM(r_pay) over those
    pairs (int32 wraparound), over S rows passing lo <= filter < hi.
    R may contain duplicate keys: an S row matching k R rows contributes
    k to its group's COUNT and the sum of all k payloads to its SUM."""
    order = np.argsort(r_keys, kind="stable")
    rk = r_keys[order]
    rp = r_pay[order].astype(np.uint32)
    pref = np.concatenate([np.zeros(1, np.uint64),
                           np.cumsum(rp.astype(np.uint64))])
    lo_i = np.searchsorted(rk, s_keys, side="left")
    hi_i = np.searchsorted(rk, s_keys, side="right")
    keep = (s_filter >= lo) & (s_filter < hi)
    h = np.where(keep, hi_i - lo_i, 0).astype(np.uint64)     # matches per S row
    t = np.where(keep, pref[hi_i] - pref[lo_i], 0)           # payload sums

    def _bincount_mod32(gid, w32):
        # bincount-with-weights (np.add.at is ~100x slower). float64 weights
        # are only exact below 2^53, which a big group's running total can
        # exceed — so bincount the 16-bit halves separately (each partial
        # sum < 2^16 * 2^32 = 2^48, exact in float64) and recombine mod 2^32.
        lo16 = np.bincount(gid, weights=(w32 & np.uint64(0xFFFF)).astype(
            np.float64), minlength=num_groups)
        hi16 = np.bincount(gid, weights=((w32 >> np.uint64(16)) & np.uint64(
            0xFFFF)).astype(np.float64), minlength=num_groups)
        lo_u = np.mod(lo16, 2.0 ** 32).astype(np.uint64)
        hi_u = np.mod(hi16, 2.0 ** 16).astype(np.uint64) << np.uint64(16)
        return ((lo_u + hi_u) & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    counts = _bincount_mod32(s_gid, h & np.uint64(0xFFFFFFFF))
    sums = _bincount_mod32(s_gid, t & np.uint64(0xFFFFFFFF))
    return counts.view(np.int32), sums.view(np.int32)
