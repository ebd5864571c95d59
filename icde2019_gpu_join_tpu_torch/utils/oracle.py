"""NumPy oracles for the join count and aggregate.

Semantics (src/join-primitives.cu:1052-1092): equi-join on int32 keys;
aggregate = SUM(Pr * Ps) over matching pairs with int32 wraparound, so any
evaluation order gives the same value.
"""

from __future__ import annotations

import numpy as np


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
