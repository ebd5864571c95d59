"""Debug-mode invariant checks of the engine's layouts.

Port of `icde2019_gpu_join_tpu/utils/debug.py`. What can go wrong in a
functional engine is a broken permutation or layout contract; these
validators assert the structural invariants on the host (`.cpu().numpy()`
of every column) and are meant for tests and debugging, never the hot
path. Each takes torch tensors or numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from icde2019_gpu_join_tpu_torch.utils import oracle


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def validate_partition(rel, original_keys, original_pays) -> None:
    """PartitionedRelation invariants:
    - counts sum to n and match offsets' diffs (CSR well-formedness);
    - the (key, payload) multiset is preserved (permutation bijectivity);
    - every row lies in the partition its key hashes to;
    - rows are ordered by rotated key within each partition."""
    keys = _host(rel.keys)
    pays = _host(rel.payload)
    counts = _host(rel.counts)
    offsets = _host(rel.offsets)
    n = keys.shape[0]
    assert counts.sum() == n, "counts do not sum to n"
    assert np.array_equal(np.diff(offsets), counts), "offsets != cumsum(counts)"
    ok = _host(original_keys)
    op = _host(original_pays)
    a = np.lexsort((pays, keys.view(np.uint32)))
    b = np.lexsort((op, ok.view(np.uint32)))
    assert np.array_equal(keys[a], ok[b]) and np.array_equal(pays[a], op[b]), \
        "permutation is not a bijection on (key, payload) pairs"
    pid = oracle.partition_ids(keys, rel.total_bits, rel.first_bit)
    for p in range(counts.shape[0]):
        lo, hi = offsets[p], offsets[p + 1]
        assert np.all(pid[lo:hi] == p), f"row in wrong partition {p}"
    rot = oracle.rotate_keys(keys, rel.total_bits, rel.first_bit)
    assert np.all(rot[1:] >= rot[:-1]), "rows not rotated-key-sorted"


def validate_sorted(sv) -> None:
    """A sort_by_key output must be globally non-decreasing (int32 order)."""
    v = _host(sv)
    assert np.all(v[1:] >= v[:-1]), "sortvals not sorted"


def validate_windows(r_sv, s_sv, lo, hi) -> None:
    """Every cross-block key match must be covered by [lo, hi)."""
    rs = _host(r_sv)
    ss = _host(s_sv)
    lo = _host(lo)
    hi = _host(hi)
    nrb = rs.size // 128
    for b in range(ss.size // 128):
        blk = ss[b * 128:(b + 1) * 128]
        for j in range(nrb):
            if np.intersect1d(blk, rs[j * 128:(j + 1) * 128]).size:
                assert lo[b] <= j < hi[b], f"window misses match ({b},{j})"


def validate_key_domain(keys) -> None:
    """Engine key-domain contract: keys must be >= 0 (int32). The engine
    reserves key -1 (pad sentinel, sortval 0x7FFFFFFF) and -2 (pipeline
    filter sentinel); a real negative key silently corrupts results. The
    reference supports the full uint32 domain (PARITY.md)."""
    k = _host(keys)
    if k.size and int(k.min()) < 0:
        raise ValueError(
            "negative keys violate the engine key-domain contract "
            f"(min={int(k.min())}); keys must be >= 0 — see PARITY.md")
