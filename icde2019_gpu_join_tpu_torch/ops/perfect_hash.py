"""Perfect-hash (dense-key) join and the global chained hash table.

Port of `icde2019_gpu_join_tpu/ops/perfect_hash.py`, the reference's
non-partitioned baselines: build_perfect_array / probe_perfect_array
(src/join-primitives.cu:628-668), a dense payload array indexed by key, and
build_ht_chains / chains_probing (:681-742), one chained table over the
whole build side with the chain walk as a C-wide compare over a bucket's
slots. Scatters follow JAX's `mode="drop"`: a negative index counts from the
end once, then indices out of range are dropped. Sums wrap mod 2^32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from icde2019_gpu_join_tpu_torch.ops.band_join import banded_join_aggregate
from icde2019_gpu_join_tpu_torch.ops.bits import _shr, wrap_i32


def _drop_scatter(table: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """table.at[idx].set(vals, mode="drop") as JAX reads it."""
    n = table.shape[0]
    idx = torch.where(idx < 0, idx.long() + n, idx.long())
    keep = (idx >= 0) & (idx < n)
    if not isinstance(vals, torch.Tensor):
        vals = torch.full_like(idx, vals, dtype=table.dtype)
    table[idx[keep]] = vals[keep]
    return table


def perfect_hash_build(r_keys: torch.Tensor, r_pay: torch.Tensor,
                       domain: int) -> torch.Tensor:
    """Dense table t[key] = payload (keys assumed unique, in [0, domain))."""
    table = torch.zeros(domain, dtype=torch.int32, device=r_keys.device)
    return _drop_scatter(table, r_keys, r_pay)


def _in_domain_gather(table: torch.Tensor, s_keys: torch.Tensor):
    """(table[clip(key)], key in [0, len(table)))."""
    idx = torch.clamp(s_keys.long(), 0, table.shape[0] - 1)
    return table[idx], (s_keys >= 0) & (s_keys < table.shape[0])


def perfect_hash_probe_aggregate(table: torch.Tensor, s_keys: torch.Tensor,
                                 s_pay: torch.Tensor) -> torch.Tensor:
    """SUM(Pr*Ps), int32 wraparound, as a 0-d int32 tensor."""
    pr, in_domain = _in_domain_gather(table, s_keys)
    pr = torch.where(in_domain, pr, 0)
    return wrap_i32(((pr.long() * s_pay.long()) & 0xFFFFFFFF).sum())


def perfect_hash_probe_materialize(table_pay: torch.Tensor,
                                   table_occupied: torch.Tensor,
                                   s_keys: torch.Tensor, s_pay: torch.Tensor):
    """Per S row: the matched build payload (0 where none) and the hit mask
    (PK build side: at most one match)."""
    pay, in_domain = _in_domain_gather(table_pay, s_keys)
    occ, _ = _in_domain_gather(table_occupied, s_keys)
    hit = in_domain & occ
    return torch.where(hit, pay, 0), hit


def perfect_hash_build_occupancy(r_keys: torch.Tensor, domain: int) -> torch.Tensor:
    occ = torch.zeros(domain, dtype=torch.bool, device=r_keys.device)
    return _drop_scatter(occ, r_keys, True)


def _fib_bucket(keys: torch.Tensor, log_buckets: int) -> torch.Tensor:
    """Multiplicative (Fibonacci) hash bucket of each key, int32: the top
    log_buckets bits of uint32(key) * 0x9E3779B1 mod 2^32, multiplied in
    int64 and masked, then shifted logically."""
    u = wrap_i32((keys.long() & 0xFFFFFFFF) * 0x9E3779B1)
    return _shr(u, 32 - log_buckets)


def global_ht_build(r_keys: torch.Tensor, r_pay: torch.Tensor,
                    log_buckets: int, chain_cap: int):
    """The global chained table as dense [H, C] key/payload planes (H =
    2^log_buckets buckets, C = chain_cap slots, the max_chain analog,
    src/common.h:66). A row's slot is its rank among its bucket's rows
    after one sort by bucket id. Rows ranked C or more overflow: they are
    returned with their keys and payloads (0 for the rows that fit), so the
    caller can join exactly them through a fallback. Empty slots hold
    key 0, payload 0 and add nothing to SUM(Pr*Ps).

    Returns (table_k, table_p, overflow_keys, overflow_pay, n_overflow);
    n_overflow is a 0-d int32 tensor."""
    n = r_keys.shape[0]
    h = _fib_bucket(r_keys, log_buckets)
    hb, order = torch.sort(h, stable=True)
    kk, pp = r_keys[order], r_pay[order]
    first = torch.searchsorted(hb, hb, side="left")
    rank = torch.arange(n, device=hb.device) - first
    fits = rank < chain_cap
    dev = r_keys.device
    table_k = torch.zeros((1 << log_buckets, chain_cap), dtype=torch.int32,
                          device=dev)
    table_p = torch.zeros_like(table_k)
    table_k[hb[fits].long(), rank[fits]] = kk[fits]
    table_p[hb[fits].long(), rank[fits]] = pp[fits]
    overflow_pay = torch.where(fits, 0, pp)
    n_overflow = (~fits).sum().to(torch.int32)
    return table_k, table_p, kk, overflow_pay, n_overflow


def global_ht_probe_aggregate(table_k: torch.Tensor, table_p: torch.Tensor,
                              s_keys: torch.Tensor, s_pay: torch.Tensor,
                              log_buckets: int, chunk: int = 1 << 20
                              ) -> torch.Tensor:
    """Per S row: gather its bucket's C slots and accumulate Pr*Ps over key
    matches; in chunks of `chunk` rows so the [chunk, C] gather stays
    bounded. A 0-d int32 tensor, int32 wraparound."""
    total = torch.zeros((), dtype=torch.int64, device=s_keys.device)
    for lo in range(0, s_keys.shape[0], chunk):
        k, p = s_keys[lo:lo + chunk], s_pay[lo:lo + chunk]
        b = _fib_bucket(k, log_buckets).long()
        match = table_k[b] == k[:, None]
        pr = wrap_i32(torch.where(match, table_p[b], 0).sum(1)).long()
        total += ((pr * p.long()) & 0xFFFFFFFF).sum()
        total &= 0xFFFFFFFF
    return wrap_i32(total)


def default_log_buckets(n_rows: int, chain_cap: int = 8) -> int:
    """Buckets for a load factor of at most 0.5: H >= 2 * n_rows / C."""
    return max(1, math.ceil(math.log2(2 * max(n_rows, 1) / chain_cap)))


def global_ht_join_aggregate(r_keys: torch.Tensor, r_pay: torch.Tensor,
                             s_keys: torch.Tensor, s_pay: torch.Tensor,
                             log_buckets: Optional[int] = None,
                             chain_cap: int = 8,
                             sort_impl: str = "lax") -> torch.Tensor:
    """Global chained-hash-table join (build_ht_chains / chains_probing
    analog, src/join-primitives.cu:681-742): SUM(Pr*Ps), int32 wraparound,
    as a 0-d int32 tensor. Build rows past a bucket's C slots are joined
    exactly by the banded engine (`banded_join_aggregate`, kernel 1) over
    the overflow rows, sorted by `sort_impl`, only when there are any (one
    host read; JAX: lax.cond). Bit-exact for keys >= 0 (the banded engine's key domain)."""
    if log_buckets is None:
        log_buckets = default_log_buckets(r_keys.shape[0], chain_cap)
    table_k, table_p, ov_keys, ov_pay, n_ov = global_ht_build(
        r_keys, r_pay, log_buckets, chain_cap)
    total = global_ht_probe_aggregate(table_k, table_p, s_keys, s_pay,
                                      log_buckets)
    if int(n_ov) > 0:
        residual = banded_join_aggregate(ov_keys, ov_pay, s_keys, s_pay,
                                         sort_impl=sort_impl)
        return wrap_i32(total.long() + residual.long())
    return total
