"""The port's perfect-hash join and global chained hash table
(ops/perfect_hash.py) against the JAX package's, mirroring
tests/test_probe.py's global-table tests and tests/test_ops.py's
perfect-hash test."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu.ops import perfect_hash as jph
from icde2019_gpu_join_tpu_torch.ops import perfect_hash as ph
from icde2019_gpu_join_tpu_torch.utils import oracle as toracle


def _both(*arrs):
    return [torch.from_numpy(a) for a in arrs], [jnp.asarray(a) for a in arrs]


def _full(rng, n):
    return rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)


def test_perfect_hash_join_matches_jax(rng):
    n_r, n_s = 1000, 5000
    rk = rng.permutation(n_r).astype(np.int32)
    sk = np.concatenate([rk[rng.randint(0, n_r, n_s - 100)],
                         rng.randint(-50, 2 * n_r, 100)]).astype(np.int32)
    rp, sp = _full(rng, n_r), _full(rng, n_s)
    (trk, trp, tsk, tsp), (jrk, jrp, jsk, jsp) = _both(rk, rp, sk, sp)
    table = ph.perfect_hash_build(trk, trp, n_r)
    jtable = jph.perfect_hash_build(jrk, jrp, n_r)
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
    got = ph.perfect_hash_probe_aggregate(table, tsk, tsp)
    assert got.dtype == torch.int32
    assert int(got) == int(jph.perfect_hash_probe_aggregate(jtable, jsk, jsp)) \
        == toracle.join_aggregate(rk, rp, sk, sp)


def test_perfect_hash_scatter_drops_like_jax():
    """Out-of-domain build keys: a negative key counts from the end once,
    the rest out of range are dropped."""
    rk = np.array([-1, 2, 7, -6, 0, 4], np.int32)
    rp = np.array([10, 20, 30, 40, 50, 60], np.int32)
    (trk, trp), (jrk, jrp) = _both(rk, rp)
    np.testing.assert_array_equal(ph.perfect_hash_build(trk, trp, 5).numpy(),
                                  np.asarray(jph.perfect_hash_build(jrk, jrp, 5)))
    np.testing.assert_array_equal(
        ph.perfect_hash_build_occupancy(trk, 5).numpy(),
        np.asarray(jph.perfect_hash_build_occupancy(jrk, 5)))


def test_perfect_hash_materialize_matches_jax(rng):
    domain = 600
    rk = rng.permutation(domain)[:400].astype(np.int32)
    rp = _full(rng, 400)
    sk = rng.randint(-20, domain + 20, 3000).astype(np.int32)
    sp = _full(rng, 3000)
    (trk, trp, tsk, tsp), (jrk, jrp, jsk, jsp) = _both(rk, rp, sk, sp)
    pay, hit = ph.perfect_hash_probe_materialize(
        ph.perfect_hash_build(trk, trp, domain),
        ph.perfect_hash_build_occupancy(trk, domain), tsk, tsp)
    jpay, jhit = jph.perfect_hash_probe_materialize(
        jph.perfect_hash_build(jrk, jrp, domain),
        jph.perfect_hash_build_occupancy(jrk, domain), jsk, jsp)
    np.testing.assert_array_equal(pay.numpy(), np.asarray(jpay))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))


@pytest.mark.parametrize("log_buckets", [1, 8, 13, 31])
def test_fib_bucket_matches_jax(rng, log_buckets):
    keys = np.concatenate([_full(rng, 5000), np.array(
        [0, -1, 2**31 - 1, -2**31], np.int32)])
    got = ph._fib_bucket(torch.from_numpy(keys), log_buckets)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jph._fib_bucket(jnp.asarray(keys), log_buckets)))


def _bucket_multisets(table_k, table_p):
    """Each bucket's slots as a sorted list of (key, payload): slot order
    within a bucket follows the (unstable in JAX) sort."""
    k, p = np.asarray(table_k), np.asarray(table_p)
    packed = (k.astype(np.int64) << 32) | (p.astype(np.int64) & 0xFFFFFFFF)
    return np.sort(packed, axis=1)


@pytest.mark.parametrize("log_buckets,chain_cap", [(11, 8), (6, 4)])
def test_global_ht_build_matches_jax(rng, log_buckets, chain_cap):
    rk = rng.randint(0, 1 << 14, 3000).astype(np.int32)
    rp = _full(rng, 3000)
    (trk, trp), (jrk, jrp) = _both(rk, rp)
    tk, tp, ok, op, n_ov = ph.global_ht_build(trk, trp, log_buckets, chain_cap)
    jk, jp, jok, jop, jn_ov = jph.global_ht_build(jrk, jrp, log_buckets,
                                                  chain_cap)
    assert n_ov.dtype == torch.int32 and int(n_ov) == int(jn_ov)
    assert tk.shape == (1 << log_buckets, chain_cap)
    if int(n_ov) == 0:   # which rows overflow depends on the sort's tie order
        np.testing.assert_array_equal(_bucket_multisets(tk, tp),
                                      _bucket_multisets(jk, jp))
        assert not op.any()
    # every build row is in the table or in the overflow rows, once
    live = np.asarray(tp).ravel() != 0
    assert np.count_nonzero(live) + np.count_nonzero(op.numpy()) == \
        np.count_nonzero(rp)


def test_global_ht_baseline_matches_jax(rng):
    rk = rng.randint(0, 1 << 20, 20_000).astype(np.int32)
    sk = rng.randint(0, 1 << 20, 30_000).astype(np.int32)
    rp = rng.randint(-50, 50, rk.size).astype(np.int32)
    sp = rng.randint(-50, 50, sk.size).astype(np.int32)
    t, j = _both(rk, rp, sk, sp)
    got = ph.global_ht_join_aggregate(*t, log_buckets=8)
    assert int(got) == int(jph.global_ht_join_aggregate(*j, log_buckets=8)) \
        == toracle.join_aggregate(rk, rp, sk, sp)


def test_global_ht_no_overflow_and_negative_keys(rng):
    """Unique build keys at load factor <= 0.5: the gather probe alone, with
    negative int32 keys (outside the engine's key domain, exact only on the
    direct path, so the build must have no overflow)."""
    rk = rng.permutation(1 << 15)[:10_000].astype(np.int32) - (1 << 14)
    sk = rk[rng.randint(0, rk.size, 25_000)].astype(np.int32)
    rp = rng.randint(-50, 50, rk.size).astype(np.int32)
    sp = rng.randint(-50, 50, sk.size).astype(np.int32)
    log_buckets = ph.default_log_buckets(rk.size, 8)
    assert log_buckets == max(1, math.ceil(math.log2(2 * rk.size / 8)))
    *_, n_ov = ph.global_ht_build(torch.from_numpy(rk), torch.from_numpy(rp),
                                  log_buckets, 8)
    assert int(n_ov) == 0, "test premise broken: fallback would run"
    t, j = _both(rk, rp, sk, sp)
    assert int(ph.global_ht_join_aggregate(*t)) == \
        int(jph.global_ht_join_aggregate(*j)) == \
        toracle.join_aggregate(rk, rp, sk, sp)


def test_global_ht_single_dominant_key(rng):
    """Every build row shares one key: one chain of n >> chain_cap; the
    overflow fallback (the banded engine) keeps it exact."""
    rk = np.full(5_000, 42, np.int32)
    sk = np.where(rng.rand(8_000) < 0.5, 42, 7).astype(np.int32)
    rp = _full(rng, rk.size)
    sp = _full(rng, sk.size)
    t, j = _both(rk, rp, sk, sp)
    assert int(ph.global_ht_join_aggregate(*t)) == \
        int(jph.global_ht_join_aggregate(*j)) == \
        toracle.join_aggregate(rk, rp, sk, sp)


@pytest.mark.parametrize("chunk", [1000, 1 << 20])
def test_global_ht_probe_matches_jax_in_any_chunks(rng, chunk):
    rk = rng.randint(0, 1 << 12, 4096).astype(np.int32)
    sk = rng.randint(0, 1 << 12, 8192).astype(np.int32)
    rp, sp = _full(rng, rk.size), _full(rng, sk.size)
    (_, _, tsk, tsp), (jrk, jrp, jsk, jsp) = _both(rk, rp, sk, sp)
    # JAX's table, carried across (slot order depends on the sort's ties)
    jk, jp, *_ = jph.global_ht_build(jrk, jrp, 10, 8)
    tk, tp = torch.tensor(np.asarray(jk)), torch.tensor(np.asarray(jp))
    got = ph.global_ht_probe_aggregate(tk, tp, tsk, tsp, 10, chunk=chunk)
    want = jph.global_ht_probe_aggregate(jk, jp, jsk, jsp, 10, chunk=chunk)
    assert int(got) == int(want)
