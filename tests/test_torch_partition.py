"""The port's radix partitioning (ops/partition.py), radix sort (ops/sort.py)
and numpy partition oracle against the JAX package's, on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu.ops import partition as jpart
from icde2019_gpu_join_tpu.ops.sort import radix_sort as jax_radix_sort
from icde2019_gpu_join_tpu.utils import oracle as joracle
from icde2019_gpu_join_tpu_torch.ops import partition
from icde2019_gpu_join_tpu_torch.ops.sort import radix_sort
from icde2019_gpu_join_tpu_torch.relation import PartitionedRelation
from icde2019_gpu_join_tpu_torch.utils import oracle as toracle


def _keys(rng, n, key_range, dup):
    if dup:
        return rng.randint(0, key_range, n).astype(np.int32)
    return rng.permutation(key_range)[:n].astype(np.int32)


def _full(rng, n):
    return rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)


def _pairs(keys, pays):
    keys, pays = np.asarray(keys), np.asarray(pays)
    order = np.lexsort((pays, keys))
    return keys[order], pays[order]


@pytest.mark.parametrize("bits,first_bit", [(4, 0), (9, 0), (7, 3), (13, 0),
                                            (0, 0), (12, 20)])
def test_histogram_matches_jax(rng, bits, first_bit):
    keys = np.concatenate([_keys(rng, 3000, 1 << 30, True),
                           np.array([0, 2**31 - 1], np.int32)])
    got = partition.histogram(torch.from_numpy(keys), bits, first_bit)
    want = jpart.histogram(jnp.asarray(keys), bits, first_bit)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,key_range,dup,bits,first_bit", [
    (4096, 1 << 14, False, 6, 0),
    (3000, 500, True, 5, 0),          # duplicate keys
    (5000, 1 << 30, True, 9, 4),      # first_bit > 0
    (2048, 1 << 31, True, 13, 0),     # full-range keys
    (1000, 1 << 12, True, 3, 29),     # the field wraps past bit 31
    (0, 10, True, 6, 0),              # empty input
])
def test_radix_partition_matches_jax(rng, n, key_range, dup, bits, first_bit):
    keys = _keys(rng, n, key_range, dup)
    pays = _full(rng, n)
    got = partition.radix_partition(torch.from_numpy(keys),
                                    torch.from_numpy(pays), bits, first_bit)
    want = jpart.radix_partition(jnp.asarray(keys), jnp.asarray(pays), bits,
                                 first_bit)
    assert isinstance(got, PartitionedRelation)
    assert (got.total_bits, got.first_bit) == (bits, first_bit)
    assert got.num_rows == n and got.num_partitions == 1 << bits
    for g, w in ((got.keys, want.keys), (got.counts, want.counts),
                 (got.offsets, want.offsets)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the sort is unstable in both packages: payloads per key as multisets
    for g, w in zip(_pairs(got.keys, got.payload), _pairs(want.keys, want.payload)):
        np.testing.assert_array_equal(g, w)
    # and the layout is the numpy oracle's
    ok, op, oc, oo = toracle.radix_partition(keys, pays, bits, first_bit)
    np.testing.assert_array_equal(got.keys.numpy(), ok)
    np.testing.assert_array_equal(got.counts.numpy(), oc)
    np.testing.assert_array_equal(got.offsets.numpy(), oo)


@pytest.mark.parametrize("bits,first_bit,per_pass", [(6, 0, 8), (11, 2, 5),
                                                     (8, 0, 3), (4, 28, 8)])
def test_radix_partition_multipass_matches_jax_exactly(rng, bits, first_bit,
                                                       per_pass):
    keys = _keys(rng, 4000, 1 << 16, True)   # many duplicates
    pays = _full(rng, 4000)
    got = partition.radix_partition_multipass(
        torch.from_numpy(keys), torch.from_numpy(pays), bits, first_bit,
        per_pass)
    want = jpart.radix_partition_multipass(
        jnp.asarray(keys), jnp.asarray(pays), bits, first_bit, per_pass)
    for g, w in ((got.keys, want.keys), (got.payload, want.payload),
                 (got.counts, want.counts), (got.offsets, want.offsets)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # stable: ties keep arrival order, which is the oracle's layout
    ok, op, _, _ = toracle.radix_partition(keys, pays, bits, first_bit)
    np.testing.assert_array_equal(got.payload.numpy(), op)


@pytest.mark.parametrize("bits,passes", [(32, 0), (16, 0), (9, 1), (0, 0),
                                         (32, 4), (20, 3), (12, 2)])
def test_radix_sort_matches_jax(rng, bits, passes):
    keys = np.concatenate([_full(rng, 3000), _keys(rng, 1000, 64, True)])
    pays = np.arange(keys.size, dtype=np.int32)
    gk, gp = radix_sort(torch.from_numpy(keys), torch.from_numpy(pays), bits,
                        passes)
    wk, wp = jax_radix_sort(jnp.asarray(keys), jnp.asarray(pays), bits, passes)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


@pytest.mark.parametrize("bits,first_bit", [(5, 0), (10, 7), (3, 30)])
def test_oracle_radix_partition_matches_jax_oracle(rng, bits, first_bit):
    keys = _keys(rng, 2000, 1 << 31, True)
    pays = _full(rng, 2000)
    for g, w in zip(toracle.radix_partition(keys, pays, bits, first_bit),
                    joracle.radix_partition(keys, pays, bits, first_bit)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(toracle.partition_ids(keys, bits, first_bit),
                                  joracle.partition_ids(keys, bits, first_bit))
    np.testing.assert_array_equal(toracle.rotate_keys(keys, bits, first_bit),
                                  joracle.rotate_keys(keys, bits, first_bit))


def test_partitioned_relation_carries_across_from_jax(rng):
    keys = _keys(rng, 1500, 1 << 12, True)
    pays = _full(rng, 1500)
    jp = jpart.radix_partition(jnp.asarray(keys), jnp.asarray(pays), 7, 1)
    tp = PartitionedRelation.from_numpy(
        *(np.asarray(a) for a in (jp.keys, jp.payload, jp.counts, jp.offsets)),
        jp.total_bits, jp.first_bit)
    assert (tp.num_rows, tp.num_partitions) == (1500, 128)
    assert (tp.total_bits, tp.first_bit) == (7, 1)
    assert tp.device == torch.device("cpu")
    for t, j in ((tp.keys, jp.keys), (tp.payload, jp.payload),
                 (tp.counts, jp.counts), (tp.offsets, jp.offsets)):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert "parts=2^7" in repr(tp)
