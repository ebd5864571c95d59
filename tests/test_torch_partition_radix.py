"""The port's ops/partition_radix.py against the JAX package's, on the same
seeded numpy inputs (the cases of tests/test_partition_radix.py).

Keys come out equal element for element; payloads equal as multisets within
each run of equal keys (both chunk sorts are unstable); counts and block
offsets equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu.ops import partition_radix as jpr
from icde2019_gpu_join_tpu_torch.ops import partition_radix as tpr

SENT = 0x7FFFFFFF


def same_runs(got_k, got_v, want_k, want_v):
    """Keys equal element for element; within each run of equal consecutive
    keys the payload multisets equal."""
    got_k, got_v, want_k, want_v = (np.asarray(a).reshape(-1) for a in
                                    (got_k, got_v, want_k, want_v))
    np.testing.assert_array_equal(got_k, want_k)
    run = np.concatenate([[0], np.cumsum(want_k[1:] != want_k[:-1])])
    np.testing.assert_array_equal(got_v[np.lexsort((got_v, run))],
                                  want_v[np.lexsort((want_v, run))])


def check_group(keys, pays, bits, chunk=1024, cap_blocks=None):
    g = tpr.radix_group(torch.from_numpy(keys), torch.from_numpy(pays), bits,
                        chunk, cap_blocks)
    j = jpr.radix_group(jnp.asarray(keys), jnp.asarray(pays), bits, chunk,
                        cap_blocks)
    same_runs(g.keys, g.pays, j.keys, j.pays)
    np.testing.assert_array_equal(g.counts.numpy(), np.asarray(j.counts))
    np.testing.assert_array_equal(g.block_offsets.numpy(),
                                  np.asarray(j.block_offsets))
    # and what the JAX test asserts of it: per partition the input multiset
    gk, gv, bo = g.keys.numpy(), g.pays.numpy(), g.block_offsets.numpy()
    u = keys.view(np.uint32) ^ np.uint32(0x80000000)
    pid = (u >> np.uint32(32 - bits)).astype(np.int64)
    for p in range(1 << bits):
        seg_k, seg_v = gk[bo[p] * 128:bo[p + 1] * 128], gv[bo[p] * 128:bo[p + 1] * 128]
        m = seg_k != SENT
        assert m.sum() == (pid == p).sum()
        np.testing.assert_array_equal(seg_v[~m], 0)
    return g


@pytest.mark.parametrize("bits", [2, 3, 5])
def test_radix_group_uniform_matches_jax(rng, bits):
    n = 20_000
    keys = rng.randint(-(1 << 31), 1 << 31, n).astype(np.int32)
    keys = np.where(keys == SENT, 0, keys).astype(np.int32)
    pays = rng.randint(-100, 100, n).astype(np.int32)
    check_group(keys, pays, bits)


def test_radix_group_skewed_matches_jax(rng):
    n = 30_000
    keys = np.concatenate([
        np.full(n // 2, 12345, np.int32),
        rng.randint(0, 1 << 10, n - n // 2).astype(np.int32),
    ])
    rng.shuffle(keys)
    pays = rng.randint(1, 50, n).astype(np.int32)
    check_group(keys, pays, 3)


@pytest.mark.parametrize("n", [1, 127, 128, 129, 1023, 1025])
def test_radix_group_edge_sizes_match_jax(rng, n):
    keys = rng.randint(0, 1 << 20, n).astype(np.int32)
    pays = np.arange(n, dtype=np.int32)
    check_group(keys, pays, 2, chunk=512)


@pytest.mark.parametrize("extra", [1, 37])
def test_radix_group_short_repeats_pad_with_the_last_value(rng, extra):
    """cap_blocks above the blocks laid out: JAX's total_repeat_length fills
    the tail with the last repeated value, which the port pads explicitly;
    the tail blocks are masked to sentinels either way."""
    n = 5000
    keys = rng.randint(0, 1 << 20, n).astype(np.int32)
    pays = rng.randint(1, 1000, n).astype(np.int32)
    need = int(tpr.grouped_block_counts(torch.from_numpy(keys), 3, 1024).sum())
    g = check_group(keys, pays, 3, cap_blocks=need + extra)
    assert g.keys.shape[0] == (need + extra) * 128
    assert (g.keys[need * 128:] == SENT).all() and (g.pays[need * 128:] == 0).all()


def test_repeat_to_is_jax_total_repeat_length():
    values = torch.tensor([5, 6, 7, 8], dtype=torch.int32)
    repeats = torch.tensor([2, 0, 1, 0])
    for length in (1, 3, 6):
        want = np.asarray(jnp.repeat(jnp.asarray(values.numpy()),
                                     jnp.asarray(repeats.numpy()),
                                     total_repeat_length=length))
        np.testing.assert_array_equal(
            tpr._repeat_to(values, repeats, length).numpy(), want)


@pytest.mark.parametrize("bits,chunk", [(2, 512), (3, 1024), (5, 4096)])
def test_grouped_block_counts_match_jax(rng, bits, chunk):
    keys = rng.randint(-(1 << 31), 1 << 31, 9001).astype(np.int32)
    got = tpr.grouped_block_counts(torch.from_numpy(keys), bits, chunk)
    want = jpr.grouped_block_counts(jnp.asarray(keys), bits, chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    g = tpr.radix_group(torch.from_numpy(keys), torch.ones(9001, dtype=torch.int32),
                        bits, chunk)
    np.testing.assert_array_equal(got.numpy(), np.diff(g.block_offsets.numpy()))


def test_radix_sort_via_grouping_matches_jax(rng):
    n = 50_000
    keys = rng.randint(-(1 << 31), 1 << 31 - 1, n).astype(np.int32)
    keys = np.where(keys == SENT, 0, keys).astype(np.int32)
    pays = rng.randint(0, 1 << 30, n).astype(np.int32)
    ks, vs, total, ov = tpr.radix_sort_via_grouping(
        torch.from_numpy(keys), torch.from_numpy(pays), bits=3, chunk=1024)
    jks, jvs, jtotal, jov = jpr.radix_sort_via_grouping(
        jnp.asarray(keys), jnp.asarray(pays), bits=3, chunk=1024)
    assert int(ov) == int(jov) == 0 and int(total) == int(jtotal) == n
    same_runs(ks, vs, jks, jvs)
    got_k = ks.numpy()[ks.numpy() != SENT]
    np.testing.assert_array_equal(got_k, np.sort(keys))


def test_radix_sort_overflow_flag_matches_jax():
    keys = np.zeros(10_000, np.int32)   # everything in one partition
    pays = np.arange(10_000, dtype=np.int32)
    _, _, _, ov = tpr.radix_sort_via_grouping(
        torch.from_numpy(keys), torch.from_numpy(pays), bits=4, chunk=1024,
        lmax_blocks=4)
    _, _, _, jov = jpr.radix_sort_via_grouping(
        jnp.asarray(keys), jnp.asarray(pays), bits=4, chunk=1024,
        lmax_blocks=4)
    assert int(ov) == int(jov) > 0
