"""The port's host runtime (`datagen.host_partition`, `staging_copy`,
`knapsack_batches`) against the JAX package's on the same numpy inputs, and
against the port's numpy oracle (mirrors tests/test_host_engine.py). Both
packages build the same `host_engine.cpp`, so the native results are equal
array for array; the numpy fallbacks are equal too."""

import numpy as np
import pytest

from icde2019_gpu_join_tpu import datagen as jdatagen
from icde2019_gpu_join_tpu_torch import datagen as tdatagen
from icde2019_gpu_join_tpu_torch.utils import oracle as toracle


@pytest.fixture(scope="module")
def native():
    if tdatagen.native_lib() is None or jdatagen.native_lib() is None:
        pytest.skip("native host library unavailable")
    return tdatagen


def _no_native(monkeypatch):
    monkeypatch.setattr(tdatagen, "native_lib", lambda: None)
    monkeypatch.setattr(jdatagen, "native_lib", lambda: None)


def _partition_inputs(bits, first_bit, n):
    rng = np.random.RandomState(bits * 100 + first_bit)
    keys = rng.randint(-(1 << 31), 1 << 31, n).astype(np.int32)
    pays = rng.randint(-1000, 1000, n).astype(np.int32)
    return keys, pays


def _sorted_rows(k, p):
    rows = np.stack([k, p], 1)
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


@pytest.mark.parametrize("bits,first_bit,n", [
    (4, 0, 100_000),     # write-combining path (16 partitions)
    (8, 0, 300_000),     # its boundary (256 partitions)
    (10, 3, 200_000),    # plain scatter (1024 partitions)
    (4, 0, 63),          # partial write-combining buffers only
    (4, 28, 10_000),     # high radix field
    (4, 0, 0),           # empty relation
])
def test_host_partition_matches_jax_and_oracle(native, bits, first_bit, n):
    keys, pays = _partition_inputs(bits, first_bit, n)
    got = native.host_partition(keys, pays, bits, first_bit)
    want = jdatagen.host_partition(keys, pays, bits, first_bit)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    ok, op, counts, offsets = got
    ek, ep, ec, eo = toracle.radix_partition(keys, pays, bits, first_bit)
    np.testing.assert_array_equal(counts, ec)
    np.testing.assert_array_equal(offsets, eo)
    for p in range(1 << bits):   # thread regions reorder rows within a part
        lo, hi = int(offsets[p]), int(offsets[p + 1])
        np.testing.assert_array_equal(_sorted_rows(ok[lo:hi], op[lo:hi]),
                                      _sorted_rows(ek[lo:hi], ep[lo:hi]))


def test_host_partition_into_caller_buffers(native):
    keys, pays = _partition_inputs(4, 0, 50_000)
    out = (np.empty_like(keys), np.empty_like(pays))
    ok, op, counts, offsets = native.host_partition(keys, pays, 4, out=out)
    assert ok is out[0] and op is out[1]
    for g, w in zip((ok, op, counts, offsets),
                    jdatagen.host_partition(keys, pays, 4)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="out arrays"):
        native.host_partition(keys, pays, 4, out=(out[0][:-1], out[1]))
    with pytest.raises(ValueError, match="out arrays"):
        native.host_partition(keys, pays, 4,
                              out=(out[0].astype(np.int64), out[1]))


def test_host_partition_single_thread_stable(native):
    """With one thread the scatter is stable: rows of a partition keep input
    order."""
    rng = np.random.RandomState(0)
    keys = rng.randint(0, 1 << 20, 50_000).astype(np.int32)
    pays = np.arange(keys.size, dtype=np.int32)
    ok, op, _, _ = native.host_partition(keys, pays, 4, 0, num_threads=1)
    order = np.argsort(keys & 15, kind="stable")
    np.testing.assert_array_equal(ok, keys[order])
    np.testing.assert_array_equal(op, pays[order])
    jk, jp, _, _ = jdatagen.host_partition(keys, pays, 4, 0, num_threads=1)
    np.testing.assert_array_equal(ok, jk)
    np.testing.assert_array_equal(op, jp)


def test_host_partition_fallback_is_the_oracle(monkeypatch):
    _no_native(monkeypatch)
    keys, pays = _partition_inputs(6, 2, 20_000)
    out = (np.empty_like(keys), np.empty_like(pays))
    got = tdatagen.host_partition(keys, pays, 6, 2, out=out)
    assert got[0] is out[0]
    for g, w, o in zip(got, jdatagen.host_partition(keys, pays, 6, 2),
                       toracle.radix_partition(keys, pays, 6, 2)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, o)


@pytest.mark.parametrize("seed,n,cap", [(1, 40, 5), (2, 16, 5), (3, 7, 3)])
def test_knapsack_matches_jax(native, seed, n, cap):
    gains = np.random.RandomState(seed).uniform(0.1, 3.0, n)
    batch_of = native.knapsack_batches(gains, cap)
    np.testing.assert_array_equal(batch_of, jdatagen.knapsack_batches(gains, cap))
    assert batch_of.dtype == np.int32 and batch_of.min() >= 0
    weights = np.maximum(1, np.ceil(gains)).astype(np.int64)
    for b in range(batch_of.max() + 1):
        members = np.nonzero(batch_of == b)[0]
        assert members.size > 0, f"empty batch {b}"
        if members.size > 1:   # a lone item may exceed the capacity
            assert weights[members].sum() <= cap


@pytest.mark.parametrize("gains,cap,want", [
    ([0, 0, 1.2, 0.9, 3.0, 0], 5, [2, 3, 0, 1, 0, 4]),   # gain 0: alone
    ([0.0] * 16, 5, list(range(16))),                   # an empty R side
    ([10.0, 0.5, 0.5], 2, [0, 1, 1]),                   # one oversized item
    ([], 5, []),
])
def test_knapsack_edge_cases_match_jax(native, gains, cap, want):
    gains = np.asarray(gains, np.float64)
    got = native.knapsack_batches(gains, cap)
    np.testing.assert_array_equal(got, jdatagen.knapsack_batches(gains, cap))
    np.testing.assert_array_equal(got, want)


def test_knapsack_fallback_matches_jax(monkeypatch):
    _no_native(monkeypatch)
    for seed in range(3):
        gains = np.random.RandomState(seed).uniform(0.0, 4.0, 23)
        gains[::5] = 0
        np.testing.assert_array_equal(tdatagen.knapsack_batches(gains, 5),
                                      jdatagen.knapsack_batches(gains, 5))


@pytest.mark.parametrize("n", [0, 1, 31, 4097, 1 << 20])
def test_staging_copy_is_exact(native, n):
    src = np.random.RandomState(n).randint(-2**31, 2**31, n,
                                           dtype=np.int64).astype(np.int32)
    dst = np.full(n + 5, 7, np.int32)
    native.staging_copy(dst[:n], src)
    np.testing.assert_array_equal(dst[:n], src)
    assert (dst[n:] == 7).all()   # nothing past the slice is touched
    jdst = np.full(n + 5, 7, np.int32)
    jdatagen.staging_copy(jdst[:n], src)
    np.testing.assert_array_equal(dst, jdst)


def test_staging_copy_size_mismatch_falls_back_to_copyto(native):
    """Byte counts that differ take np.copyto, as in JAX (here int64 into
    int32, cast as numpy casts)."""
    src = np.arange(-500, 500, dtype=np.int64)
    dst, jdst = np.zeros(1000, np.int32), np.zeros(1000, np.int32)
    native.staging_copy(dst, src)
    jdatagen.staging_copy(jdst, src)
    np.testing.assert_array_equal(dst, src)
    np.testing.assert_array_equal(dst, jdst)
    with pytest.raises(ValueError):
        native.staging_copy(np.zeros(3, np.int32), np.zeros(4, np.int32))


def test_staging_copy_without_native(monkeypatch):
    _no_native(monkeypatch)
    src = np.arange(100, dtype=np.int32)
    dst = np.zeros(100, np.int32)
    tdatagen.staging_copy(dst, src)
    np.testing.assert_array_equal(dst, src)
