"""The port's ops/scan.py against the JAX package's on the same numpy
inputs: int32 results bit for bit (values that wrap mod 2^32, an empty and
a one-row input), uint32 results through their bits, float32 scans within
1e-6 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu.ops import scan as jscan
from icde2019_gpu_join_tpu_torch.ops import scan as tscan

SCANS = ("exclusive_scan", "offsets_from_counts", "wrap_prefix_u32",
         "associative_scan_sum")


def _wrapping(rng, n):
    """Full-range int32 values: every running sum wraps."""
    return rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)


def _bits(a: np.ndarray) -> np.ndarray:
    """int32 view of a JAX int32 or uint32 result."""
    return a.view(np.int32)


@pytest.mark.parametrize("n", [0, 1, 2, 500])
@pytest.mark.parametrize("name", SCANS)
def test_scans_equal_jax_bit_for_bit(rng, name, n):
    x = _wrapping(rng, n)
    want = np.asarray(getattr(jscan, name)(jnp.asarray(x)))
    got = getattr(tscan, name)(torch.from_numpy(x))
    assert got.dtype == torch.int32
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), _bits(want))


@pytest.mark.parametrize("name", ["exclusive_scan", "offsets_from_counts"])
def test_counts_scans_keep_small_counts_exact(rng, name):
    counts = rng.randint(0, 5000, 4096).astype(np.int32)
    want = np.asarray(getattr(jscan, name)(jnp.asarray(counts)))
    got = getattr(tscan, name)(torch.from_numpy(counts)).numpy()
    assert np.array_equal(got, want)
    assert got[-1] == (counts.sum() if name == "offsets_from_counts"
                       else counts[:-1].sum())


@pytest.mark.parametrize("n", [1, 500])
@pytest.mark.parametrize("func_id", [0, 1, 2])
def test_aggregate_equals_jax(rng, func_id, n):
    x = _wrapping(rng, n)
    want = int(jscan.aggregate(jnp.asarray(x), func_id))
    got = tscan.aggregate(torch.from_numpy(x), func_id)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == want


def test_aggregate_rejects_unknown_func_id():
    with pytest.raises(ValueError, match="unknown funcId 3"):
        tscan.aggregate(torch.zeros(4, dtype=torch.int32), 3)


@pytest.mark.parametrize("segments", [1, 9, 64])
def test_segmented_sum_u32_equals_jax(rng, segments):
    n = 5000
    x = _wrapping(rng, n)
    cuts = np.sort(rng.randint(0, n + 1, segments - 1))
    off = np.concatenate([[0], cuts, [n]]).astype(np.int32)   # empty ones too
    want = np.asarray(jscan.segmented_sum_u32(jnp.asarray(x), jnp.asarray(off)))
    got = tscan.segmented_sum_u32(torch.from_numpy(x), torch.from_numpy(off))
    assert want.dtype == np.uint32 and got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)
    # and each segment's sum mod 2^32, from numpy
    ref = [np.uint32(x[a:b].astype(np.uint64).sum() & 0xFFFFFFFF)
           for a, b in zip(off[:-1], off[1:])]
    assert np.array_equal(got.numpy().view(np.uint32), np.array(ref, np.uint32))


@pytest.mark.parametrize("n", [1, 500])
@pytest.mark.parametrize("name", ["associative_scan_sum", "exclusive_scan"])
def test_float32_scans_within_1e6_relative(rng, name, n):
    x = rng.rand(n).astype(np.float32) + np.float32(0.5)
    want = np.asarray(getattr(jscan, name)(jnp.asarray(x)))
    got = getattr(tscan, name)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_int32_scans_wrap_like_jax_at_2_to_14(rng):
    """The non-associative scans at 2^14 rows (JAX's associative scan
    compiles a graph per length, so it stays at the small sizes above)."""
    x = _wrapping(rng, 1 << 14)
    for name in SCANS[:3]:
        want = np.asarray(getattr(jscan, name)(jnp.asarray(x)))
        got = getattr(tscan, name)(torch.from_numpy(x))
        assert np.array_equal(got.numpy(), _bits(want))


def test_scan_values_and_lengths():
    x = torch.arange(10, dtype=torch.int32)
    assert tscan.exclusive_scan(x).tolist() == [0, 0, 1, 3, 6, 10, 15, 21, 28, 36]
    assert tscan.offsets_from_counts(x).shape == (11,)
    assert tscan.wrap_prefix_u32(x).shape == (11,)
