"""The port's ops/bits.py against the JAX package's, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu.ops import bits as jbits
from icde2019_gpu_join_tpu_torch.ops import bits as tbits

# (total_bits, first_bit); (7, 25) rotates by a full word
GRID = [(0, 0), (1, 0), (4, 0), (8, 3), (13, 0), (13, 5), (16, 16), (22, 4),
        (31, 0), (7, 25), (0, 31)]


def _keys():
    rng = np.random.RandomState(7)
    k = rng.randint(-2**31, 2**31, 2000, dtype=np.int64).astype(np.int32)
    edge = np.array([0, 1, -1, -2, 2**31 - 1, -2**31, 2**30, 127, 128],
                    np.int32)
    return np.concatenate([k, edge])


def _both(name, keys, *args):
    want = np.asarray(getattr(jbits, name)(jnp.asarray(keys), *args))
    got = getattr(tbits, name)(torch.from_numpy(keys), *args)
    assert got.dtype == torch.int32
    return want, got.numpy()


@pytest.mark.parametrize("name", ["rotate_keys", "unrotate_keys", "partition_ids"])
@pytest.mark.parametrize("total_bits,first_bit", GRID)
def test_bits_match_jax(name, total_bits, first_bit):
    want, got = _both(name, _keys(), total_bits, first_bit)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("total_bits,first_bit", GRID)
def test_unrotate_inverts_rotate(total_bits, first_bit):
    k = torch.from_numpy(_keys())
    sv = tbits.rotate_keys(k, total_bits, first_bit)
    assert torch.equal(tbits.unrotate_keys(sv, total_bits, first_bit), k)


@pytest.mark.parametrize("total_bits", [1, 4, 13])
def test_partition_boundaries_match_jax(total_bits):
    want = np.asarray(jbits.partition_boundaries(total_bits))
    got = tbits.partition_boundaries(total_bits, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrap_i32_reduces_mod_2_32():
    x = torch.tensor([0, 2**31, 2**32 - 1, -1, -2**31 - 1, 3 * 2**32 + 5])
    want = np.array([0, -2**31, -1, -1, 2**31 - 1, 5], np.int32)
    np.testing.assert_array_equal(tbits.wrap_i32(x).numpy(), want)
