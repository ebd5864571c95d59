"""The port's ops/groupby.py against the JAX package's and against
`oracle.groupby_aggregate` on the same numpy inputs (mirrors
tests/test_ops.py test_groupby / test_groupby_onehot_counts), bit for bit;
the one-hot path inside its documented domain, |vals| < 2^13."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu.ops import groupby as jgb
from icde2019_gpu_join_tpu.utils import oracle as joracle
from icde2019_gpu_join_tpu_torch.ops import groupby as tgb
from icde2019_gpu_join_tpu_torch.utils import oracle as toracle


def _check(got, want, ref):
    for g, w, r in zip(got, want, ref):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert np.array_equal(g.numpy(), r)


@pytest.mark.parametrize("n,groups", [(1, 4), (5000, 64), (1 << 14, 1000),
                                      (4096, 1)])
def test_sort_path_equals_jax_and_oracle(rng, n, groups):
    g = rng.randint(0, groups, n).astype(np.int32)
    v = rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    got = tgb.groupby_count_sum(torch.from_numpy(g), torch.from_numpy(v), groups)
    want = jgb.groupby_count_sum(jnp.asarray(g), jnp.asarray(v), groups)
    _check(got, want, toracle.groupby_aggregate(g, v, groups))


def test_sort_path_leaves_empty_groups_zero(rng):
    g = (rng.randint(0, 8, 3000) * 2).astype(np.int32)   # odd groups empty
    v = rng.randint(-100, 100, 3000).astype(np.int32)
    cnt, sums = tgb.groupby_count_sum(torch.from_numpy(g), torch.from_numpy(v), 16)
    assert cnt[1::2].eq(0).all() and sums[1::2].eq(0).all()
    assert int(cnt.sum()) == 3000


@pytest.mark.parametrize("n,groups", [(4096, 32), (5000, 64), (2047, 3),
                                      (1 << 16, 200)])
def test_onehot_path_equals_jax_and_oracle(rng, n, groups):
    g = rng.randint(0, groups, n).astype(np.int32)
    v = rng.randint(-(2**13) + 1, 2**13, n).astype(np.int32)
    got = tgb.groupby_count_sum_onehot(torch.from_numpy(g), torch.from_numpy(v),
                                       groups)
    want = jgb.groupby_count_sum_onehot(jnp.asarray(g), jnp.asarray(v), groups)
    _check(got, want, toracle.groupby_aggregate(g, v, groups))


def test_onehot_batches_cover_every_block(rng, monkeypatch):
    """Several batches of blocks (the batch cut to 3 blocks) give what one
    batch gives."""
    g = rng.randint(0, 10, 20000).astype(np.int32)
    v = rng.randint(0, 2**13, 20000).astype(np.int32)
    whole = tgb.groupby_count_sum_onehot(torch.from_numpy(g), torch.from_numpy(v), 10)
    monkeypatch.setattr(tgb, "_ONEHOT_ELEMENTS", 3 * tgb._BLOCK * 10)
    parts = tgb.groupby_count_sum_onehot(torch.from_numpy(g), torch.from_numpy(v), 10)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


def test_onehot_pins_full_fp32_and_restores_the_setting():
    m = torch.backends.cuda.matmul
    name = "fp32_precision" if hasattr(m, "fp32_precision") else "allow_tf32"
    old = getattr(m, name)
    tf32 = "tf32" if name == "fp32_precision" else True
    setattr(m, name, tf32)
    try:
        with tgb._ieee_fp32_matmul():
            assert getattr(m, name) in ("ieee", False)
        assert getattr(m, name) == tf32
    finally:
        setattr(m, name, old)


def test_port_oracle_groupby_and_filter_equal_jax(rng):
    g = rng.randint(0, 50, 3000).astype(np.int32)
    v = rng.randint(-2**31, 2**31, 3000, dtype=np.int64).astype(np.int32)
    for a, b in zip(toracle.groupby_aggregate(g, v, 50),
                    joracle.groupby_aggregate(g, v, 50)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(toracle.filter_rows(g, v, 10, 30),
                    joracle.filter_rows(g, v, 10, 30)):
        assert np.array_equal(a, b)
