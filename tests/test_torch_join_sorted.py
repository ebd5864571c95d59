"""The port's sort-merge join (ops/join_sorted.py) against the JAX package's,
on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu.ops import join_sorted as jjs
from icde2019_gpu_join_tpu_torch.ops import join_sorted
from icde2019_gpu_join_tpu_torch.utils import oracle as toracle
from tests.conftest import make_tables


def _tables(rng, kind):
    if kind == "pkfk":
        return make_tables(rng, n_r=2000, n_s=8000)
    if kind == "dup":
        return make_tables(rng, n_r=3000, n_s=9000, dup_build=True)
    # full-range keys, negative ones included: uint32 order
    rk = rng.randint(-2**31, 2**31, 3000, dtype=np.int64).astype(np.int32)
    sk = np.concatenate([rk[rng.randint(0, 3000, 6000)],
                         rng.randint(-2**31, 2**31, 2000, dtype=np.int64)
                         ]).astype(np.int32)
    rp = rng.randint(-2**31, 2**31, 3000, dtype=np.int64).astype(np.int32)
    sp = rng.randint(-2**31, 2**31, 8000, dtype=np.int64).astype(np.int32)
    return rk, rp, sk, sp


@pytest.mark.parametrize("kind", ["pkfk", "dup", "full_range"])
def test_sort_merge_aggregate_and_count_match_jax(rng, kind):
    rk, rp, sk, sp = _tables(rng, kind)
    t = [torch.from_numpy(a) for a in (rk, rp, sk, sp)]
    j = [jnp.asarray(a) for a in (rk, rp, sk, sp)]
    got = join_sorted.sort_merge_aggregate(*t)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(jjs.sort_merge_aggregate(*j)) == \
        toracle.join_aggregate(rk, rp, sk, sp)
    cnt = join_sorted.sort_merge_count(t[0], t[2])
    assert cnt.dtype == torch.int32
    assert int(cnt) == int(jjs.sort_merge_count(j[0], j[2])) == \
        toracle.join_count(rk, sk)


@pytest.mark.parametrize("chunk", [1, 777, 1 << 24])
def test_sort_merge_probe_chunks_do_not_change_the_sum(rng, monkeypatch, chunk):
    rk, rp, sk, sp = _tables(rng, "dup")
    t = [torch.from_numpy(a) for a in (rk, rp, sk, sp)]
    monkeypatch.setattr(join_sorted, "_PROBE_CHUNK", chunk)
    if chunk < sk.size:
        monkeypatch.setattr(jjs, "_PROBE_CHUNK", chunk)
    want = int(jjs.sort_merge_aggregate(*map(jnp.asarray, (rk, rp, sk, sp))))
    assert int(join_sorted.sort_merge_aggregate(*t)) == want


@pytest.mark.parametrize("kind", ["pkfk", "full_range"])
def test_sort_merge_lookup_matches_jax(rng, kind):
    rk, _, sk, _ = _tables(rng, kind)
    rk = np.unique(rk)[rng.permutation(np.unique(rk).size)]   # unique build
    idx, hit = join_sorted.sort_merge_lookup(torch.from_numpy(rk),
                                             torch.from_numpy(sk))
    jidx, jhit = jjs.sort_merge_lookup(jnp.asarray(rk), jnp.asarray(sk))
    assert idx.dtype == torch.int32 and hit.dtype == torch.bool
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    h = hit.numpy()
    np.testing.assert_array_equal(rk[idx.numpy()[h]], sk[h])
    assert not np.isin(sk[~h], rk).any()
