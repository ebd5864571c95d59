"""The PRPD heavy split of the port's distributed join against the JAX
package's, case for case with the heavy-split tests of
tests/test_distributed.py: aggregates, overflow and executed per-rank loads
equal, the split path taken (or not) as in JAX, loads within 2x of the
uniform share with the split and over it without."""

import jax.numpy as jnp
import numpy as np
import pytest

from icde2019_gpu_join_tpu.parallel import plan as jplan
from icde2019_gpu_join_tpu.parallel.mesh import make_mesh as jmesh
from icde2019_gpu_join_tpu_torch.parallel import dist_join as tdj
from icde2019_gpu_join_tpu_torch.utils import oracle
from tests.conftest import make_tables
from tests.test_torch_dist_join import run_both


@pytest.fixture
def heavy_calls(monkeypatch):
    """How often each heavy-split rank function ran (all ranks counted)."""
    calls = {}
    for name in ("_local_heavy_segmented", "_two_level_heavy_local"):
        fn = getattr(tdj, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tdj, name, spy)
    return calls


def dominant(rng, n_r=2048, n_s=16384, hot_at=13, dups=(), frac=0.5):
    rk = rng.permutation(n_r).astype(np.int32)
    hot = int(rk[hot_at])
    for i in dups:
        rk[i] = hot
    rp = rng.randint(1, 1000, n_r).astype(np.int32)
    sk = np.where(rng.rand(n_s) < frac, hot,
                  rk[rng.randint(0, n_r, n_s)]).astype(np.int32)
    sp = rng.randint(1, 1000, n_s).astype(np.int32)
    return rk, rp, sk, sp


def test_heavy_split_single_dominant_key(rng, heavy_calls):
    """One key at 50% of S, duplicated in R: the split is planned, taken,
    and the result bit-exact."""
    arrays = dominant(rng, dups=(100, 200))
    agg, ov = run_both("distributed_join_segmented", arrays, num_segments=4)
    assert ov == 0 and agg == oracle.join_aggregate(*arrays)
    assert heavy_calls.get("_local_heavy_segmented") == 8


def test_heavy_split_adversarial_zipf(rng):
    """Zipf z=1.6 probe keys (top key about 30%) through the auto split."""
    n_r, n_s = 4096, 32768
    rk = rng.permutation(n_r).astype(np.int32)
    rp = rng.randint(1, 1000, n_r).astype(np.int32)
    idx = (np.random.default_rng(7).zipf(1.6, n_s) - 1) % n_r
    sk = rk[idx].astype(np.int32)
    sp = rng.randint(1, 1000, n_s).astype(np.int32)
    agg, ov = run_both("distributed_join_segmented", (rk, rp, sk, sp),
                       num_segments=4)
    assert ov == 0 and agg == oracle.join_aggregate(rk, rp, sk, sp)


@pytest.mark.parametrize("entry,fn,nd", [
    ("distributed_join_segmented", "_local_heavy_segmented", 8),
    ("distributed_join_aggregate_2level", "_two_level_heavy_local", (2, 4))])
def test_uniform_keys_take_no_split(rng, heavy_calls, entry, fn, nd):
    arrays = make_tables(rng, n_r=4096, n_s=16384, dup_build=True)
    agg, ov = run_both(entry, arrays, nd=nd)
    assert ov == 0 and agg == oracle.join_aggregate(*arrays)
    assert fn not in heavy_calls


def test_heavy_split_executed_balance(rng):
    """Executed loads equal JAX's and the plan's projection, sum to |S|
    and stay within 2x uniform; without the split one rank takes over 2x."""
    rk, rp, sk, sp = dominant(rng)
    n_s, nd = sk.size, 8
    want = oracle.join_aggregate(rk, rp, sk, sp)
    hplan = jplan.plan_heavy_split(jnp.asarray(rk), jnp.asarray(sk), jmesh(nd),
                                   "x", nd, segments=4)
    agg, ov, loads = run_both("distributed_join_segmented", (rk, rp, sk, sp),
                              num_segments=4, return_loads=True)
    assert ov == 0 and agg == want
    assert loads.sum() == n_s
    np.testing.assert_array_equal(loads, hplan.load_rows)
    assert loads.max() <= 2.0 * n_s / nd
    agg0, ov0, loads0 = run_both("distributed_join_segmented", (rk, rp, sk, sp),
                                 num_segments=4, split_heavy=False,
                                 return_loads=True)
    assert ov0 == 0 and agg0 == want and loads0.sum() == n_s
    assert loads0.max() > 2.0 * n_s / nd


def test_heavy_split_2level_dominant_key(rng, heavy_calls):
    rk, rp, sk, sp = dominant(rng, hot_at=77, dups=(300,))
    n_s = sk.size
    want = oracle.join_aggregate(rk, rp, sk, sp)
    agg, ov, loads = run_both("distributed_join_aggregate_2level",
                              (rk, rp, sk, sp), nd=(2, 4), return_loads=True)
    assert ov == 0 and agg == want
    assert heavy_calls.get("_two_level_heavy_local") == 8
    assert loads.sum() == n_s and loads.max() <= 2.0 * n_s / 8
    agg0, ov0, loads0 = run_both("distributed_join_aggregate_2level",
                                 (rk, rp, sk, sp), nd=(2, 4),
                                 split_heavy=False, return_loads=True)
    assert ov0 == 0 and agg0 == want and loads0.max() > 2.0 * n_s / 8


def test_forced_split_on_uniform_keys(rng, heavy_calls):
    """split_heavy=True plans the fine split on any input; with nothing
    heavy it falls through to the normal pipeline, as in JAX."""
    arrays = make_tables(rng, n_r=2048, n_s=8192, dup_build=True)
    agg, ov = run_both("distributed_join_segmented", arrays, num_segments=4,
                       split_heavy=True, return_loads=True)[:2]
    assert ov == 0 and agg == oracle.join_aggregate(*arrays)
    assert "_local_heavy_segmented" not in heavy_calls
