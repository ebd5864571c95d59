"""The port's two-level exchange (parallel/dist_join.py) against the JAX
package's on a 2 x 4 mesh, case for case with the two-level tests of
tests/test_distributed.py: aggregates and overflow bit-exact, and equal to
the oracle."""

import numpy as np
import pytest

from icde2019_gpu_join_tpu import datagen as jdatagen
from icde2019_gpu_join_tpu_torch.utils import oracle
from tests.conftest import make_tables
from tests.test_torch_dist_join import run_both


@pytest.mark.parametrize("slack", [None, 3.0])
def test_two_level_exchange(rng, slack):
    arrays = make_tables(rng, n_r=4096, n_s=8192, dup_build=True)
    agg, ov = run_both("distributed_join_aggregate_2level", arrays, nd=(2, 4),
                       slack=slack)
    assert ov == 0 and agg == oracle.join_aggregate(*arrays)


@pytest.mark.parametrize("seed", range(4))
def test_distributed_2level_fuzz_vs_host_oracle(seed):
    """Exact caps + auto heavy split over the adversarial families:
    duplicate-heavy, full non-negative domain, 40% of S on one key,
    key-domain boundaries; full-range payloads."""
    g = np.random.default_rng(5000 + seed)
    n_r, n_s = 4096, 16384
    if seed == 0:
        rk = g.integers(0, 500, n_r).astype(np.int32)
        sk = g.integers(0, 500, n_s).astype(np.int32)
    elif seed == 1:
        rk = g.integers(0, 2**31, n_r).astype(np.int64).astype(np.int32)
        sk = g.integers(0, 2**31, n_s).astype(np.int64).astype(np.int32)
    elif seed == 2:
        rk = g.permutation(n_r).astype(np.int32)
        sk = np.where(g.random(n_s) < 0.4, rk[3],
                      rk[g.integers(0, n_r, n_s)]).astype(np.int32)
    else:
        pool = np.array([0, 1, 2, 42, 2**31 - 2, 2**31 - 1], np.int32)
        rk = pool[g.integers(0, pool.size, n_r)]
        sk = pool[g.integers(0, pool.size, n_s)]
    rp = g.integers(-2**31, 2**31, n_r).astype(np.int64).astype(np.int32)
    sp = g.integers(-2**31, 2**31, n_s).astype(np.int64).astype(np.int32)
    agg, ov, loads = run_both("distributed_join_aggregate_2level",
                              (rk, rp, sk, sp), nd=(2, 4), return_loads=True)
    assert ov == 0 and agg == jdatagen.host_oracle_aggregate(rk, rp, sk, sp)
    assert loads.sum() == n_s
