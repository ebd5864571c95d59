"""The port's distributed join (parallel/dist_join.py) against the JAX
package's, case for case with tests/test_distributed.py: the same seeded
numpy inputs through JAX over 8 virtual CPU devices and through the port over
an 8-rank (or 1-rank) thread mesh on the CPU. Aggregates and overflow
bit-exact, executed loads equal, and both equal to the oracle."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu import datagen as jdatagen
from icde2019_gpu_join_tpu.parallel import dist_join as jdj
from icde2019_gpu_join_tpu.parallel.mesh import make_mesh as jmesh
from icde2019_gpu_join_tpu.parallel.mesh import make_mesh_2d as jmesh_2d
from icde2019_gpu_join_tpu_torch.parallel import dist_join as tdj
from icde2019_gpu_join_tpu_torch.parallel import dryrun, mesh as tmesh
from icde2019_gpu_join_tpu_torch.utils import oracle
from tests.conftest import make_tables

ENTRIES = ("distributed_join_aggregate", "distributed_join_segmented",
           "distributed_join_aggregate_2level")


def jax_mesh(nd):
    return jmesh_2d(2, 4) if nd == (2, 4) else jmesh(nd)


def port_mesh(nd):
    return (tmesh.make_mesh_2d(*nd, device="cpu") if isinstance(nd, tuple)
            else tmesh.make_mesh(nd, device="cpu"))


def run_both(entry: str, arrays, nd=8, **kw):
    """`entry` of both packages on the same inputs; asserts the results
    equal (aggregate, overflow and loads when asked) and returns the
    port's, as Python ints and numpy."""
    got = getattr(tdj, entry)(*arrays, port_mesh(nd), **kw)
    want = getattr(jdj, entry)(*(jnp.asarray(a) for a in arrays),
                               jax_mesh(nd), **kw)
    got = tuple(np.asarray(x) if isinstance(x, np.ndarray) else int(x)
                for x in got)
    want = tuple(np.asarray(x) if isinstance(x, np.ndarray) else int(x)
                 for x in want)
    np.testing.assert_equal(got, want)
    return got


@pytest.mark.parametrize("method", ["group", "sort"])
def test_distributed_aggregate_matches_jax_and_oracle(rng, method):
    arrays = make_tables(rng, n_r=4096, n_s=16384, dup_build=True)
    agg, ov = run_both("distributed_join_aggregate", arrays, method=method)
    assert ov == 0 and agg == oracle.join_aggregate(*arrays)


def test_distributed_pkfk_count_with_slack(rng):
    n_r, n_s = 2048, 8192
    rk = rng.permutation(n_r).astype(np.int32)
    sk = rk[rng.randint(0, n_r, n_s)].astype(np.int32)
    ones_r, ones_s = np.ones(n_r, np.int32), np.ones(n_s, np.int32)
    with pytest.warns(UserWarning, match="overflow"):
        agg, ov = run_both("distributed_join_aggregate", (rk, ones_r, sk, ones_s),
                           slack=3.0)
    assert ov == 0 and agg == n_s


def test_overflow_auto_replan(rng):
    """Every S key the same: one bucket overflows any slack-1 cap; both
    packages warn, replan with exact caps and return the exact result."""
    n = 4096
    rk = rng.permutation(n).astype(np.int32)
    sk = np.full(n, 7, dtype=np.int32)
    ones = np.ones(n, np.int32)
    with pytest.warns(UserWarning, match="overflow"):
        agg, ov = run_both("distributed_join_aggregate", (rk, ones, sk, ones),
                           slack=1.0)
    assert ov == 0 and agg == n


@pytest.mark.parametrize("method", ["group", "sort"])
def test_distributed_zipf_skew(rng, method):
    n_r, n_s = 8192, 32768
    rk = jdatagen.random_unique_gen(n_r, n_r - 1, seed=5)
    sk = jdatagen.gen_zipf(n_s, n_r, 1.05, seed=6)
    rp = rng.randint(1, 100, n_r).astype(np.int32)
    sp = rng.randint(1, 100, n_s).astype(np.int32)
    agg, ov = run_both("distributed_join_aggregate", (rk, rp, sk, sp),
                       method=method)
    assert ov == 0 and agg == oracle.join_aggregate(rk, rp, sk, sp)


@pytest.mark.parametrize("kwargs", [{}, {"slack": 4.0}, {"method": "sort"}],
                         ids=["exact", "slack", "sort"])
def test_segmented_distributed_join(rng, kwargs):
    nd = 8
    n_r, n_s = 64 * nd, 512 * nd
    rk = rng.permutation(4 * n_r)[:n_r].astype(np.int32)
    sk = rk[rng.randint(0, n_r, n_s)].astype(np.int32)
    rp = rng.randint(1, 50, n_r).astype(np.int32)
    sp = rng.randint(1, 50, n_s).astype(np.int32)
    agg, ov = run_both("distributed_join_segmented", (rk, rp, sk, sp),
                       num_segments=4, **kwargs)
    assert ov == 0 and agg == oracle.join_aggregate(rk, rp, sk, sp)


@pytest.mark.parametrize("entry", ["distributed_join_aggregate",
                                   "distributed_join_segmented"])
@pytest.mark.parametrize("method", ["group", "sort"])
def test_one_rank_mesh(rng, entry, method):
    """Config 5's leg A shape: the whole pipeline on one rank."""
    arrays = make_tables(rng, n_r=1024, n_s=4096, dup_build=True)
    agg, ov = run_both(entry, arrays, nd=1, method=method)
    assert ov == 0 and agg == oracle.join_aggregate(*arrays)


@pytest.mark.parametrize("method", ["group", "sort"])
def test_one_rank_exchange_int32max_key(method):
    """A real key of 2^31-1 is in the key domain: the one-bucket grouped
    frame must not take it for padding."""
    n = 256
    rk = np.arange(n, dtype=np.int32)
    rk[7] = 2**31 - 1
    sk = np.full(n, 2**31 - 1, np.int32)
    ones = np.ones(n, np.int32)
    agg, ov = run_both("distributed_join_aggregate", (rk, ones, sk, ones),
                       nd=1, method=method)
    assert ov == 0 and agg == n


@pytest.mark.parametrize("seed", range(5))
def test_distributed_segmented_fuzz_vs_host_oracle(seed):
    """The default pipeline over the adversarial families of the JAX test:
    duplicate-heavy, full non-negative domain, 30% of S on one key (heavy
    split), disjoint domains, key-domain boundaries; full-range payloads."""
    g = np.random.default_rng(4000 + seed)
    n_r, n_s = 4096, 16384
    if seed == 0:
        rk = g.integers(0, 500, n_r).astype(np.int32)
        sk = g.integers(0, 500, n_s).astype(np.int32)
    elif seed == 1:
        rk = g.integers(0, 2**31, n_r).astype(np.int64).astype(np.int32)
        sk = g.integers(0, 2**31, n_s).astype(np.int64).astype(np.int32)
    elif seed == 2:
        rk = g.permutation(n_r).astype(np.int32)
        sk = np.where(g.random(n_s) < 0.3, rk[3],
                      rk[g.integers(0, n_r, n_s)]).astype(np.int32)
    elif seed == 3:
        rk = g.integers(0, 10_000, n_r).astype(np.int32)
        sk = g.integers(20_000, 30_000, n_s).astype(np.int32)
    else:
        pool = np.array([0, 1, 2, 42, 2**31 - 2, 2**31 - 1], np.int32)
        rk = pool[g.integers(0, pool.size, n_r)]
        sk = pool[g.integers(0, pool.size, n_s)]
    rp = g.integers(-2**31, 2**31, n_r).astype(np.int64).astype(np.int32)
    sp = g.integers(-2**31, 2**31, n_s).astype(np.int64).astype(np.int32)
    agg, ov = run_both("distributed_join_segmented", (rk, rp, sk, sp),
                       num_segments=4, return_loads=True)[:2]
    assert ov == 0 and agg == jdatagen.host_oracle_aggregate(rk, rp, sk, sp)


def test_local_entry_refuses_ragged_shards():
    """The process entry's contract (equal shards), checked on every rank
    from gathered lengths, so all ranks raise together."""
    def rank_body(comms, _):
        k = torch.arange(256 + 128 * comms["x"].rank, dtype=torch.int32)
        return tdj.distributed_join_segmented_local(k, k, k, k, comms["x"])

    with pytest.raises(ValueError, match="shard lengths differ"):
        tmesh.make_mesh(2, device="cpu").run(rank_body, np.zeros(2, np.int32))


@pytest.mark.parametrize("n", [1, 2, 8])
def test_dryrun_multichip(n):
    line = dryrun.dryrun_multichip(n, device="cpu")
    assert "segmented" in line and "materialize" in line
    if n == 8:
        assert "2level" in line and "heavy-split-2level" in line


@pytest.mark.parametrize("name", ENTRIES + ("distributed_join_materialize",))
def test_entry_points_keep_jax_signatures(name):
    """The global entry points take JAX's parameters, in JAX's order, with
    JAX's defaults; each has a per-rank `_local` twin."""
    jp = inspect.signature(getattr(jdj, name)).parameters
    tp = inspect.signature(getattr(tdj, name)).parameters
    assert list(tp) == list(jp)
    assert [p.default for p in tp.values()] == [p.default for p in jp.values()]
    assert callable(getattr(tdj, name + "_local"))
