"""`sort_impl` through every entry point of the port that sorts: under
"lax", "merge" and "packed" the port equals the JAX function under the same
`sort_impl` (aggregates bit for bit, pairs as multisets) and its numpy
oracle. Relations are powers of two of at least 8192 rows; the "cascade"
tables hold neither key 0 nor pad rows, so under "merge" every sort runs the
merge cascade, and the "key0" tables hold key 0, whose sort value is a
masking sentinel, so every sort falls back: `merge.ROUTES` shows which. The
choice lives in `EngineConfig.sort_impl` or the explicit argument; the port
has no process-wide default."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu import config as jconfig
from icde2019_gpu_join_tpu.models import ClusteredJoin as JaxJoin
from icde2019_gpu_join_tpu.models import pipelines as jpipelines
from icde2019_gpu_join_tpu.ops import perfect_hash as jph
from icde2019_gpu_join_tpu.relation import Relation as JaxRelation
from icde2019_gpu_join_tpu_torch.config import EngineConfig
from icde2019_gpu_join_tpu_torch.models import ClusteredJoin, pipelines
from icde2019_gpu_join_tpu_torch.ops import _launches, band_join, merge, partition
from icde2019_gpu_join_tpu_torch.ops import perfect_hash as ph
from icde2019_gpu_join_tpu_torch.relation import Relation
from icde2019_gpu_join_tpu_torch.utils import oracle as toracle

IMPLS = ["lax", "merge", "packed"]
TABLES = ["cascade", "key0"]
N_R, N_S = 8192, 16384


def _tables(kind, dup=False):
    """Power-of-two relations: R keys in [1, 4 N_R), with duplicates if
    `dup`; three quarters of S match. "key0" puts key 0 into both sides."""
    rng = np.random.RandomState(99)
    if dup:
        rk = rng.randint(1, N_R // 4, N_R).astype(np.int32)
    else:
        rk = (rng.permutation(4 * N_R - 1)[:N_R] + 1).astype(np.int32)
    sk = rk[rng.randint(0, N_R, N_S)].astype(np.int32)
    miss = rng.randint(0, N_S, N_S // 4)
    sk[miss] = rng.randint(4 * N_R, 8 * N_R, miss.size).astype(np.int32)
    if kind == "key0":
        rk[17] = 0
        sk[[5, 600]] = 0
    rp = rng.randint(-2**31, 2**31, N_R, dtype=np.int64).astype(np.int32)
    sp = rng.randint(-2**31, 2**31, N_S, dtype=np.int64).astype(np.int32)
    return rk, rp, sk, sp


def _rels(rk, rp, sk, sp):
    return ((Relation.from_numpy(rk, rp, device="cpu"),
             Relation.from_numpy(sk, sp, device="cpu")),
            (JaxRelation(jnp.asarray(rk), jnp.asarray(rp)),
             JaxRelation(jnp.asarray(sk), jnp.asarray(sp))))


def _engines(impl, mode="banded", **kw):
    return (ClusteredJoin(EngineConfig(probe_mode=mode, sort_impl=impl, **kw),
                          device="cpu"),
            JaxJoin(jconfig.EngineConfig(probe_mode=mode, sort_impl=impl, **kw)))


def _routed(fn, impl, kind, sorts):
    """Run fn with the route counts zeroed; under "merge" every one of its
    `sorts` sorts went the way the tables dictate, otherwise none did."""
    _launches.reset()
    out = fn()
    want = {"cascade": 0, "fallback": 0}
    if impl == "merge":
        want["cascade" if kind == "cascade" else "fallback"] = sorts
    assert merge.ROUTES == want
    assert set(merge.LAUNCHES.values()) == {0}      # CPU: no kernel launches
    return out


def _multiset(out_r, out_s):
    pairs = np.stack([np.asarray(out_r), np.asarray(out_s)], axis=1)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]


@pytest.mark.parametrize("kind", TABLES)
@pytest.mark.parametrize("impl", IMPLS)
def test_banded_aggregate_and_count(impl, kind):
    rk, rp, sk, sp = _tables(kind)
    (tr, ts), (jr, js) = _rels(rk, rp, sk, sp)
    port, jax_ = _engines(impl)
    got = _routed(lambda: port.aggregate(tr, ts).aggregate, impl, kind, 2)
    assert got == jax_.aggregate(jr, js).aggregate \
        == toracle.join_aggregate(rk, rp, sk, sp)
    cnt = _routed(lambda: port.count(tr, ts).count, impl, kind, 2)
    assert cnt == jax_.count(jr, js).count == toracle.join_count(rk, sk)


@pytest.mark.parametrize("kind", TABLES)
@pytest.mark.parametrize("impl", IMPLS)
def test_banded_materialize(impl, kind):
    rk, rp, sk, sp = _tables(kind, dup=True)
    (tr, ts), (jr, js) = _rels(rk, rp, sk, sp)
    port, jax_ = _engines(impl)
    want_pairs = toracle.join_materialize(rk, rp, sk, sp)
    total = want_pairs.shape[0]
    res = _routed(lambda: port.materialize(tr, ts, capacity=total + 64),
                  impl, kind, 2)
    want = jax_.materialize(jr, js, capacity=total + 64)
    assert res.count == want.count == total
    got = _multiset(*res.pairs)
    np.testing.assert_array_equal(got, _multiset(*want.pairs))
    zeros = np.zeros(64, np.int32)                           # unused slots
    np.testing.assert_array_equal(got, _multiset(
        np.concatenate([want_pairs[:, 0], zeros]),
        np.concatenate([want_pairs[:, 1], zeros])))


@pytest.mark.parametrize("kind", TABLES)
@pytest.mark.parametrize("impl", IMPLS)
def test_banded_late_aggregate(impl, kind):
    rk, _, sk, _ = _tables(kind, dup=True)
    rng = np.random.RandomState(3)
    r_cols = rng.randint(-2**31, 2**31, (N_R, 4), dtype=np.int64).astype(np.int32)
    s_cols = rng.randint(-2**31, 2**31, (N_S, 2), dtype=np.int64).astype(np.int32)
    r_ids = np.arange(N_R, dtype=np.int32)
    s_ids = rng.permutation(N_S).astype(np.int32)
    port, jax_ = _engines(impl)
    got = _routed(lambda: port.late_aggregate(
        Relation.from_numpy(rk, device="cpu"),
        Relation.from_numpy(sk, s_ids, device="cpu"),
        torch.from_numpy(r_cols), torch.from_numpy(s_cols)).aggregate,
        impl, kind, 2)
    want = jax_.late_aggregate(
        JaxRelation(jnp.asarray(rk), jnp.asarray(r_ids)),
        JaxRelation(jnp.asarray(sk), jnp.asarray(s_ids)),
        jnp.asarray(r_cols), jnp.asarray(s_cols)).aggregate
    assert got == want == toracle.join_late_materialize_sum(
        rk, r_ids, sk, s_ids, r_cols, s_cols)


@pytest.mark.parametrize("kind", TABLES)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mode", ["pallas", "blocked", "sort_merge"])
def test_partitioned_aggregate(mode, impl, kind):
    """"pallas" and "blocked" partition both sides under `sort_impl`;
    "sort_merge" keeps its own stable sort, as in JAX. The JAX "pallas"
    aggregate runs a Pallas kernel that needs interpret mode on the CPU
    (tests/test_torch_probe_ranges.py holds it against the port's), so that
    mode is held against the JAX banded engine under the same sort_impl."""
    rk, rp, sk, sp = _tables(kind)
    (tr, ts), (jr, js) = _rels(rk, rp, sk, sp)
    kw = dict(probe_tile_r=64, probe_tile_s=64)
    port, jax_ = _engines(impl, mode, **kw)
    if mode == "pallas":
        jax_ = _engines(impl)[1]
    sorts = 0 if mode == "sort_merge" else 2
    got = _routed(lambda: port.aggregate(tr, ts).aggregate, impl, kind, sorts)
    assert got == jax_.aggregate(jr, js).aggregate \
        == toracle.join_aggregate(rk, rp, sk, sp)


@pytest.mark.parametrize("kind", TABLES)
@pytest.mark.parametrize("impl", IMPLS)
def test_radix_partition(impl, kind):
    """The partition the "pallas" and "blocked" modes build on: keys,
    counts and offsets equal to JAX's, payloads as per-key multisets."""
    from icde2019_gpu_join_tpu.ops.partition import radix_partition as jax_rp
    rk, rp, _, _ = _tables(kind, dup=True)
    got = _routed(lambda: partition.radix_partition(
        torch.from_numpy(rk), torch.from_numpy(rp), 5, 0, impl), impl, kind, 1)
    want = jax_rp(jnp.asarray(rk), jnp.asarray(rp), 5, 0, impl)
    for name in ("keys", "counts", "offsets"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_array_equal(_multiset(got.keys, got.payload),
                                  _multiset(want.keys, want.payload))


def _pipeline_inputs(kind, groups=16):
    rk, rp, sk, _ = _tables(kind, dup=True)
    rng = np.random.RandomState(4)
    s_filter = rng.randint(0, 1000, N_S).astype(np.int32)
    s_gid = rng.randint(0, groups, N_S).astype(np.int32)
    return rk, rp, sk, s_filter, s_gid


@pytest.mark.parametrize("kind", TABLES)
@pytest.mark.parametrize("impl", IMPLS)
def test_filter_probe_groupby(impl, kind):
    """Filtered-out S rows carry key -2, whose sort value is not a masking
    sentinel, so the cascade still runs on the "cascade" tables."""
    inputs = _pipeline_inputs(kind)
    args = [torch.from_numpy(a) for a in inputs]
    got = _routed(lambda: pipelines.filter_probe_groupby(
        *args, 100, 600, 16, sort_impl=impl), impl, kind, 2)
    want = jpipelines.filter_probe_groupby(
        *map(jnp.asarray, inputs), 100, 600, 16, sort_impl=impl)
    oracle = toracle.filter_probe_groupby(*inputs, 100, 600, 16)
    streamed = pipelines.filter_probe_groupby_streamed(
        *args, 100, 600, 16, segments=4, sort_impl=impl)
    for g, s, w, o in zip(got, streamed, want, oracle):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), o)
        np.testing.assert_array_equal(s.numpy(), o)


@pytest.mark.parametrize("impl", IMPLS)
def test_streamed_pipeline_sorts_r_and_segments_under_sort_impl(impl):
    """Two segments of 8192 rows: R and both segments take the cascade."""
    inputs = _pipeline_inputs("cascade")
    args = [torch.from_numpy(a) for a in inputs]
    got = _routed(lambda: pipelines.filter_probe_groupby_streamed(
        *args, 100, 600, 16, segments=2, sort_impl=impl), impl, "cascade", 3)
    want = jpipelines.filter_probe_groupby_streamed(
        *map(jnp.asarray, inputs), 100, 600, 16, segments=2, sort_impl=impl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", TABLES)
@pytest.mark.parametrize("impl", IMPLS)
def test_filter_then_join_aggregate(impl, kind):
    rk, rp, sk, sp = _tables(kind)
    s_filter = np.random.RandomState(6).randint(0, 1000, N_S).astype(np.int32)
    (tr, ts), (jr, js) = _rels(rk, rp, sk, sp)
    got = _routed(lambda: pipelines.filter_then_join_aggregate(
        tr, ts, torch.from_numpy(s_filter), 100, 600,
        config=EngineConfig(sort_impl=impl)).aggregate, impl, kind, 2)
    want = jpipelines.filter_then_join_aggregate(
        jr, js, jnp.asarray(s_filter), 100, 600,
        config=jconfig.EngineConfig(sort_impl=impl)).aggregate
    keep = (s_filter >= 100) & (s_filter < 600)
    assert got == want == toracle.join_aggregate(rk, rp, sk[keep], sp[keep])


@pytest.mark.parametrize("kind", TABLES)
@pytest.mark.parametrize("impl", IMPLS)
def test_global_ht_join_aggregate(impl, kind):
    """Duplicate-heavy build keys overflow the chains, so the banded
    fallback, and with it both of its sorts, runs under `sort_impl`."""
    rk, rp, sk, sp = _tables(kind, dup=True)
    t = [torch.from_numpy(a) for a in (rk, rp, sk, sp)]
    n_ov = ph.global_ht_build(t[0], t[1], ph.default_log_buckets(N_R), 8)[-1]
    assert int(n_ov) > 0, "test premise broken: no overflow, no sort"
    got = _routed(lambda: int(ph.global_ht_join_aggregate(*t, sort_impl=impl)),
                  impl, kind, 2)
    want = int(jph.global_ht_join_aggregate(
        *map(jnp.asarray, (rk, rp, sk, sp)), sort_impl=impl))
    assert got == want == toracle.join_aggregate(rk, rp, sk, sp)


@pytest.mark.parametrize("impl", IMPLS)
def test_sort_pairs_dispatch(impl, monkeypatch):
    """`sort_pairs` reaches exactly the implementation it names."""
    calls = []
    for name in ("merge_sort_pairs", "packed_sort_pairs"):
        real = getattr(band_join, name)
        monkeypatch.setattr(
            band_join, name,
            lambda sv, pv, real=real, name=name: calls.append(name) or real(sv, pv))
    sv = torch.from_numpy(np.random.RandomState(1).randint(
        -1000, 1000, 8192).astype(np.int32))
    pv = torch.arange(8192, dtype=torch.int32)
    got_sv, got_pv = band_join.sort_pairs(sv, pv, impl)
    assert calls == {"lax": [], "merge": ["merge_sort_pairs"],
                     "packed": ["packed_sort_pairs"]}[impl]
    assert torch.equal(got_sv, torch.sort(sv).values)
    assert torch.equal(sv[got_pv.long()], got_sv)


def test_engines_with_different_sort_impls_coexist():
    """Interleaved calls of three engines: each keeps its own sort."""
    rk, rp, sk, sp = _tables("cascade")
    (tr, ts), _ = _rels(rk, rp, sk, sp)
    want = toracle.join_aggregate(rk, rp, sk, sp)
    engines = {impl: ClusteredJoin(EngineConfig(sort_impl=impl), device="cpu")
               for impl in IMPLS}
    engines[None] = ClusteredJoin(device="cpu")
    assert engines[None].sort_impl == "lax"
    for impl in ("merge", "lax", "packed", None, "merge", "lax"):
        got = _routed(lambda: engines[impl].aggregate(tr, ts).aggregate,
                      impl, "cascade", 2)
        assert got == want


@pytest.mark.parametrize("where", ["engine", "sort_pairs", "aggregate",
                                   "partition", "pipeline"])
def test_unknown_sort_impl_raises(where):
    rk, rp, sk, sp = (torch.from_numpy(a) for a in _tables("cascade"))
    with pytest.raises(ValueError, match="unknown sort_impl 'bitonic'"):
        if where == "engine":
            ClusteredJoin(EngineConfig(sort_impl="bitonic"), device="cpu")
        elif where == "sort_pairs":
            band_join.sort_pairs(rk, rp, "bitonic")
        elif where == "aggregate":
            band_join.banded_join_aggregate(rk, rp, sk, sp, sort_impl="bitonic")
        elif where == "partition":
            partition.radix_partition(rk, rp, 4, 0, "bitonic")
        else:
            pipelines.filter_probe_groupby(rk, rp, sk, sk, sk, 0, 1, 4,
                                           sort_impl="bitonic")


def test_port_has_no_process_wide_sort_default():
    """The choice lives in the config or the argument: no setter, no
    module default, no environment variable."""
    for name in ("_SORT_IMPL", "set_sort_impl", "get_sort_impl"):
        assert not hasattr(band_join, name)


# ---- sort_impl=None: the reference's default, "lax" ------------------------

def _none_sort_pairs():
    rk, rp, _, _ = _tables("cascade", dup=True)
    from icde2019_gpu_join_tpu.ops.band_join import sort_pairs as jax_sort
    got = band_join.sort_pairs(torch.from_numpy(rk), torch.from_numpy(rp), None)
    want = jax_sort(jnp.asarray(rk), jnp.asarray(rp), None)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(_multiset(*got), _multiset(*want))


def _none_sort_by_key():
    rk, rp, _, _ = _tables("key0", dup=True)
    from icde2019_gpu_join_tpu.ops.band_join import sort_by_key as jax_sort
    got = band_join.sort_by_key(torch.from_numpy(rk[:-5]),
                                torch.from_numpy(rp[:-5]))     # pads to 128
    want = jax_sort(jnp.asarray(rk[:-5]), jnp.asarray(rp[:-5]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(_multiset(*got), _multiset(*want))


def _none_banded_join_aggregate():
    from icde2019_gpu_join_tpu.ops.band_join import banded_join_aggregate as j
    t = _tables("cascade")
    got = band_join.banded_join_aggregate(*map(torch.from_numpy, t))
    assert int(got) == int(j(*map(jnp.asarray, t))) \
        == toracle.join_aggregate(*t)


def _none_banded_materialize():
    from icde2019_gpu_join_tpu.ops.band_join import banded_materialize as j
    t = _tables("cascade", dup=True)
    total = toracle.join_materialize(*t).shape[0]
    got = band_join.banded_materialize(*map(torch.from_numpy, t), total + 64)
    want = j(*map(jnp.asarray, t), total + 64)
    assert int(got[2]) == int(want[2]) == total
    np.testing.assert_array_equal(_multiset(got[0], got[1]),
                                  _multiset(want[0], want[1]))


def _none_radix_partition():
    from icde2019_gpu_join_tpu.ops.partition import radix_partition as jax_rp
    rk, rp, _, _ = _tables("cascade", dup=True)
    got = partition.radix_partition(torch.from_numpy(rk),
                                    torch.from_numpy(rp), 5)
    want = jax_rp(jnp.asarray(rk), jnp.asarray(rp), 5)
    for name in ("keys", "counts", "offsets"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_array_equal(_multiset(got.keys, got.payload),
                                  _multiset(want.keys, want.payload))


def _none_filter_probe_groupby():
    inputs = _pipeline_inputs("cascade")
    args = [torch.from_numpy(a) for a in inputs]
    want = jpipelines.filter_probe_groupby(*map(jnp.asarray, inputs),
                                           100, 600, 16)
    for got in (pipelines.filter_probe_groupby(*args, 100, 600, 16),
                pipelines.filter_probe_groupby(*args, 100, 600, 16,
                                               sort_impl=None),
                pipelines.filter_probe_groupby_streamed(
                    *args, 100, 600, 16, segments=4, sort_impl=None)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _none_global_ht_join_aggregate():
    t = _tables("cascade", dup=True)
    got = int(ph.global_ht_join_aggregate(*map(torch.from_numpy, t),
                                          sort_impl=None))
    assert got == int(jph.global_ht_join_aggregate(*map(jnp.asarray, t))) \
        == toracle.join_aggregate(*t)


def _none_engine():
    rk, rp, sk, sp = _tables("cascade")
    (tr, ts), (jr, js) = _rels(rk, rp, sk, sp)
    port = ClusteredJoin(EngineConfig(), device="cpu")
    assert EngineConfig().sort_impl is None and port.sort_impl == "lax"
    assert port.aggregate(tr, ts).aggregate \
        == JaxJoin(jconfig.EngineConfig()).aggregate(jr, js).aggregate \
        == toracle.join_aggregate(rk, rp, sk, sp)


@pytest.mark.parametrize("entry", [
    _none_sort_pairs, _none_sort_by_key, _none_banded_join_aggregate,
    _none_banded_materialize, _none_radix_partition,
    _none_filter_probe_groupby, _none_global_ht_join_aggregate, _none_engine,
], ids=lambda f: f.__name__[len("_none_"):])
def test_sort_impl_none_is_lax_as_in_jax(entry):
    """`sort_impl=None`, the default of every function that sorts in both
    packages, runs the library sort: no cascade, no fallback, and the JAX
    function's result on the same inputs."""
    _launches.reset()
    entry()
    assert merge.ROUTES == {"cascade": 0, "fallback": 0}


@pytest.mark.parametrize("name,want", [(None, "lax"), ("lax", "lax"),
                                       ("merge", "merge"),
                                       ("packed", "packed")])
def test_resolve_sort_impl(name, want, monkeypatch):
    """No process default and no environment variable: None is "lax"
    whatever the reference's variable says."""
    monkeypatch.setenv("TPUJOIN_SORT_IMPL", "merge")
    assert band_join.resolve_sort_impl(name) == want


@pytest.mark.parametrize("name", ["bitonic", "", "LAX", 0])
def test_resolve_sort_impl_rejects_unknown_names(name):
    with pytest.raises(ValueError, match="unknown sort_impl"):
        band_join.resolve_sort_impl(name)


def test_sort_impl_defaults_are_none_where_jax_defaults_to_none():
    import inspect
    for fn in (band_join.sort_pairs, band_join.sort_by_key,
               band_join.banded_join_aggregate, band_join.banded_join_count,
               band_join.banded_join_late_aggregate,
               band_join.banded_materialize, partition.radix_partition,
               pipelines.filter_probe_groupby,
               pipelines.filter_probe_groupby_streamed,
               ph.global_ht_join_aggregate):
        assert inspect.signature(fn).parameters["sort_impl"].default is None, fn
