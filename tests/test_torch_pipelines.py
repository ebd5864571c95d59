"""The port's models/pipelines.py and ops/filter.py against the JAX
package's, bit for bit, and against the numpy oracle (mirrors
tests/test_pipelines.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu.config import EngineConfig as JaxConfig
from icde2019_gpu_join_tpu.models import pipelines as JP
from icde2019_gpu_join_tpu.ops import filter as JF
from icde2019_gpu_join_tpu.relation import Relation as JaxRelation
from icde2019_gpu_join_tpu.utils import oracle
from icde2019_gpu_join_tpu_torch.config import EngineConfig
from icde2019_gpu_join_tpu_torch.models import pipelines as TP
from icde2019_gpu_join_tpu_torch.ops import filter as TF
from icde2019_gpu_join_tpu_torch.relation import Relation
from icde2019_gpu_join_tpu_torch.utils import datasets
from icde2019_gpu_join_tpu_torch.utils import oracle as toracle


def _pk_inputs(rng, n_r=1000, n_s=8000, groups=16):
    rk = rng.permutation(3000)[:n_r].astype(np.int32)
    rp = rng.randint(-(2**31), 2**31, n_r).astype(np.int64).astype(np.int32)
    sk = rk[rng.randint(0, n_r, n_s)].astype(np.int32)
    miss = rng.randint(0, n_s, n_s // 5)   # some S rows miss
    sk[miss] = (rng.randint(0, 3000, miss.shape[0]) + 5000).astype(np.int32)
    fcol = rng.randint(0, 100, n_s).astype(np.int32)
    gid = rng.randint(0, groups, n_s).astype(np.int32)
    return rk, rp, sk, fcol, gid


def _dup_inputs(seed, n_r=4000, n_s=9000, groups=13):
    """Duplicate-key R with one heavy hitter (10% of R), a quarter of S
    missing, full-range payloads."""
    r = np.random.RandomState(seed)
    rk = r.randint(0, 700, n_r).astype(np.int32)
    rk[: n_r // 10] = 42
    rp = r.randint(-(2**31), 2**31 - 1, n_r).astype(np.int64).astype(np.int32)
    sk = np.concatenate([
        rk[r.randint(0, n_r, n_s - n_s // 4)],
        (r.randint(0, 700, n_s // 4) + 5000).astype(np.int32),
    ]).astype(np.int32)
    r.shuffle(sk)
    fcol = r.randint(0, 100, n_s).astype(np.int32)
    gid = r.randint(0, groups, n_s).astype(np.int32)
    return rk, rp, sk, fcol, gid


def _both(inputs, lo, hi, groups, w=1):
    got = TP.filter_probe_groupby(*map(torch.from_numpy, inputs), lo, hi,
                                  groups, window_blocks=w)
    want = JP.filter_probe_groupby(*map(jnp.asarray, inputs), jnp.int32(lo),
                                   jnp.int32(hi), groups, window_blocks=w)
    for g in got:
        assert g.dtype == torch.int32 and g.shape == (groups,)
    return [g.numpy() for g in got], [np.asarray(x) for x in want]


@pytest.mark.parametrize("w", [1, 2])
def test_filter_probe_groupby_pk(rng, w):
    inputs = _pk_inputs(rng)
    (gc, gs), (wc, ws) = _both(inputs, 20, 70, 16, w)
    ec, es = oracle.filter_probe_groupby(*inputs, 20, 70, 16)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gc, ec)
    np.testing.assert_array_equal(gs, es)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_probe_groupby_duplicate_r(seed):
    """An S row matching k R rows adds k to its group's COUNT and the sum
    of all k payloads to its SUM."""
    inputs = _dup_inputs(seed)
    (gc, gs), (wc, ws) = _both(inputs, 15, 80, 13)
    ec, es = toracle.filter_probe_groupby(*inputs, 15, 80, 13)
    for got, want, exp in ((gc, wc, ec), (gs, ws, es)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, exp)


def _streamed_inputs():
    rng = np.random.RandomState(11)
    n_r, n_s, groups = 3000, 8192, 11
    rk = rng.randint(0, 500, n_r).astype(np.int32)   # dup-key R
    rp = rng.randint(-(2**31), 2**31 - 1, n_r).astype(np.int64).astype(np.int32)
    sk = np.concatenate([
        rk[rng.randint(0, n_r, n_s - n_s // 4)],
        (rng.randint(0, 500, n_s // 4) + 9000).astype(np.int32),
    ]).astype(np.int32)
    rng.shuffle(sk)
    fcol = rng.randint(0, 100, n_s).astype(np.int32)
    gid = rng.randint(0, groups, n_s).astype(np.int32)
    return (rk, rp, sk, fcol, gid), groups


@pytest.mark.parametrize("segments", [1, 4, 8])
def test_streamed_equals_fused(segments):
    """Probe side in equal segments with partial sums mod 2^32: equal to the
    fused pipeline and to the JAX streamed pipeline, as device tensors."""
    inputs, groups = _streamed_inputs()
    tin = [torch.from_numpy(a) for a in inputs]
    fc, fs = TP.filter_probe_groupby(*tin, 10, 85, groups)
    sc, ss = TP.filter_probe_groupby_streamed(*tin, 10, 85, num_groups=groups,
                                              segments=segments)
    assert isinstance(sc, torch.Tensor) and sc.dtype == ss.dtype == torch.int32
    assert torch.equal(sc, fc) and torch.equal(ss, fs)
    jc, js = JP.filter_probe_groupby_streamed(*inputs, 10, 85,
                                              num_groups=groups,
                                              segments=segments)
    np.testing.assert_array_equal(sc.numpy(), jc)
    np.testing.assert_array_equal(ss.numpy(), js)


def test_streamed_segments_must_divide():
    inputs, groups = _streamed_inputs()
    with pytest.raises(ValueError, match="segments=3 must divide n_s=8192"):
        TP.filter_probe_groupby_streamed(
            *map(torch.from_numpy, inputs), 10, 85, num_groups=groups,
            segments=3)


def test_filter_groupby(rng):
    n, groups = 5000, 8
    keys = rng.randint(0, 1000, n).astype(np.int32)
    vals = rng.randint(-(2**31), 2**31, n).astype(np.int64).astype(np.int32)
    gid = rng.randint(0, groups, n).astype(np.int32)
    gc, gs = TP.filter_groupby(*map(torch.from_numpy, (keys, vals, gid)),
                               100, 900, groups)
    wc, ws = JP.filter_groupby(*map(jnp.asarray, (keys, vals, gid)),
                               jnp.int32(100), jnp.int32(900), groups)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    keep = (keys >= 100) & (keys < 900)
    ec, es = oracle.groupby_aggregate(gid[keep], vals[keep], groups)
    np.testing.assert_array_equal(gc.numpy(), ec)
    np.testing.assert_array_equal(gs.numpy(), es)


@pytest.mark.parametrize("n", [3000, 2999, 1 << 12, 0])
def test_groupby_ignores_ids_out_of_range(rng, n):
    """Rows whose group id lies outside [0, G) count in no group, as in the
    JAX sort-based reduction; any row count (the bins are spread over a
    power-of-two number of copies that divides it)."""
    gids = rng.randint(-3, 12, n).astype(np.int32)
    v1 = rng.randint(-(2**31), 2**31, n).astype(np.int64).astype(np.int32)
    v2 = rng.randint(0, 50, n).astype(np.int32)
    got = TP._groupby_sums2_exact(*map(torch.from_numpy, (gids, v1, v2)), 9)
    want = JP._groupby_sums2_exact(*map(jnp.asarray, (gids, v1, v2)), 9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("w", [1, 4])
def test_filter_then_join_aggregate(rng, w):
    rk, rp, sk, fcol, _ = _pk_inputs(rng, n_s=4000)
    sp = rng.randint(-(2**31), 2**31, sk.size).astype(np.int64).astype(np.int32)
    got = TP.filter_then_join_aggregate(
        Relation.from_numpy(rk, rp, device="cpu"),
        Relation.from_numpy(sk, sp, device="cpu"),
        torch.from_numpy(fcol), 30, 60, EngineConfig(band_window_blocks=w))
    want = JP.filter_then_join_aggregate(
        JaxRelation(jnp.asarray(rk), jnp.asarray(rp)),
        JaxRelation(jnp.asarray(sk), jnp.asarray(sp)),
        jnp.asarray(fcol), 30, 60, JaxConfig(band_window_blocks=w))
    keep = (fcol >= 30) & (fcol < 60)
    assert got.aggregate == want.aggregate == oracle.join_aggregate(
        rk, rp, sk[keep], sp[keep])


@pytest.mark.parametrize("lo,hi", [(100, 600), (0, 0), (-5, 2000)])
def test_filter_compact_matches_jax(rng, lo, hi):
    keys = rng.randint(0, 1000, 3000).astype(np.int32)
    vals = rng.randint(-(2**31), 2**31, 3000).astype(np.int64).astype(np.int32)
    tk, tv, tc = TF.filter_compact(*map(torch.from_numpy, (keys, vals)), lo, hi)
    jk, jv, jc = JF.filter_compact(*map(jnp.asarray, (keys, vals)), lo, hi)
    assert tc.dtype == torch.int32 and int(tc) == int(jc)
    # survivors keep their order; the tail holds the dropped rows in order
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    ok, ov = oracle.filter_rows(keys, vals, lo, hi)
    np.testing.assert_array_equal(tk.numpy()[:int(tc)], ok)
    np.testing.assert_array_equal(tv.numpy()[:int(tc)], ov)


def test_config3_generator_is_the_run_configs_recipe():
    """The inline recipe of benchmarks/run_configs.py config3, byte for
    byte, so both packages get identical config-3 inputs."""
    n_r, n_s, groups = 1 << 10, 1 << 14, 64
    rng = np.random.default_rng(42)
    rk = rng.permutation(n_r).astype(np.int32)
    rp = rng.integers(1, 100, n_r).astype(np.int32)
    sk = rk[rng.integers(0, n_r, n_s)].astype(np.int32)
    s_filter = rng.integers(0, 1000, n_s).astype(np.int32)
    s_gid = rng.integers(0, groups, n_s).astype(np.int32)
    got = datasets.make_config3(n_r, n_s, groups)
    for g, w in zip(got, (rk, rp, sk, s_filter, s_gid)):
        assert g.dtype == np.int32 and g.tobytes() == w.tobytes()
    assert datasets.make_config3(n_r, n_s, groups, seed=7)[0].tobytes() != \
        rk.tobytes()


def test_config3_pipeline_matches_jax_and_oracle():
    inputs = datasets.make_config3(1 << 10, 1 << 14, 64)
    (gc, gs), (wc, ws) = _both(inputs, 100, 600, 64)
    ec, es = toracle.filter_probe_groupby(*inputs, 100, 600, 64)
    for got, want, exp in ((gc, wc, ec), (gs, ws, es)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, exp)
