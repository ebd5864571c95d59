"""The port's stream-range probe (ops/probe_ranges.py): its planner, padding
and plain version against the JAX package's, whose Pallas kernel runs here
in interpret mode as tests/test_probe_pallas.py runs it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu.ops import probe_pallas as jpp
from icde2019_gpu_join_tpu.ops.partition import radix_partition as jax_partition
from icde2019_gpu_join_tpu_torch.ops import probe_ranges as pr_
from icde2019_gpu_join_tpu_torch.utils import oracle as toracle
from tests.conftest import make_tables


def _full(rng, n):
    return rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)


def _partitioned(rk, rp, sk, sp, bits, tr, ts):
    """JAX's pieces as tests/test_probe_pallas.py strings them: partition,
    plan, pad. Returns the padded host arrays and the plan."""
    pr = jax_partition(jnp.asarray(rk), jnp.asarray(rp), bits, 0)
    ps = jax_partition(jnp.asarray(sk), jnp.asarray(sp), bits, 0)
    s_start, s_nch = jpp.plan_ranges(np.asarray(pr.offsets),
                                     np.asarray(ps.offsets), rk.shape[0], tr, ts)
    rkp, rpp = jpp.pad_for_probe(pr.keys, pr.payload, tr)
    skp, spp = jpp.pad_for_probe(ps.keys, ps.payload, ts)
    return [np.array(a) for a in (rkp, rpp, skp, spp)], s_start, s_nch


def _jax_kernel(cols, s_start, s_nch, tr, ts) -> int:
    return int(jpp.probe_aggregate_ranges(
        *map(jnp.asarray, cols), jnp.asarray(s_start), jnp.asarray(s_nch),
        tile_r=tr, tile_s=ts, interpret=True))


def _port_ref(cols, s_start, s_nch, tr, ts) -> torch.Tensor:
    return pr_.probe_aggregate_ranges_ref(
        *map(torch.from_numpy, cols), s_start, s_nch, tile_r=tr, tile_s=ts)


def _skewed(rng, n_r=1000, n_s=6000):
    rk = rng.permutation(3000)[:n_r].astype(np.int32)
    sk = rk[np.minimum(rng.zipf(1.3, n_s) - 1, n_r - 1)].astype(np.int32)
    return rk, _full(rng, n_r), sk, _full(rng, n_s)


@pytest.mark.parametrize("n_r,n_s,bits,tr,ts", [
    (5000, 20000, 7, 1024, 1024),
    (3000, 9000, 6, 1024, 2048),
    (1024, 4096, 4, 2048, 128),
    (7, 100, 5, 1024, 1024),
])
def test_plan_ranges_and_padding_match_jax(rng, n_r, n_s, bits, tr, ts):
    rk, rp, sk, sp = make_tables(rng, n_r=n_r, n_s=n_s, dup_build=True)
    cols, s_start, s_nch = _partitioned(rk, rp, sk, sp, bits, tr, ts)
    pr = jax_partition(jnp.asarray(rk), jnp.asarray(rp), bits, 0)
    ps = jax_partition(jnp.asarray(sk), jnp.asarray(sp), bits, 0)
    got = pr_.plan_ranges(np.asarray(pr.offsets), np.asarray(ps.offsets), n_r,
                          tr, ts)
    for g, w in zip(got, (s_start, s_nch)):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    for keys, pays, tile, extra in ((pr.keys, pr.payload, tr, 0),
                                    (ps.keys, ps.payload, ts, 0),
                                    (ps.keys, ps.payload, ts, 256)):
        gk, gp = pr_.pad_for_probe(torch.tensor(np.asarray(keys)),
                                   torch.tensor(np.asarray(pays)), tile, extra)
        wk, wp = jpp.pad_for_probe(keys, pays, tile, extra)
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


@pytest.mark.parametrize("case", ["pkfk", "dup", "skew", "ones", "many_chunks"])
def test_ref_matches_jax_kernel(rng, case):
    """Several partitions per R tile, duplicate keys, one tile over a heavy
    hitter's many chunks, full-range payloads (sums wrap)."""
    tr, ts, bits = 1024, 1024, 6
    if case == "pkfk":
        rk, rp, sk, sp = make_tables(rng, n_r=3000, n_s=9000)
    elif case == "dup":
        rk, rp, sk, sp = make_tables(rng, n_r=3000, n_s=9000, dup_build=True)
    elif case == "skew":
        (rk, rp, sk, sp), bits = _skewed(rng), 4
    elif case == "ones":
        rk, _, sk, _ = make_tables(rng, n_r=2000, n_s=8000)
        rp, sp = np.ones(2000, np.int32), np.ones(8000, np.int32)
    else:
        (rk, rp, sk, sp), bits, ts = _skewed(rng, 1000, 20000), 2, 128
    cols, s_start, s_nch = _partitioned(rk, rp, sk, sp, bits, tr, ts)
    if case == "many_chunks":
        assert s_nch.max() >= 100, "test premise: a tile with many chunks"
    got = _port_ref(cols, s_start, s_nch, tr, ts)
    assert got.dtype == torch.int32 and got.dim() == 0
    want = _jax_kernel(cols, s_start, s_nch, tr, ts)
    assert int(got) == want == toracle.join_aggregate(rk, rp, sk, sp)


def test_ref_matches_jax_kernel_on_synthetic_plans(rng):
    """Ranges the planner would not make: dense keys, a tile with zero
    chunks, one whose chunk count runs past S (clamped), and tiles that
    share chunks."""
    tr, ts, n_tiles, n_s_chunks = 1024, 256, 6, 9
    cols = [rng.randint(0, 24, n_tiles * tr).astype(np.int32),
            _full(rng, n_tiles * tr),
            rng.randint(0, 24, n_s_chunks * ts).astype(np.int32),
            _full(rng, n_s_chunks * ts)]
    s_start = (np.array([0, 3, 8, 2, 0, 5], np.int32) * ts).astype(np.int32)
    s_nch = np.array([2, 0, 7, 1, 9, 3], np.int32)
    got = _port_ref(cols, s_start, s_nch, tr, ts)
    assert int(got) == _jax_kernel(cols, s_start, s_nch, tr, ts)


@pytest.mark.parametrize("elems", [1, 1 << 21])
def test_ref_does_not_depend_on_batching(rng, monkeypatch, elems):
    rk, rp, sk, sp = make_tables(rng, n_r=3000, n_s=9000, dup_build=True)
    cols, s_start, s_nch = _partitioned(rk, rp, sk, sp, 6, 1024, 1024)
    whole = int(_port_ref(cols, s_start, s_nch, 1024, 1024))
    monkeypatch.setattr(pr_, "_REF_ELEMS", elems)
    assert int(_port_ref(cols, s_start, s_nch, 1024, 1024)) == whole


def test_items_flatten_each_tiles_chunks_in_order():
    s_start = np.array([0, 512, 256, 768], np.int32)
    s_nch = np.array([2, 0, 5, 3], np.int32)        # tile 2 runs past S
    tile, s0 = pr_._items(s_start, s_nch, 1024, 256)
    np.testing.assert_array_equal(tile, [0, 0, 2, 2, 2, 3])
    np.testing.assert_array_equal(s0, [0, 256, 256, 512, 768, 768])


def test_cpu_tensors_take_plain_version(rng):
    rk, rp, sk, sp = make_tables(rng, n_r=2000, n_s=5000)
    cols, s_start, s_nch = _partitioned(rk, rp, sk, sp, 5, 1024, 1024)
    before = dict(pr_.LAUNCHES)
    got = pr_.probe_aggregate_ranges(*map(torch.from_numpy, cols),
                                     torch.from_numpy(s_start), s_nch,
                                     tile_r=1024, tile_s=1024)
    assert pr_.LAUNCHES == before
    assert int(got) == int(_port_ref(cols, s_start, s_nch, 1024, 1024))


def test_empty_r_is_zero():
    z = torch.zeros(0, dtype=torch.int32)
    s = torch.zeros(1024, dtype=torch.int32)
    empty = np.zeros(0, np.int32)
    assert int(pr_.probe_aggregate_ranges(z, z, s, s, empty, empty,
                                          tile_r=1024, tile_s=1024)) == 0


@pytest.mark.parametrize("bad", ["tile_r", "tile_s", "unpadded_r",
                                 "unpadded_s", "dtype", "strided", "device",
                                 "plan_length", "misaligned", "negative"])
def test_wrapper_rejects_bad_inputs(bad):
    rk, rp = torch.zeros(2048, dtype=torch.int32), torch.zeros(2048, dtype=torch.int32)
    sk, sp = torch.zeros(1024, dtype=torch.int32), torch.zeros(1024, dtype=torch.int32)
    s_start, s_nch = np.zeros(2, np.int32), np.ones(2, np.int32)
    tiles = dict(tile_r=1024, tile_s=512)
    if bad == "tile_r":
        tiles["tile_r"] = 512
    elif bad == "tile_s":
        tiles["tile_s"] = 100
    elif bad == "unpadded_r":
        rk, rp = rk[:2000], rp[:2000]
    elif bad == "unpadded_s":
        sk, sp = sk[:1000], sp[:1000]
    elif bad == "dtype":
        sp = sp.long()
    elif bad == "strided":
        rk = torch.zeros(4096, dtype=torch.int32)[::2]
    elif bad == "device":
        sk = sk.to("meta")
    elif bad == "plan_length":
        s_start, s_nch = np.zeros(3, np.int32), np.ones(3, np.int32)
    elif bad == "misaligned":
        s_start = np.array([0, 100], np.int32)
    else:
        s_start = np.array([-512, 0], np.int32)
    with pytest.raises(ValueError):
        pr_.probe_aggregate_ranges(rk, rp, sk, sp, s_start, s_nch, **tiles)


def test_reset_launches_zeroes_the_count():
    pr_.LAUNCHES["probe_aggregate_ranges"] += 2
    pr_.reset_launches()
    assert pr_.LAUNCHES == {"probe_aggregate_ranges": 0}
