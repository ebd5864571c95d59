"""The port's parallel/plan.py against the JAX package's: the same global
keys, JAX's planners over 8 virtual CPU devices, the port's on every rank of
an 8-rank (or 2 x 4, or 1-rank) thread mesh. Caps and histograms equal, and
equal on every rank."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu.parallel import plan as jplan
from icde2019_gpu_join_tpu.parallel.mesh import make_mesh as jmesh
from icde2019_gpu_join_tpu.parallel.mesh import make_mesh_2d as jmesh_2d
from icde2019_gpu_join_tpu_torch.parallel import plan as tplan
from icde2019_gpu_join_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
from icde2019_gpu_join_tpu_torch.utils import oracle


def on_ranks(mesh, fn, *arrays):
    """fn(comms, *shards) on every rank; asserts all ranks agree."""
    outs = mesh.run(fn, *(torch.from_numpy(a) for a in arrays))
    for out in outs[1:]:
        np.testing.assert_equal(out, outs[0])
    return outs[0]


def attrs(p):
    return {k: (np.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in vars(p).items()}


def skewed(rng, n_r=2048, n_s=16384, frac=0.5):
    rk = rng.permutation(n_r).astype(np.int32)
    sk = np.where(rng.rand(n_s) < frac, rk[13],
                  rk[rng.randint(0, n_r, n_s)]).astype(np.int32)
    return rk, sk


@pytest.mark.parametrize("nd,first_bit", [(8, 0), (8, 5), (1, 0)])
def test_destination_histograms_and_plan_cap_match_jax(rng, nd, first_bit):
    keys = rng.randint(0, 1 << 20, 1024 * 8).astype(np.int32)
    got = on_ranks(make_mesh(nd, device="cpu"), lambda c, k: (
        tplan.destination_histograms(k, c["x"], nd, first_bit),
        tplan.plan_cap(k, c["x"], nd, first_bit)), keys)
    want = jplan.destination_histograms(jnp.asarray(keys), jmesh(nd), "x", nd,
                                        first_bit)
    np.testing.assert_array_equal(got[0], want)
    assert got[1] == jplan.plan_cap(jnp.asarray(keys), jmesh(nd), "x", nd,
                                    first_bit)


def test_plan_cap_exact(rng):
    """tests/test_distributed.py::test_plan_cap_exact on the port: the cap
    covers the true max bucket fill, by less than a block."""
    nd = 8
    n = 1024 * nd
    keys = rng.randint(0, 1 << 20, n).astype(np.int32)
    cap = on_ranks(make_mesh(nd, device="cpu"),
                   lambda c, k: tplan.plan_cap(k, c["x"], nd, 0), keys)
    pid = oracle.partition_ids(keys, 3, 0)
    mx = max(np.bincount(pid[d * (n // nd):(d + 1) * (n // nd)],
                         minlength=nd).max() for d in range(nd))
    assert mx <= cap <= mx + 128 and cap % 128 == 0


@pytest.mark.parametrize("nd,chunk", [(8, 1024), (8, 4096), (1, 4096)])
def test_plan_cap_grouped_matches_jax(rng, nd, chunk):
    keys = rng.randint(0, 1 << 30, 4096 * 8).astype(np.int32)
    got = on_ranks(make_mesh(nd, device="cpu"), lambda c, k:
                   tplan.plan_cap_grouped(k, c["x"], nd, 0, chunk), keys)
    assert got == jplan.plan_cap_grouped(jnp.asarray(keys), jmesh(nd), "x",
                                         nd, 0, chunk)


@pytest.mark.parametrize("method", ["sort", "group"])
@pytest.mark.parametrize("nd", [8, 1])
def test_plan_cap_segmented_matches_jax(rng, method, nd):
    _, keys = skewed(rng, n_s=8 * 4096, frac=0.2)
    got = on_ranks(make_mesh(nd, device="cpu"), lambda c, k:
                   tplan.plan_cap_segmented(k, c["x"], nd, 0, 4, method,
                                            1024), keys)
    assert got == jplan.plan_cap_segmented(jnp.asarray(keys), jmesh(nd), "x",
                                           nd, 0, 4, method, 1024)


@pytest.mark.parametrize("nh,nc", [(2, 4), (4, 2), (1, 8)])
def test_plan_caps_2level_matches_jax(rng, nh, nc):
    _, keys = skewed(rng, n_s=8 * 1024, frac=0.1)
    got = on_ranks(make_mesh_2d(nh, nc, device="cpu"), lambda c, k:
                   tplan.plan_caps_2level(k, c["host"], c["chip"], 0), keys)
    assert got == jplan.plan_caps_2level(jnp.asarray(keys), jmesh_2d(nh, nc),
                                         "host", "chip", 0)


@pytest.mark.parametrize("segments", [1, 4])
def test_fine_histograms_match_jax(rng, segments):
    keys = rng.randint(0, 1 << 31, 8 * 2048).astype(np.int64).astype(np.int32)
    keys[::97] = 0
    got = on_ranks(make_mesh(8, device="cpu"), lambda c, k:
                   tplan.fine_histograms(k, c["x"], 9, 2, segments), keys)
    np.testing.assert_array_equal(got, jplan.fine_histograms(
        jnp.asarray(keys), jmesh(8), "x", 9, 2, segments))
    got2 = on_ranks(make_mesh_2d(2, 4, device="cpu"), lambda c, k:
                    tplan.fine_histograms_2d(k, c["host"], c["chip"], 9, 2),
                    keys)
    np.testing.assert_array_equal(got2, jplan.fine_histograms_2d(
        jnp.asarray(keys), jmesh_2d(2, 4), "host", "chip", 9, 2))


def test_heavy_destinations_match_jax(rng):
    hist = rng.randint(0, 100, (8, 64))
    hist[:, 5] += 2000
    for f in (1.0, 4.0, 30.0):
        np.testing.assert_array_equal(tplan.heavy_destinations(hist, f),
                                      jplan.heavy_destinations(hist, f))


@pytest.mark.parametrize("frac,segments", [(0.5, 4), (0.5, 1), (0.0, 4)])
def test_plan_heavy_split_matches_jax(rng, frac, segments):
    rk, sk = skewed(rng, frac=frac)
    got = on_ranks(make_mesh(8, device="cpu"), lambda c, r, s: attrs(
        tplan.plan_heavy_split(r, s, c["x"], 8, segments=segments)), rk, sk)
    want = attrs(jplan.plan_heavy_split(jnp.asarray(rk), jnp.asarray(sk),
                                        jmesh(8), "x", 8, segments=segments))
    np.testing.assert_equal(got, want)
    assert bool(got["heavy_ids"]) == (frac > 0)


@pytest.mark.parametrize("frac", [0.5, 0.0])
def test_plan_heavy_split_2level_matches_jax(rng, frac):
    rk, sk = skewed(rng, frac=frac)
    got = on_ranks(make_mesh_2d(2, 4, device="cpu"), lambda c, r, s: attrs(
        tplan.plan_heavy_split_2level(r, s, c["host"], c["chip"])), rk, sk)
    want = attrs(jplan.plan_heavy_split_2level(
        jnp.asarray(rk), jnp.asarray(sk), jmesh_2d(2, 4), "host", "chip"))
    np.testing.assert_equal(got, want)
