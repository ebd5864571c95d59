"""The port's parallel/exchange.py against the JAX package's, on the same
seeded numpy inputs (the exchange cases of tests/test_distributed.py), and
the all-to-all over the port's 8-rank thread mesh against `shard_map` over
JAX's 8 virtual CPU devices.

Sort-based frames: keys equal element for element, payloads equal as
multisets within runs of equal keys (both sorts are unstable). Grouped
frames come out the same way (radix_group's keys are equal element for
element). start, count and overflow equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from icde2019_gpu_join_tpu.ops.bits import rotate_keys as jrotate
from icde2019_gpu_join_tpu.ops.partition_radix import grouped_block_counts
from icde2019_gpu_join_tpu.parallel import exchange as jex
from icde2019_gpu_join_tpu.parallel.mesh import make_mesh as jmake_mesh
from icde2019_gpu_join_tpu_torch.parallel import exchange as tex
from icde2019_gpu_join_tpu_torch.parallel.mesh import make_mesh
from icde2019_gpu_join_tpu_torch.utils import oracle
from tests.test_torch_partition_radix import same_runs


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def same_frames(got, want):
    same_runs(got.keys, got.pays, want.keys, want.pays)
    for name in ("start", "count", "overflow"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)


def _inputs(rng, n=5000):
    keys = rng.randint(0, 1 << 20, n).astype(np.int32)
    pays = rng.randint(1, 1000, n).astype(np.int32)
    return keys, pays


@pytest.mark.parametrize("nb,first_bit", [(8, 0), (4, 3), (2, 17)])
def test_partition_to_buckets_matches_jax(rng, nb, first_bit):
    keys, pays = _inputs(rng)
    bits = (nb - 1).bit_length()
    pid = oracle.partition_ids(keys, bits, first_bit)
    cap = int(-(-np.bincount(pid, minlength=nb).max() // 128) * 128)
    for c in (cap, 128):   # exact, and too small: overflow counted alike
        got = tex.partition_to_buckets(t(keys), t(pays), nb, c, first_bit)
        want = jex.partition_to_buckets(jnp.asarray(keys), jnp.asarray(pays),
                                        nb, c, first_bit)
        same_frames(got, want)
    assert int(got.overflow) > 0


def test_partition_to_buckets_valid_matches_jax(rng):
    keys, pays = _inputs(rng)
    valid = rng.rand(keys.size) < 0.6
    for nb in (1, 8):
        got = tex.partition_to_buckets(t(keys), t(pays), nb, 1024 * 8 // nb,
                                       0, valid=t(valid))
        want = jex.partition_to_buckets(jnp.asarray(keys), jnp.asarray(pays),
                                        nb, 1024 * 8 // nb, 0,
                                        valid=jnp.asarray(valid))
        same_frames(got, want)
        assert int(got.count.sum()) == valid.sum()


@pytest.mark.parametrize("chunk", [512, 1024, 4096])
def test_partition_to_buckets_grouped_matches_jax(rng, chunk):
    keys, pays = _inputs(rng)
    pb = np.asarray(grouped_block_counts(jrotate(jnp.asarray(keys), 3, 0), 3,
                                         chunk))
    for cap in (int(pb.max()) * 128, 256):
        got = tex.partition_to_buckets_grouped(t(keys), t(pays), 8, cap, 0,
                                               chunk=chunk)
        want = jex.partition_to_buckets_grouped(
            jnp.asarray(keys), jnp.asarray(pays), 8, cap, 0, chunk=chunk)
        same_frames(got, want)


def test_bucket_frames_roundtrip(rng):
    """tests/test_distributed.py::test_bucket_frames_roundtrip on the port:
    the payload != 0 multiset survives, rows sit at [start, start+count),
    every row in its destination's frame."""
    keys, pays = _inputs(rng)
    nd = 8
    pid = oracle.partition_ids(keys, 3, 0)
    cap = int(-(-np.bincount(pid, minlength=nd).max() // 128) * 128)
    fr = tex.partition_to_buckets(t(keys), t(pays), nd, cap, 0)
    assert int(fr.overflow) == 0
    np.testing.assert_array_equal(fr.count.numpy(), np.bincount(pid, minlength=nd))
    k2, p2 = fr.keys.numpy(), fr.pays.numpy()
    mask = tex.frames_valid_mask(fr.start, fr.count, k2.shape[1]).numpy()
    live = np.stack([k2[mask], p2[mask]], axis=1)
    orig = np.stack([keys, pays], axis=1)
    np.testing.assert_array_equal(live[np.lexsort((live[:, 1], live[:, 0]))],
                                  orig[np.lexsort((orig[:, 1], orig[:, 0]))])
    assert np.all(p2[~mask] == 0)
    for d in range(nd):
        assert np.all(oracle.partition_ids(k2[d][mask[d]], 3, 0) == d)
    np.testing.assert_array_equal(
        mask, np.asarray(jex.frames_valid_mask(jnp.asarray(fr.start.numpy()),
                                               jnp.asarray(fr.count.numpy()),
                                               k2.shape[1])))


@pytest.mark.parametrize("method", ["sort", "group"])
def test_single_bucket_frames_match_jax(rng, method):
    """One destination (a 1-rank mesh): one frame holding the whole live
    multiset; a real key of 2^31-1 stays live (liveness is positional)."""
    keys, pays = _inputs(rng)
    keys[7] = 2**31 - 1
    cap = -(-keys.size // 128) * 128
    port = tex.partition_to_buckets if method == "sort" else \
        tex.partition_to_buckets_grouped
    ref = jex.partition_to_buckets if method == "sort" else \
        jex.partition_to_buckets_grouped
    for c in (cap, cap - 1024):
        got = port(t(keys), t(pays), 1, c, 0)
        want = ref(jnp.asarray(keys), jnp.asarray(pays), 1, c, 0)
        same_frames(got, want)
    assert got.keys.shape[0] == 1 and int(got.overflow) > 0


def test_spread_pad_keys_match_jax():
    idx = np.array([0, 1, 2, 127, 128, 2**20, 2**31 - 1], np.int32)
    np.testing.assert_array_equal(
        tex._spread_pad_keys(t(idx)).numpy(),
        np.asarray(jex._spread_pad_keys(jnp.asarray(idx))))


def test_all_to_all_over_the_thread_mesh_matches_shard_map(rng):
    nd, F = 8, 384
    frames_k = rng.randint(0, 1 << 30, (nd * nd, F)).astype(np.int32)
    frames_p = rng.randint(-2**31, 2**31, (nd * nd, F)).astype(np.int64).astype(np.int32)
    start = rng.randint(0, 128, nd * nd).astype(np.int32)
    count = rng.randint(0, 256, nd * nd).astype(np.int32)

    def jax_side(k, p, s, c):
        gk, gp = jex.all_to_all_exchange(k, p, "x")
        gs, gc = jex.all_to_all_meta(s, c, "x")
        return gk, gp, gs, gc

    want = jax.jit(jax.shard_map(jax_side, mesh=jmake_mesh(nd),
                                 in_specs=(P("x"),) * 4,
                                 out_specs=(P("x"),) * 4))(
        *(jnp.asarray(a) for a in (frames_k, frames_p, start, count)))

    def port_side(comms, k, p, s, c):
        comm = comms["x"]
        return (*tex.all_to_all_exchange(k, p, comm),
                *tex.all_to_all_meta(s, c, comm))

    per_rank = make_mesh(nd, device="cpu").run(
        port_side, *(t(a) for a in (frames_k, frames_p, start, count)))
    for got, w in zip(zip(*per_rank), want):
        np.testing.assert_array_equal(torch.cat(got).numpy(), np.asarray(w))


@pytest.mark.parametrize("method", ["sort", "group"])
def test_bucket_and_exchange_per_rank_match_jax(rng, method):
    """Bucketing then the all-to-all on every rank of 8: what each rank
    receives equals what the same JAX device receives."""
    nd, n = 8, 8 * 2048
    keys = rng.randint(0, 1 << 24, n).astype(np.int32)
    pays = rng.randint(1, 1000, n).astype(np.int32)
    cap = 640
    part_j = jex.partition_to_buckets if method == "sort" else \
        jex.partition_to_buckets_grouped
    part_t = tex.partition_to_buckets if method == "sort" else \
        tex.partition_to_buckets_grouped

    def jax_side(k, p):
        f = part_j(k, p, nd, cap, 0)
        gk, gp = jex.all_to_all_exchange(f.keys, f.pays, "x")
        return gk, gp, f.overflow[None]

    jk, jp, jov = jax.jit(jax.shard_map(
        jax_side, mesh=jmake_mesh(nd), in_specs=(P("x"), P("x")),
        out_specs=(P("x"), P("x"), P("x"))))(jnp.asarray(keys), jnp.asarray(pays))

    def port_side(comms, k, p):
        f = part_t(k, p, nd, cap, 0)
        return (*tex.all_to_all_exchange(f.keys, f.pays, comms["x"]),
                f.overflow)

    per_rank = make_mesh(nd, device="cpu").run(port_side, t(keys), t(pays))
    jk, jp = np.asarray(jk).reshape(nd, -1), np.asarray(jp).reshape(nd, -1)
    for d, (gk, gp, ov) in enumerate(per_rank):
        assert int(ov) == int(np.asarray(jov)[d])
        # a received frame from source j is a sorted (or grouped) run: keys
        # equal element for element, payloads within equal-key runs
        same_runs(gk, gp, jk[d], jp[d])
