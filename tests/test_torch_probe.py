"""The port's blocked-compare probe (ops/probe.py) and its work planner
against the JAX package's, on the same partitioned layout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu.ops import probe as jprobe
from icde2019_gpu_join_tpu.ops.partition import radix_partition as jax_partition
from icde2019_gpu_join_tpu_torch.ops import probe
from icde2019_gpu_join_tpu_torch.relation import PartitionedRelation
from icde2019_gpu_join_tpu_torch.utils import oracle as toracle
from tests.conftest import make_tables

KEY_MIX = 0x5BD1E995


def _skewed(rng, n_r=1000, n_s=8000, pays=True):
    """Zipf-like S over unique R keys: one key dominates S."""
    rk = rng.permutation(5000)[:n_r].astype(np.int32)
    sk = rk[np.minimum(rng.zipf(1.3, size=n_s) - 1, n_r - 1)].astype(np.int32)
    if not pays:
        return rk, np.ones(n_r, np.int32), sk, np.ones(n_s, np.int32)
    rp = rng.randint(-2**31, 2**31, n_r, dtype=np.int64).astype(np.int32)
    sp = rng.randint(-2**31, 2**31, n_s, dtype=np.int64).astype(np.int32)
    return rk, rp, sk, sp


def _key_payloads(rk, sk):
    return ((7 * rk.astype(np.int64) + 1).astype(np.int32),
            sk ^ np.int32(KEY_MIX))


class Case:
    """One partitioned input, in JAX and carried across to the port, with
    both packages' plans."""

    def __init__(self, rk, rp, sk, sp, bits, tile, pad_items_to=16):
        self.jr = jax_partition(jnp.asarray(rk), jnp.asarray(rp), bits, 0)
        self.js = jax_partition(jnp.asarray(sk), jnp.asarray(sp), bits, 0)
        self.tr, self.ts = (PartitionedRelation.from_numpy(
            *(np.asarray(a) for a in (p.keys, p.payload, p.counts, p.offsets)),
            bits, 0, device="cpu") for p in (self.jr, self.js))
        args = (np.asarray(self.jr.counts), np.asarray(self.jr.offsets[:-1]),
                np.asarray(self.js.counts), np.asarray(self.js.offsets[:-1]))
        self.jplan = jprobe.plan_probe(*args, tile_r=tile, tile_s=tile,
                                       pad_items_to=pad_items_to)
        self.plan = probe.plan_probe(*args, tile_r=tile, tile_s=tile,
                                     pad_items_to=pad_items_to)
        self.jdev = self.jplan.as_device()
        self.dev = self.plan.as_device(device="cpu")
        self.tiles = dict(tile_r=tile, tile_s=tile)


@pytest.mark.parametrize("dup,tile,pad", [(False, 64, 16), (True, 32, 1024),
                                          (True, 256, 7)])
def test_plan_probe_matches_jax(rng, dup, tile, pad):
    rk, rp, sk, sp = make_tables(rng, n_r=3000, n_s=9000, dup_build=dup)
    c = Case(rk, rp, sk, sp, 6, tile, pad)
    for name in ("r_start", "r_len", "s_start", "s_len"):
        g, w = getattr(c.plan, name), getattr(c.jplan, name)
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert c.plan.num_items == c.jplan.num_items
    assert c.plan.padded_items == c.jplan.padded_items
    for g, w in zip(c.dev, c.jdev):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _cases(rng):
    return {
        "pkfk": (make_tables(rng, n_r=2000, n_s=6000), 6, 64),
        "dup": (make_tables(rng, n_r=2000, n_s=6000, dup_build=True), 6, 64),
        "skew": (_skewed(rng), 4, 32),
    }


@pytest.mark.parametrize("name", ["pkfk", "dup", "skew"])
def test_blocked_aggregate_and_count_match_jax(rng, name):
    (rk, rp, sk, sp), bits, tile = _cases(rng)[name]
    c = Case(rk, rp, sk, sp, bits, tile)
    got = probe.blocked_probe_aggregate(c.tr.keys, c.tr.payload, c.ts.keys,
                                        c.ts.payload, *c.dev, **c.tiles)
    want = jprobe.blocked_probe_aggregate(c.jr.keys, c.jr.payload, c.js.keys,
                                          c.js.payload, *c.jdev, **c.tiles)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(want) == toracle.join_aggregate(rk, rp, sk, sp)
    cnt = probe.blocked_probe_count(c.tr.keys, c.ts.keys, *c.dev, **c.tiles)
    jcnt = jprobe.blocked_probe_count(c.jr.keys, c.js.keys, *c.jdev, **c.tiles)
    assert cnt.dtype == torch.int32
    assert int(cnt) == int(jcnt) == toracle.join_count(rk, sk)


@pytest.mark.parametrize("name", ["pkfk", "dup", "skew"])
def test_blocked_item_counts_match_jax(rng, name):
    (rk, rp, sk, sp), bits, tile = _cases(rng)[name]
    c = Case(rk, rp, sk, sp, bits, tile)
    got = probe.blocked_probe_item_counts(c.tr.keys, c.ts.keys, *c.dev,
                                          **c.tiles)
    want = jprobe.blocked_probe_item_counts(c.jr.keys, c.js.keys, *c.jdev,
                                            **c.tiles)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _materialize_both(c, capacity):
    counts = jprobe.blocked_probe_item_counts(c.jr.keys, c.js.keys, *c.jdev,
                                              **c.tiles)
    base = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(counts)[:-1]])
    want = jprobe.blocked_probe_materialize(
        c.jr.keys, c.jr.payload, c.js.keys, c.js.payload, *c.jdev, base,
        capacity, **c.tiles)
    got = probe.blocked_probe_materialize(
        c.tr.keys, c.tr.payload, c.ts.keys, c.ts.payload, *c.dev,
        torch.tensor(np.asarray(base)), capacity, **c.tiles)
    return got, want, np.asarray(counts)


@pytest.mark.parametrize("name", ["pkfk", "dup", "skew"])
def test_blocked_materialize_matches_jax(rng, name):
    (rk, rp, sk, sp), bits, tile = _cases(rng)[name]
    c = Case(rk, rp, sk, sp, bits, tile)
    total = toracle.join_count(rk, sk)
    (out_r, out_s), (jr, js), _ = _materialize_both(c, total + 100)
    # same layout, same item order: slot for slot
    np.testing.assert_array_equal(out_r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(out_s.numpy(), np.asarray(js))
    got = np.stack([out_r.numpy()[:total], out_s.numpy()[:total]], axis=1)
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    np.testing.assert_array_equal(got, toracle.join_materialize(rk, rp, sk, sp))
    assert not out_r.numpy()[total:].any() and not out_s.numpy()[total:].any()


def test_blocked_materialize_wrapped_ring_matches_jax(rng):
    """More matches than slots: the ring wraps, later matches win. Key-
    derived payloads, so the order of duplicate keys cannot matter; the
    capacity exceeds every JAX scan step's matches (64 items), so JAX's
    scatter has one writer per slot in each step."""
    rk, _, sk, _ = make_tables(rng, n_r=2000, n_s=6000, dup_build=True)
    rp, sp = _key_payloads(rk, sk)
    c = Case(rk, rp, sk, sp, 7, 32)
    counts = np.asarray(jprobe.blocked_probe_item_counts(
        c.jr.keys, c.js.keys, *c.jdev, **c.tiles))
    per_step = np.add.reduceat(counts, np.arange(0, counts.size, 64))
    capacity = int(per_step.max()) + 5
    total = int(counts.sum())
    assert total > 2 * capacity, "test premise: the ring laps"
    (out_r, out_s), (jr, js), _ = _materialize_both(c, capacity)
    np.testing.assert_array_equal(out_r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(out_s.numpy(), np.asarray(js))


def _ring_reference(c, capacity):
    """The ring as a numpy walk of the matches in item order, row-major
    within an item: slot j holds the last match m with m mod capacity == j."""
    rk, rp = c.tr.keys.numpy(), c.tr.payload.numpy()
    sk, sp = c.ts.keys.numpy(), c.ts.payload.numpy()
    stream = []
    for w in range(c.plan.num_items):
        r0, rl = c.plan.r_start[w], c.plan.r_len[w]
        s0, sl = c.plan.s_start[w], c.plan.s_len[w]
        i, j = np.nonzero(rk[r0:r0 + rl, None] == sk[None, s0:s0 + sl])
        stream.append(np.stack([rp[r0 + i], sp[s0 + j]], axis=1))
    stream = np.concatenate(stream)
    ring = np.zeros((capacity, 2), np.int32)
    ring[np.arange(stream.shape[0]) % capacity] = stream   # last write wins
    return ring


@pytest.mark.parametrize("elems", [1, 1 << 12, 1 << 26])
def test_blocked_materialize_ring_any_batching(rng, monkeypatch, elems):
    """Batches of one item up to all items at once, a ring far smaller than
    one batch's matches: every slot holds its last match."""
    rk, rp, sk, sp = _skewed(rng)
    c = Case(rk, rp, sk, sp, 4, 32)
    monkeypatch.setattr(probe, "_ITEM_ELEMS", elems)
    counts = probe.blocked_probe_item_counts(c.tr.keys, c.ts.keys, *c.dev,
                                             **c.tiles)
    base = torch.cumsum(counts, 0) - counts
    out_r, out_s = probe.blocked_probe_materialize(
        c.tr.keys, c.tr.payload, c.ts.keys, c.ts.payload, *c.dev, base, 97,
        **c.tiles)
    ring = _ring_reference(c, 97)
    np.testing.assert_array_equal(out_r.numpy(), ring[:, 0])
    np.testing.assert_array_equal(out_s.numpy(), ring[:, 1])


@pytest.mark.parametrize("elems", [1, 1 << 13])
def test_blocked_sums_do_not_depend_on_batching(rng, monkeypatch, elems):
    rk, rp, sk, sp = make_tables(rng, n_r=1500, n_s=5000, dup_build=True)
    c = Case(rk, rp, sk, sp, 5, 64)
    args = (c.tr.keys, c.tr.payload, c.ts.keys, c.ts.payload, *c.dev)
    whole = (int(probe.blocked_probe_aggregate(*args, **c.tiles)),
             int(probe.blocked_probe_late_aggregate(*args, **c.tiles)),
             probe.blocked_probe_item_counts(c.tr.keys, c.ts.keys, *c.dev,
                                             **c.tiles))
    monkeypatch.setattr(probe, "_ITEM_ELEMS", elems)
    assert int(probe.blocked_probe_aggregate(*args, **c.tiles)) == whole[0]
    assert int(probe.blocked_probe_late_aggregate(*args, **c.tiles)) == whole[1]
    assert torch.equal(probe.blocked_probe_item_counts(
        c.tr.keys, c.ts.keys, *c.dev, **c.tiles), whole[2])


@pytest.mark.parametrize("name", ["pkfk", "dup", "skew"])
def test_blocked_late_aggregate_matches_jax(rng, name):
    (rk, _, sk, _), bits, tile = _cases(rng)[name]
    n_r, n_s = rk.size, sk.size
    r_cols = rng.randint(-2**31, 2**31, (n_r, 3), dtype=np.int64).astype(np.int32)
    s_cols = rng.randint(-2**31, 2**31, (n_s, 2), dtype=np.int64).astype(np.int32)
    r_ids = np.arange(n_r, dtype=np.int32)
    s_ids = rng.permutation(n_s).astype(np.int32)
    c = Case(rk, r_ids, sk, s_ids, bits, tile)
    r_colsum = jnp.sum(jnp.asarray(r_cols).astype(jnp.uint32), axis=1)[
        c.jr.payload].astype(jnp.int32)
    s_colsum = jnp.sum(jnp.asarray(s_cols).astype(jnp.uint32), axis=1)[
        c.js.payload].astype(jnp.int32)
    want = jprobe.blocked_probe_late_aggregate(
        c.jr.keys, r_colsum, c.js.keys, s_colsum, *c.jdev, **c.tiles)
    got = probe.blocked_probe_late_aggregate(
        c.tr.keys, torch.tensor(np.asarray(r_colsum)), c.ts.keys,
        torch.tensor(np.asarray(s_colsum)), *c.dev, **c.tiles)
    assert int(got) == int(want) == toracle.join_late_materialize_sum(
        rk, r_ids, sk, s_ids, r_cols, s_cols)


def test_blocked_probe_with_an_empty_side_is_zero(rng):
    rk = rng.permutation(100).astype(np.int32)
    c = Case(rk, rk, rk, rk, 4, 32)
    z = torch.zeros(0, dtype=torch.int32)
    assert int(probe.blocked_probe_aggregate(c.tr.keys, c.tr.payload, z, z,
                                             *c.dev, **c.tiles)) == 0
    assert int(probe.blocked_probe_count(z, c.ts.keys, *c.dev, **c.tiles)) == 0
    counts = probe.blocked_probe_item_counts(z, z, *c.dev, **c.tiles)
    assert counts.shape == (c.plan.padded_items,) and not counts.any()


@pytest.mark.parametrize("capacity", [1000003, 3 << 20, 1 << 24])
@pytest.mark.parametrize("start", [2**31 - 40, 2**31 + 5, 2**32 - 20,
                                   2**32 + 100, 12345])
def test_ring_slot_wraps_to_int32_as_jax_does(start, capacity):
    """The slot of a join's m-th match past 2^31 - 1 matches: the reference
    adds an item's base and the match's place in int32 (ops/probe.py,
    `pos = (base + local) % capacity`), so the sum wraps before the modulo.
    With a capacity that is not a power of two the unwrapped modulo differs."""
    local = np.arange(64, dtype=np.int64)
    index = start + local                      # the port's int64 match index
    base = np.int64(start).astype(np.int32)    # what JAX's int32 base holds
    want = np.asarray((jnp.asarray(base) + jnp.asarray(local.astype(np.int32)))
                      % capacity)
    got = probe.ring_slot(torch.from_numpy(index), capacity).numpy()
    assert got.min() >= 0 and got.max() < capacity
    np.testing.assert_array_equal(got, want)
    if start >= 2**31 - 40 and start < 2**32 and capacity & (capacity - 1):
        assert not np.array_equal(got, index % capacity)
