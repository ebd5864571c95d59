"""The port's stream-range probe (ops/probe_ranges.py): its planner, padding
and plain version against the JAX package's, whose Pallas kernel runs here
in interpret mode as tests/test_probe_pallas.py runs it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu.ops import probe_pallas as jpp
from icde2019_gpu_join_tpu.ops.partition import radix_partition as jax_partition
from icde2019_gpu_join_tpu_torch.ops import _launches
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
    _launches.reset()
    assert pr_.LAUNCHES == {"probe_aggregate_ranges": 0}


# ---- the CUDA kernel's hash table, modelled in numpy --------------------------
# csrc/probe_ranges.cu: an R sub-tile of SUB rows goes into a table of SLOTS
# slots; a key's slot is the top SLOT_BITS bits of key * HASH_MUL (mod 2^32),
# collisions probe linearly and wrap; a block takes ITEMS_PER_BLOCK items
# and builds one table per run of items of one R tile, per sub-tile.

SUB, SLOT_BITS, HASH_MUL, ITEMS_PER_BLOCK = 1024, 11, 0x9E3779B1, 8
SLOTS = 1 << SLOT_BITS
EMPTY = -(1 << 32)   # no int32 key: the kernel's empty slot is 0, a key's
                     # (1 << 32) | (uint32)key


def _slot(keys) -> np.ndarray:
    k = np.asarray(keys, np.int32).view(np.uint32).astype(np.uint64)
    return ((k * HASH_MUL) & 0xFFFFFFFF) >> (32 - SLOT_BITS)


def _build(keys, pays):
    """The table of one sub-tile, rows inserted in order (the kernel's
    atomics land in some order; the sums do not depend on it): (the key
    of each slot, EMPTY where empty, as int64; the uint32 sums; the longest
    probe sequence an insert walked)."""
    tags = np.full(SLOTS, EMPTY, np.int64)
    sums = np.zeros(SLOTS, np.uint64)
    longest = 0
    for key, pay, s in zip(keys.tolist(), pays.tolist(), _slot(keys).tolist()):
        steps = 1
        while tags[s] not in (EMPTY, key):
            s, steps = (s + 1) & (SLOTS - 1), steps + 1
        tags[s] = key
        sums[s] = (sums[s] + (pay & 0xFFFFFFFF)) & 0xFFFFFFFF
        longest = max(longest, steps)
    return tags, sums, longest


def _lookup(tags, sums, keys):
    """Each key's sum (0 if absent), walking every key's probe sequence at
    once until it meets its key or an empty slot; and the longest walk."""
    keys = np.asarray(keys, np.int64)
    s = _slot(keys).astype(np.int64)
    out = np.zeros(keys.size, np.uint64)
    active = np.ones(keys.size, bool)
    steps = 0
    while active.any():
        steps += 1
        cur = tags[s]
        hit = active & (cur == keys)
        out[hit] = sums[s[hit]]
        active &= ~hit & (cur != EMPTY)
        s = (s + 1) & (SLOTS - 1)
    return out, steps


def _kernel5_model(cols, s_start, s_nch, tr, ts):
    """The kernel's sum mod 2^32 as an int32, its table builds, and the
    longest probe sequence of any insert or lookup."""
    rk, rp, sk, sp = cols
    tile, s0 = pr_._items(s_start, s_nch, sk.size, ts)
    total, builds, longest = 0, 0, 0
    tables = {}
    for b in range(0, tile.size, ITEMS_PER_BLOCK):
        blk_tile, blk_s0 = tile[b:b + ITEMS_PER_BLOCK], s0[b:b + ITEMS_PER_BLOCK]
        i = 0
        while i < blk_tile.size:
            j = i + 1
            while j < blk_tile.size and blk_tile[j] == blk_tile[i]:
                j += 1
            for sub in range(0, tr, SUB):
                r0 = int(blk_tile[i]) * tr + sub
                if (r0, 0) not in tables:
                    tables[r0, 0] = _build(rk[r0:r0 + SUB], rp[r0:r0 + SUB])
                tags, sums, chain = tables[r0, 0]
                builds += 1
                longest = max(longest, chain)
                for start in blk_s0[i:j]:
                    sl = slice(int(start), int(start) + ts)
                    got, steps = _lookup(tags, sums, sk[sl])
                    longest = max(longest, steps)
                    total += int(((got * (sp[sl].astype(np.int64)
                                          & 0xFFFFFFFF).astype(np.uint64))
                                  & 0xFFFFFFFF).sum())
            i = j
    wrapped = np.array([total & 0xFFFFFFFF], np.uint32).view(np.int32)[0]
    return int(wrapped), builds, longest


def _one_slot_keys(n, slot=SLOTS - 1):
    """n distinct keys whose slot is `slot`: k = (slot << 21 | j) / HASH_MUL
    mod 2^32."""
    inv = pow(HASH_MUL, -1, 1 << 32)
    k = [((slot << (32 - SLOT_BITS) | j) * inv) & 0xFFFFFFFF for j in range(n)]
    return np.array(k, np.uint32).view(np.int32)


INT32_EDGES = np.array([-2**31, -1, 0, 2**31 - 1], np.int32)


def _edge_plan(rng, case):
    """Columns and a synthetic plan for each edge of the table: (cols,
    s_start, s_nch, tr, ts)."""
    tr, ts, n_tiles, n_chunks = 1024, 256, 4, 6
    if case == "tile_r_2048":
        tr = 2048
    elif case in ("tile_s_128", "tile_s_1152"):
        ts = int(case.rsplit("_", 1)[1])
        n_chunks = 4 if ts == 1152 else 24
    n_r, n_s = n_tiles * tr, n_chunks * ts
    rk = rng.randint(0, 3000, n_r).astype(np.int32)
    sk = rng.randint(0, 3000, n_s).astype(np.int32)
    if case == "one_key":
        rk[tr:2 * tr] = 12345               # a whole tile of one key
        sk[rng.rand(n_s) < 0.3] = 12345
    elif case in ("low13", "low18"):
        bits = int(case[3:])
        d = rng.randint(0, 1 << (31 - bits), n_r + n_s).astype(np.int64)
        keys = ((d << bits) | 0x155).astype(np.int64)
        keys = np.where(rng.rand(keys.size) < 0.5, keys, -keys - 1)
        rk, sk = keys[:n_r].astype(np.int32), keys[n_r:].astype(np.int32)
        sk[::3] = rk[rng.randint(0, n_r, sk[::3].size)]
    elif case == "int32_edges":
        rk[::5] = INT32_EDGES[rng.randint(0, 4, rk[::5].size)]
        sk[::3] = INT32_EDGES[rng.randint(0, 4, sk[::3].size)]
    elif case == "longest_chain":
        rk[:tr] = rng.permutation(_one_slot_keys(tr))   # wraps past slot 2047
        sk[:ts] = rk[rng.randint(0, 2 * tr, ts)]
    s_start = (rng.randint(0, n_chunks, n_tiles) * ts).astype(np.int32)
    s_nch = rng.randint(1, n_chunks + 1, n_tiles).astype(np.int32)
    if case == "empty_ranges":
        s_nch[[0, 2]] = 0
    elif case == "longest_chain":
        s_start[0], s_nch[0] = 0, 1
    return [rk, _full(rng, n_r), sk, _full(rng, n_s)], s_start, s_nch, tr, ts


EDGE_PLANS = ["one_key", "low13", "low18", "int32_edges", "tile_r_2048",
              "tile_s_128", "tile_s_1152", "empty_ranges", "longest_chain"]


@pytest.mark.parametrize("case", EDGE_PLANS)
def test_kernel_model_matches_ref_and_jax_on_edge_plans(case):
    rng = np.random.RandomState(EDGE_PLANS.index(case))
    cols, s_start, s_nch, tr, ts = _edge_plan(rng, case)
    got, builds, longest = _kernel5_model(cols, s_start, s_nch, tr, ts)
    assert got == int(_port_ref(cols, s_start, s_nch, tr, ts))
    assert got == _jax_kernel(cols, s_start, s_nch, tr, ts)
    items = pr_._items(s_start, s_nch, cols[2].size, ts)[0].size
    assert builds <= items * (tr // SUB)
    if case == "longest_chain":
        assert longest == SUB       # every key of the tile in one slot
    elif case in ("low13", "low18", "one_key"):
        assert longest < 64         # the hash spreads the shared low bits
    if case == "empty_ranges":
        assert (s_nch == 0).sum() == 2
    if case == "int32_edges":
        assert np.isin(INT32_EDGES, cols[0]).all()
        assert np.isin(INT32_EDGES, cols[2]).all()


@pytest.mark.parametrize("case", ["pkfk", "dup", "skew", "many_chunks"])
def test_kernel_model_matches_jax_on_partitioned_plans(rng, case):
    """The engine's own plans: partitions of a tile share their low bits."""
    tr, ts, bits = 1024, 1024, 6
    if case == "pkfk":
        rk, rp, sk, sp = make_tables(rng, n_r=3000, n_s=9000)
    elif case == "dup":
        rk, rp, sk, sp = make_tables(rng, n_r=3000, n_s=9000, dup_build=True)
    elif case == "skew":
        (rk, rp, sk, sp), bits = _skewed(rng), 4
    else:
        (rk, rp, sk, sp), bits, ts = _skewed(rng, 1000, 20000), 2, 128
    cols, s_start, s_nch = _partitioned(rk, rp, sk, sp, bits, tr, ts)
    got, _, _ = _kernel5_model(cols, s_start, s_nch, tr, ts)
    assert got == _jax_kernel(cols, s_start, s_nch, tr, ts)
    assert got == toracle.join_aggregate(rk, rp, sk, sp)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_model_does_not_depend_on_row_order(seed):
    """Rows permuted inside each R tile and each S chunk (the contract does
    not promise sorted rows): the table, and so the sum, are the same."""
    rng = np.random.RandomState(seed)
    cols, s_start, s_nch, tr, ts = _edge_plan(rng, "one_key")
    want = _kernel5_model(cols, s_start, s_nch, tr, ts)[0]
    rk, rp, sk, sp = (c.copy() for c in cols)
    for lo in range(0, rk.size, tr):
        p = lo + rng.permutation(tr)
        rk[lo:lo + tr], rp[lo:lo + tr] = rk[p], rp[p]
    for lo in range(0, sk.size, ts):
        p = lo + rng.permutation(ts)
        sk[lo:lo + ts], sp[lo:lo + ts] = sk[p], sp[p]
    shuffled = [rk, rp, sk, sp]
    assert _kernel5_model(shuffled, s_start, s_nch, tr, ts)[0] == want
    assert int(_port_ref(shuffled, s_start, s_nch, tr, ts)) == want


def test_one_slot_keys_share_their_slot():
    keys = _one_slot_keys(SUB, slot=5)
    assert np.unique(keys).size == SUB and (_slot(keys) == 5).all()
    tags, _, longest = _build(keys, np.ones(SUB, np.int32))
    assert longest == SUB and (tags[5:5 + SUB] != EMPTY).all()


def test_builds_once_a_run_of_items():
    """Items of one R tile in one block's run share a table: a tile with 16
    chunks builds twice (two blocks of 8), and 16 tiles of one chunk 16
    times."""
    cols = [np.zeros(16 * 1024, np.int32), np.zeros(16 * 1024, np.int32),
            np.zeros(16 * 128, np.int32), np.zeros(16 * 128, np.int32)]
    s_start = np.zeros(16, np.int32)
    one_tile = np.array([16] + [0] * 15, np.int32)
    assert _kernel5_model(cols, s_start, one_tile, 1024, 128)[1] == 2
    assert _kernel5_model(cols, s_start, np.ones(16, np.int32), 1024, 128)[1] == 16
