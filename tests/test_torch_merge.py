"""The port's ops/merge.py against the JAX merge-tree sort
(ops/merge_pallas.py), whose Pallas kernels run here in interpret mode as
tests/test_merge_pallas.py runs them. Integers throughout: no tolerance.

Given the same encoded input a level is deterministic, so every
level-granular function is compared element for element, keys and payloads.
After `encode_base_runs` the two frameworks' unstable sorts may order the
payloads of equal keys differently, so whole sorts are compared as sorted
keys plus the (key, payload) multiset."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu.ops import merge_pallas as mp
from icde2019_gpu_join_tpu_torch.ops import merge
from tests.test_merge_pallas import check_pairs, encode_runs, make


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _np(pair):
    return tuple(np.asarray(x) for x in pair)


def _assert_pairs_equal(got, want):
    for g, w, what in zip(_np(got), _np(want), ("keys", "payloads")):
        np.testing.assert_array_equal(g, w, err_msg=what)


def _jax_meta(es, run_len, window):
    """The reference's meta table, recomputed from its own splits with the
    formulas of `merge_pallas.merge_level_hbm` (the table is built inside
    that jitted function and never returned)."""
    tile_out = window - 128
    a, b, p, o, abase, bbase = (np.asarray(x).astype(np.int64) for x in
                                mp._merge_path_splits(jnp.asarray(es), run_len,
                                                      tile_out))
    pair = 2 * run_len
    a0 = np.minimum(a & ~127, run_len - window)
    b0 = np.minimum(b & ~127, run_len - window)
    tpp = a.size // (es.size // pair)
    ends = np.full((es.size // pair, 1), run_len)
    a_hi = np.concatenate([a.reshape(-1, tpp)[:, 1:], ends], 1).reshape(-1)
    b_hi = np.concatenate([b.reshape(-1, tpp)[:, 1:], ends], 1).reshape(-1)
    return np.stack([
        (abase + a0) // 128, (bbase + run_len - b0 - window) // 128,
        a - a0, a_hi - a0, window - (b_hi - b0), window - (b - b0),
        (p * pair + o) // 128]).astype(np.int32)


def test_constants_match_jax():
    for name in ("INT_MIN", "INT_MAX", "BASE_RUN", "DEVICE_VMEM_TILE",
                 "HBM_WINDOW", "HBM_TILE_OUT", "CASCADE_MAX_N"):
        assert getattr(merge, name) == getattr(mp, name), name


# ---- kernel 6: merge_levels_vmem -------------------------------------------

@pytest.mark.parametrize("lane_transpose", [False, True])
@pytest.mark.parametrize("n,run,levels,jax_tile,lo,hi", [
    (4096, 256, 3, 2048, 0, 500),             # one output run per tile
    (8192, 256, 2, 1024, -50, 50),            # several tiles, odd parities
    (4096, 128, 1, 4096, -(2**31), 2**31),    # full-range keys, one tile
    (8192, 512, 2, 8192, 0, 64),              # a tile of several output runs
])
def test_merge_levels_vmem_equals_jax(n, run, levels, jax_tile, lo, hi,
                                      lane_transpose):
    sv, pv = make(n, np.random.RandomState(n + run + levels), lo=lo, hi=hi)
    es, ep = encode_runs(sv, pv, run)
    want = mp.merge_levels_vmem(
        jnp.asarray(es), jnp.asarray(ep), run, levels, tile_elems=jax_tile,
        interpret=True, lane_transpose=lane_transpose)
    # the result does not depend on the tile: the reference's, a larger one
    # and the default all give the reference's arrays
    for tile in (jax_tile, 4 * n, merge.DEVICE_VMEM_TILE):
        _assert_pairs_equal(
            merge.merge_levels_vmem(*_t(es, ep), run, levels, tile_elems=tile),
            want)
    _assert_pairs_equal(merge.merge_levels_vmem_ref(*_t(es, ep), run, levels),
                        want)


def test_cpu_tensors_take_the_plain_versions():
    sv, pv = make(1 << 16, np.random.RandomState(5), lo=0, hi=1000)
    before = dict(merge.LAUNCHES)
    es, ep = encode_runs(sv, pv, 4096)
    merge.merge_levels_vmem(*_t(es, ep), 4096, 2)
    es, ep = encode_runs(sv, pv, 1 << 14)
    merge.merge_level_hbm(*_t(es, ep), 1 << 14)
    assert merge.LAUNCHES == before


def test_plain_version_takes_runs_longer_than_a_block():
    n, run, levels = 1 << 16, 1 << 13, 2          # span 2^15 > MAX_BLOCK_ELEMS
    assert run << levels > merge.MAX_BLOCK_ELEMS
    sv, pv = make(n, np.random.RandomState(6), lo=0, hi=3000)
    es, ep = encode_runs(sv, pv, run)
    want = mp.merge_levels_vmem(jnp.asarray(es), jnp.asarray(ep), run, levels,
                                tile_elems=1 << 15, interpret=True)
    _assert_pairs_equal(
        merge.merge_levels_vmem(*_t(es, ep), run, levels, tile_elems=1 << 15),
        want)


@pytest.mark.parametrize("bad", ["dtype", "length", "strided", "run", "span",
                                 "levels"])
def test_merge_levels_rejects_bad_inputs(bad):
    sv, pv = _t(*make(4096, np.random.RandomState(1)))
    run, levels = 256, 2
    if bad == "dtype":
        sv = sv.long()
    elif bad == "length":
        pv = pv[:2048]
    elif bad == "strided":
        sv, pv = sv[::2], pv[::2]
    elif bad == "run":
        run = 192
    elif bad == "span":
        run, levels = 2048, 2
    elif bad == "levels":
        levels = 0
    with pytest.raises(ValueError):
        merge.merge_levels_vmem(sv, pv, run, levels)


# ---- kernel 7: the planner, the meta table, merge_level_hbm ----------------

@pytest.mark.parametrize("seed,lo,hi,run,window", [
    (0, -(2**31), 2**31, 2 * mp.HBM_WINDOW, mp.HBM_WINDOW),
    (1, 0, 64, 2 * mp.HBM_WINDOW, mp.HBM_WINDOW),
    (2, -(2**31), 2**31, 2 * mp.HBM_WINDOW, 2 * mp.HBM_WINDOW),
    (3, 0, 1000, 4 * mp.HBM_WINDOW, mp.HBM_WINDOW),
    (4, -5, 5, mp.HBM_WINDOW, mp.HBM_WINDOW),
])
def test_splits_and_meta_equal_jax(seed, lo, hi, run, window):
    n = 4 * run    # two pairs: an even one and an odd (encoded) one
    sv, pv = make(n, np.random.RandomState(seed), lo=lo, hi=hi)
    es, _ = encode_runs(sv, pv, run)
    want = mp._merge_path_splits(jnp.asarray(es), run, window - 128)
    got = merge._merge_path_splits(torch.from_numpy(es), run, window - 128)
    assert len(got) == len(want) == 6
    for g, w, name in zip(got, want, ("a", "b", "p", "o", "abase", "bbase")):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    meta = merge.merge_level_meta(torch.from_numpy(es), run, window)
    assert meta.dtype == torch.int32 and meta.shape[0] == 7
    want_meta = _jax_meta(es, run, window)
    for row in range(7):
        np.testing.assert_array_equal(meta[row].numpy(), want_meta[row],
                                      err_msg=f"meta row {row}")


@pytest.mark.parametrize("seed,lo,hi,window,db,lt", [
    (0, -(2**31), 2**31, mp.HBM_WINDOW, False, False),
    (1, 0, 64, mp.HBM_WINDOW, False, False),
    (2, -(2**31), 2**31, 2 * mp.HBM_WINDOW, False, False),
    (3, -(2**31), 2**31, mp.HBM_WINDOW, True, False),
    (4, 0, 64, mp.HBM_WINDOW, True, False),
    (5, -(2**31), 2**31, mp.HBM_WINDOW, False, True),
    (6, -(2**31), 2**31, mp.HBM_WINDOW, True, True),
])
def test_merge_level_hbm_equals_jax(seed, lo, hi, window, db, lt):
    """The seven cases of tests/test_merge_pallas.py::test_hbm_level."""
    run = 2 * mp.HBM_WINDOW
    n = 4 * run
    sv, pv = make(n, np.random.RandomState(seed), lo=lo, hi=hi)
    es, ep = encode_runs(sv, pv, run)
    want = mp.merge_level_hbm(
        jnp.asarray(es), jnp.asarray(ep), run, interpret=True, window=window,
        double_buffer=db, lane_transpose=lt)
    got = merge.merge_level_hbm(*_t(es, ep), run, window=window,
                                double_buffer=db)
    _assert_pairs_equal(got, want)
    _assert_pairs_equal(merge.merge_level_hbm_ref(*_t(es, ep), run, window),
                        want)


def _valid_rows_only(es, ep, meta, window):
    """What a block-per-tile kernel may write when blocks run in no order:
    each tile's valid rows and nothing else (numpy, tile by tile)."""
    osv = np.full_like(es, 0x55555555)
    opv = np.full_like(ep, 0x55555555)
    written = np.zeros(es.size, np.int32)
    idx = np.arange(window)
    for t in np.random.RandomState(0).permutation(meta.shape[1]):
        a_row, b_row, a_lo, a_hi, b_wlo, b_whi, out_row = meta[:, t]
        sa = slice(a_row * 128, a_row * 128 + window)
        sb = slice(b_row * 128, b_row * 128 + window)
        ka = np.where(idx < a_lo, mp.INT_MIN, es[sa])
        ka = np.where(idx >= a_hi, mp.INT_MAX, ka)
        kb = np.where(idx < b_wlo, mp.INT_MAX, ~es[sb])
        kb = np.where(idx >= b_whi, mp.INT_MIN, kb)
        k, q = merge._bitonic_merge_pairs(
            *_t(np.concatenate([ka, kb]).astype(np.int32),
                np.concatenate([ep[sa], ep[sb]])), window)
        front = a_lo + window - b_whi
        count = (a_hi - a_lo) + (b_whi - b_wlo)
        out = slice(out_row * 128, out_row * 128 + count)
        osv[out] = k.numpy()[front:front + count]
        opv[out] = q.numpy()[front:front + count]
        written[out] += 1
    return osv, opv, written


@pytest.mark.parametrize("lo,hi", [(-(2**31), 2**31), (0, 64)])
def test_short_second_to_last_tile(lo, hi):
    """pair = 2^15 against tile_out = 8064: five tiles a pair, the fourth
    holds 512 valid rows and the fifth re-covers its junk. Writing only the
    valid rows, in any tile order, gives the reference's arrays, and no row
    is written twice."""
    run, window = 1 << 14, mp.HBM_WINDOW
    n = 4 * run
    sv, pv = make(n, np.random.RandomState(11), lo=lo, hi=hi)
    es, ep = encode_runs(sv, pv, run)
    meta = merge.merge_level_meta(torch.from_numpy(es), run, window).numpy()
    assert meta.shape == (7, 10)
    count = (meta[3] - meta[2]) + (meta[5] - meta[4])
    assert count.tolist() == [8064, 8064, 8064, 512, 8064] * 2
    assert ((meta[2] + window - meta[5]) % 128 == 0).all()
    want = mp.merge_level_hbm(jnp.asarray(es), jnp.asarray(ep), run,
                              interpret=True, window=window)
    _assert_pairs_equal(merge.merge_level_hbm(*_t(es, ep), run), want)
    osv, opv, written = _valid_rows_only(es, ep, meta, window)
    assert (written == 1).all()
    _assert_pairs_equal((osv, opv), want)


@pytest.mark.parametrize("bad", ["run_below_window", "length", "window",
                                 "meta_shape", "meta_dtype"])
def test_merge_level_rejects_bad_inputs(bad):
    run, window = 1 << 14, mp.HBM_WINDOW
    sv, pv = _t(*make(4 * run, np.random.RandomState(2)))
    if bad in ("meta_shape", "meta_dtype"):
        meta = merge.merge_level_meta(sv, run, window)
        meta = meta[:6].contiguous() if bad == "meta_shape" else meta.long()
        with pytest.raises(ValueError):
            merge.merge_tiles(sv, pv, meta, window)
        return
    if bad == "run_below_window":
        run = window // 2
    elif bad == "length":
        sv, pv = sv[:3 * run].contiguous(), pv[:3 * run].contiguous()
    elif bad == "window":
        window = 6000
    with pytest.raises(ValueError):
        merge.merge_level_hbm(sv, pv, run, window=window)


# ---- whole sorts ------------------------------------------------------------

def test_encode_base_runs_matches_jax_per_run():
    n = 4 * mp.BASE_RUN
    sv, pv = make(n, np.random.RandomState(7), lo=-300, hi=300)
    got = _np(merge.encode_base_runs(*_t(sv, pv)))
    want = _np(mp.encode_base_runs(jnp.asarray(sv), jnp.asarray(pv)))
    np.testing.assert_array_equal(got[0], want[0])     # stored keys: exact
    for i in range(n // mp.BASE_RUN):                  # payloads: multiset
        sl = slice(i * mp.BASE_RUN, (i + 1) * mp.BASE_RUN)
        stored = sv[sl] ^ np.int32(-(i & 1))
        check_pairs(got[0][sl], got[1][sl], stored, pv[sl])


@pytest.mark.parametrize("n,lo,hi,vmem_tile", [
    (4 * mp.BASE_RUN, -(2**31), 2**31, mp.DEVICE_VMEM_TILE),   # in-block only
    (8 * mp.HBM_WINDOW, 0, 1000, 2 * mp.HBM_WINDOW),           # + HBM levels
    (16 * mp.HBM_WINDOW, -(2**31), 2**31, mp.DEVICE_VMEM_TILE),
])
def test_cascade_sorts_like_jax(n, lo, hi, vmem_tile):
    sv, pv = make(n, np.random.RandomState(n % 1000), lo=lo, hi=hi)
    # the port's cascade always builds runs of DEVICE_VMEM_TILE in-block
    assert vmem_tile == merge.DEVICE_VMEM_TILE
    got = _np(merge._merge_sort_cascade(*_t(sv, pv)))
    want = _np(mp._merge_sort_cascade(jnp.asarray(sv), jnp.asarray(pv),
                                      interpret=True, vmem_tile=vmem_tile))
    np.testing.assert_array_equal(got[0], want[0])
    check_pairs(*got, sv, pv)
    check_pairs(*want, sv, pv)


def _sentinel_free(n, seed, lo=-(2**31) + 1, hi=2**31 - 1):
    return make(n, np.random.RandomState(seed), lo=lo, hi=hi)


def test_merge_sort_pairs_takes_the_cascade():
    n = 4 * mp.BASE_RUN
    sv, pv = _sentinel_free(n, 8, lo=-40, hi=40)
    merge.reset_launches()
    got = _np(merge.merge_sort_pairs(*_t(sv, pv)))
    assert merge.ROUTES == {"cascade": 1, "fallback": 0}
    want = _np(mp.merge_sort_pairs(jnp.asarray(sv), jnp.asarray(pv),
                                   interpret=True))
    np.testing.assert_array_equal(got[0], want[0])
    check_pairs(*got, sv, pv)


@pytest.mark.parametrize("case", ["int_min", "int_max", "non_pow2",
                                  "too_small"])
def test_merge_sort_pairs_fallbacks(case, monkeypatch):
    n = {"non_pow2": 3 * mp.BASE_RUN, "too_small": mp.BASE_RUN}.get(
        case, 4 * mp.BASE_RUN)
    sv, pv = _sentinel_free(n, 9)
    if case == "int_min":
        sv[123] = mp.INT_MIN
    elif case == "int_max":
        sv[456] = mp.INT_MAX

    def no_cascade(*args, **kwargs):
        raise AssertionError("the cascade ran")

    monkeypatch.setattr(merge, "_merge_sort_cascade", no_cascade)
    merge.reset_launches()
    got = _np(merge.merge_sort_pairs(*_t(sv, pv)))
    assert merge.ROUTES == {"cascade": 0, "fallback": 1}
    want = _np(mp.merge_sort_pairs(jnp.asarray(sv), jnp.asarray(pv),
                                   interpret=True))
    np.testing.assert_array_equal(got[0], want[0])
    check_pairs(*got, sv, pv)


@pytest.mark.parametrize("n,lo,hi", [
    (4096, -(2**31), 2**31), (5000, 0, 7), (1, 3, 4), (0, 0, 1),
])
def test_packed_sort_pairs_equals_jax(n, lo, hi):
    sv, pv = make(n, np.random.RandomState(n + 1), lo=lo, hi=hi)
    if n > 2:
        sv[0], sv[1] = mp.INT_MIN, mp.INT_MAX
        pv[0], pv[1] = -1, mp.INT_MIN     # payload order is unsigned
    got = merge.packed_sort_pairs(*_t(sv, pv))
    assert got[0].dtype == got[1].dtype == torch.int32
    _assert_pairs_equal(got, mp.packed_sort_pairs(jnp.asarray(sv),
                                                  jnp.asarray(pv)))


def test_reset_launches_zeroes_routes_too():
    merge.ROUTES["fallback"] += 3
    merge.LAUNCHES["merge_level_hbm"] += 2
    merge.LAUNCHES["merge_level_plan"] += 2
    merge.reset_launches()
    assert set(merge.ROUTES.values()) | set(merge.LAUNCHES.values()) == {0}
    assert set(merge.LAUNCHES) == {"merge_levels_vmem", "merge_level_plan",
                                   "merge_level_hbm"}


# ---- kernel 7's planner on the card: its wrapper and its per-tile loop ------

def _plan_split(sv, abase: int, bbase: int, run_len: int, o: int) -> int:
    """The split of pair-local output offset o, by the upper-bound search
    of `_merge_path_splits` for one diagonal: the largest a in
    [max(0, o - run_len), min(o, run_len)] with A[a - 1] <= Bv[o - a]. `sv`
    is indexable by int (a list, or a numpy array of int32)."""
    lo = max(o - run_len, 0)
    hi = min(o, run_len)
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        a_prev = int(sv[abase + mid - 1]) if mid >= 1 else mp.INT_MIN
        bj = o - mid
        b_at = ~int(sv[bbase + run_len - 1 - bj]) if bj < run_len else mp.INT_MAX
        if a_prev <= b_at:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _plan_tile(sv, run_len: int, window: int, t: int) -> tuple:
    """Column t of the plan table as the kernel `tj_merge_level_plan`
    (csrc/merge.cu) computes it, one thread a tile: the loop the CUDA code
    follows line for line, in scalar Python."""
    pair = 2 * run_len
    tile_out = window - 128
    tiles_per_pair = -(-pair // tile_out)
    p, j = divmod(t, tiles_per_pair)
    last = pair - tile_out
    o = min(j * tile_out, last)
    par = p & 1
    abase = p * pair + par * run_len
    bbase = p * pair + (1 - par) * run_len
    a = _plan_split(sv, abase, bbase, run_len, o)
    b = o - a
    a_end = b_end = run_len
    if j + 1 < tiles_per_pair:
        o2 = min((j + 1) * tile_out, last)
        a_end = _plan_split(sv, abase, bbase, run_len, o2)
        b_end = o2 - a_end
    cap = run_len - window
    a0 = min(a & ~127, cap)
    b0 = min(b & ~127, cap)
    return ((abase + a0) // 128, (bbase + run_len - b0 - window) // 128,
            a - a0, a_end - a0, window - (b_end - b0), window - (b - b0),
            (p * pair + o) // 128)


PLAN_CASES = [   # the cases of test_splits_and_meta_equal_jax, and two more
    (0, -(2**31), 2**31, 2 * mp.HBM_WINDOW, mp.HBM_WINDOW),
    (1, 0, 64, 2 * mp.HBM_WINDOW, mp.HBM_WINDOW),          # duplicate-heavy
    (2, -(2**31), 2**31, 2 * mp.HBM_WINDOW, 2 * mp.HBM_WINDOW),  # run == window
    (3, 0, 1000, 4 * mp.HBM_WINDOW, mp.HBM_WINDOW),
    (4, -5, 5, mp.HBM_WINDOW, mp.HBM_WINDOW),              # run == window
    (5, 0, 3, 4096, 1024),                                 # a smaller window
    (6, 7, 8, 2048, 256),                                  # one key only
]


@pytest.mark.parametrize("seed,lo,hi,run,window", PLAN_CASES)
def test_plan_tile_loop_equals_meta_and_jax(seed, lo, hi, run, window):
    """`_plan_tile`, the scalar rendering of the plan kernel's per-tile
    loop, column by column against the torch planner's table and against
    the table built from JAX's `_merge_path_splits`; the ragged last tile of
    each pair included."""
    n = 4 * run
    sv, pv = make(n, np.random.RandomState(seed), lo=lo, hi=hi)
    es, _ = encode_runs(sv, pv, run)
    meta = merge.merge_level_meta(torch.from_numpy(es), run, window).numpy()
    ntiles = merge.level_tiles(n, run, window)
    assert meta.shape == (7, ntiles)
    rows = es.tolist()
    got = np.array([_plan_tile(rows, run, window, t)
                    for t in range(ntiles)], dtype=np.int64).T
    np.testing.assert_array_equal(got, meta)
    np.testing.assert_array_equal(got, _jax_meta(es, run, window))
    # the second-to-last tile of a pair is the short one
    valid = (got[3] - got[2]) + (got[5] - got[4])
    tiles_per_pair = ntiles // 2
    assert (valid[tiles_per_pair - 1::tiles_per_pair] == window - 128).all()
    assert valid.reshape(2, -1).sum(1).tolist() == [2 * run, 2 * run]


@pytest.mark.parametrize("seed,lo,hi,run,window", PLAN_CASES[:5])
def test_plan_split_equals_jax_splits(seed, lo, hi, run, window):
    n = 4 * run
    sv, pv = make(n, np.random.RandomState(seed), lo=lo, hi=hi)
    es, _ = encode_runs(sv, pv, run)
    a, b, p, o, abase, bbase = (np.asarray(x) for x in mp._merge_path_splits(
        jnp.asarray(es), run, window - 128))
    got = [_plan_split(es, int(ab), int(bb), run, int(oo))
           for ab, bb, oo in zip(abase, bbase, o)]
    np.testing.assert_array_equal(got, a)
    # the pair's end splits at the runs' ends, which is what a last tile uses
    assert _plan_split(es, int(abase[0]), int(bbase[0]), run,
                             2 * run) == run


def test_merge_level_plan_on_cpu_is_merge_level_meta(monkeypatch):
    run, window = 2 * mp.HBM_WINDOW, mp.HBM_WINDOW
    sv, pv = make(4 * run, np.random.RandomState(8), lo=0, hi=64)
    es, ep = encode_runs(sv, pv, run)
    calls = []
    real = merge.merge_level_meta
    monkeypatch.setattr(merge, "merge_level_meta",
                        lambda *a: calls.append(a[1:]) or real(*a))
    merge.reset_launches()
    meta = merge.merge_level_plan(torch.from_numpy(es), run, window)
    assert calls == [(run, window)]
    assert torch.equal(meta, real(torch.from_numpy(es), run, window))
    # and merge_level_hbm plans through it
    merge.merge_level_hbm(*_t(es, ep), run, window=window)
    assert calls == [(run, window)] * 2
    assert set(merge.LAUNCHES.values()) == {0}     # CPU: no kernel launches


@pytest.mark.parametrize("planner", ["scalar", "torch"])
def test_merge_tiles_takes_either_planners_table(planner):
    """The plan table is the interface between the two launches:
    `merge_tiles` on the table made of `_plan_tile` columns, or on
    `merge_level_meta`'s, equals `merge_level_hbm_ref`."""
    run, window = 2048, 1024
    sv, pv = make(4 * run, np.random.RandomState(9), lo=0, hi=64)
    es, ep = encode_runs(sv, pv, run)
    ntiles = merge.level_tiles(4 * run, run, window)
    if planner == "scalar":
        meta = torch.tensor([_plan_tile(es, run, window, t)
                             for t in range(ntiles)],
                            dtype=torch.int32).T.contiguous()
    else:
        meta = merge.merge_level_meta(torch.from_numpy(es), run, window)
    got = merge.merge_tiles(*_t(es, ep), meta, window)
    _assert_pairs_equal(got, merge.merge_level_hbm_ref(*_t(es, ep), run, window))


@pytest.mark.parametrize("bad", ["run_below_window", "length", "window"])
def test_merge_level_plan_rejects_bad_inputs(bad):
    sv = torch.zeros(1 << 13, dtype=torch.int32)
    with pytest.raises(ValueError):
        if bad == "run_below_window":
            merge.merge_level_plan(sv, 512, 1024)
        elif bad == "length":
            merge.merge_level_plan(sv[:3000], 1024, 1024)
        else:
            merge.merge_level_plan(sv, 1024, 128)


def test_check_aligned_names_a_view_off_a_16_byte_boundary():
    """The card's kernels load 16-byte vectors; the wrappers refuse a view
    that starts off such a boundary, by name, before any launch."""
    whole = torch.zeros(1 << 12, dtype=torch.int32)
    merge._check_aligned(("sv", whole), ("pv", whole[4:]))
    with pytest.raises(ValueError, match="pv.*16-byte"):
        merge._check_aligned(("sv", whole), ("pv", whole[1:]))
