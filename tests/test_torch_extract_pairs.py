"""Materialize's extraction (`ops/extract_pairs.py`, `csrc/extract_pairs.cu`).

* the plain version (`torch_extract_pairs`, the CPU route and the slot path
  of `banded_materialize`) against the port's block-windowed path
  (`_extract_blocked`, where its span check passes and no lap happened) and
  the JAX package's slot path, slot for slot, on descriptors made by the
  port's sorts and counting probe: PK-FK, Zipf S, duplicate R keys, an S row
  with more matches than a tile, long runs of S rows without a match, an
  unmatched tail, ragged sizes, a full buffer, a ring lap, truncation, no
  match;
* `_kernel_model`, a plain Python model of the kernel's index arithmetic:
  blocks of kTile merged items, the warps' 32-way searches for a block's
  splits, the staged offsets, each thread's split and walk, the aligned
  groups of four slots and the ring's wrap; its constants are read from the
  CUDA source. It checks that every slot is written exactly once. Change the
  model with the kernel;
* the wrapper's checks and its CPU route, and that `banded_materialize`
  routes on the CPU as before;
* card-only cases (marker `card`), which skip without a card.

This file imports no JAX at module level: its card cases run where JAX is
not installed. The JAX comparison imports it inside the test.
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu_torch.ops import band_compare, extract_pairs
from icde2019_gpu_join_tpu_torch.ops import band_join as T

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "icde2019_gpu_join_tpu_torch")
SOURCE = os.path.join(PKG, "csrc", "extract_pairs.cu")


def _constant(name: str) -> int:
    with open(SOURCE) as f:
        text = f.read()
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, f"{name} not found in {SOURCE}"
    expr = m.group(1)
    for other in ("kThreads", "kItems"):
        if other in expr:
            expr = expr.replace(other, str(_constant(other)))
    return int(eval(expr, {}))


THREADS, ITEMS = _constant("kThreads"), _constant("kItems")
TILE = _constant("kTile")
assert TILE == THREADS * ITEMS

# ---- the cases --------------------------------------------------------------


def _keys(kind: str, rs):
    """(R keys, S keys) of a case."""
    if kind == "zipf":
        rk = rs.permutation(2000)
        ranks = np.minimum(rs.zipf(1.3, 5000), 2000) - 1
        return rk, rk[ranks]
    if kind == "dup_r":                      # many to many
        return rs.randint(0, 40, 1500), rs.randint(0, 40, 900)
    if kind == "row_over_tile":              # one S row with > kTile matches
        rk = np.concatenate([np.full(TILE + 1200, 7), rs.permutation(3000) + 10])
        return rk, np.concatenate([[7], rs.permutation(3000)[:2000] + 10])
    if kind == "h0_runs":                    # 9,800 unmatched S rows between
        rk = np.concatenate([np.arange(100), 100000 + np.arange(100)])
        sk = np.concatenate([np.arange(100), 200 + np.arange(9800),
                             100000 + np.arange(100)])
        return rk, rs.permutation(sk)
    if kind == "tail":                       # S keys above R's at the end
        rk = rs.permutation(3000)
        return rk, np.concatenate([rs.randint(0, 3000, 4000),
                                   rs.randint(10**6, 2 * 10**6, 1500)])
    if kind == "ragged":
        rk = rs.permutation(1000)
        return rk, rs.randint(0, 1000, 1077)
    if kind == "none":
        return np.arange(300), np.arange(300) + 1000
    rk = rs.permutation(3000)                # PK-FK, uniform
    return rk, rk[rs.randint(0, 3000, 3000)]


# name: (keys, capacity from the total, wrap)
CASES = {
    "pkfk": ("pkfk", lambda t: t + 37, True),
    "zipf_s": ("zipf", lambda t: t + 100, True),
    "dup_r": ("dup_r", lambda t: t + 5, True),
    "row_over_tile": ("row_over_tile", lambda t: t + 3, True),
    "h0_runs": ("h0_runs", lambda t: t + 11, True),
    "unmatched_tail": ("tail", lambda t: t + 700, True),
    "ragged": ("ragged", lambda t: t + 333, True),
    "full": ("pkfk", lambda t: t, True),
    "ring_lap": ("dup_r", lambda t: t // 3 + 1, True),
    "truncated": ("dup_r", lambda t: t // 3 + 1, False),
    "no_match": ("none", lambda t: 256, True),
}


def _descriptors(name: str):
    """(h, fm, off, s_p, r_p, n_r_pad, capacity, total, wrap): the port's
    sorts and counting probe on the CPU over the case's keys with
    full-range payloads, S's padding rows cut as `banded_materialize` cuts
    them; r_p keeps its padding."""
    kind, cap_of, wrap = CASES[name]
    rs = np.random.RandomState(sorted(CASES).index(name))
    rk, sk = (k.astype(np.int32) for k in _keys(kind, rs))
    rp, sp = (rs.randint(-2**31, 2**31, k.size, dtype=np.int64).astype(np.int32)
              for k in (rk, sk))
    r_sv, r_p = T.sort_by_key(torch.from_numpy(rk), torch.from_numpy(rp))
    s_sv, s_p = T.sort_by_key(torch.from_numpy(sk), torch.from_numpy(sp))
    h, fm = T.banded_match_descriptors(r_sv, s_sv)
    n_s = sk.size
    h, fm, s_p = h[:n_s], fm[:n_s], s_p[:n_s]
    total = int(h.sum())
    off = (torch.cumsum(h, 0) - h).to(torch.int32)
    return h, fm, off, s_p, r_p, r_sv.shape[0], cap_of(total), total, wrap


def test_the_cases_reach_their_shapes():
    got = {name: _descriptors(name) for name in CASES}
    h = {name: d[0] for name, d in got.items()}
    cap = {name: d[6] for name, d in got.items()}
    total = {name: d[7] for name, d in got.items()}
    assert int(h["row_over_tile"].max()) > TILE
    runs = np.diff(np.flatnonzero(h["h0_runs"].numpy() > 0))
    assert runs.max() > TILE
    tail = h["unmatched_tail"].numpy()
    assert (tail[-1000:] == 0).all() and tail[:1000].any()
    assert h["ragged"].shape[0] % 128 and cap["ragged"] % 128
    assert cap["ragged"] % TILE and total["ragged"] % 4
    assert cap["full"] == total["full"]
    assert total["ring_lap"] > 2 * cap["ring_lap"]
    assert total["truncated"] > 2 * cap["truncated"]
    assert total["no_match"] == 0
    assert (h["zipf_s"] == 1).all() and (h["dup_r"] > 30).any()


def _jax_slot_path(h, fm, off, s_p, r_p, n_r_pad, capacity, total, wrap):
    import jax.numpy as jnp
    from icde2019_gpu_join_tpu.ops import band_join as J
    got = J._materialize_slot_path(
        *(jnp.asarray(x.numpy()) for x in (h, fm, off, s_p, r_p)), capacity,
        jnp.int32(total), jnp.arange(capacity, dtype=jnp.int32), wrap,
        h.shape[0], n_r_pad)
    return tuple(np.asarray(x) for x in got)


def _blocked(h, fm, off, s_p, r_p, capacity, total, wrap):
    """`_extract_blocked`'s slots, or None where the port would not take it:
    a lap, no match, or a failed span check."""
    if total <= 0 or (wrap and total > capacity):
        return None
    ok, plan = T._fast_path_plan(h, fm, off, s_p, r_p, capacity, total)
    if not bool(ok):
        return None
    return tuple(x[:capacity].numpy() for x in T._extract_blocked(*plan))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_is_the_block_path_and_jaxs_slot_path(name):
    h, fm, off, s_p, r_p, n_r_pad, cap, total, wrap = _descriptors(name)
    got = extract_pairs.torch_extract_pairs(off, fm, s_p, r_p, cap, total, wrap)
    assert all(x.dtype == torch.int32 and x.shape == (cap,) for x in got)
    got = tuple(x.numpy() for x in got)
    for g, w in zip(got, _jax_slot_path(h, fm, off, s_p, r_p, n_r_pad, cap,
                                        total, wrap)):
        np.testing.assert_array_equal(g, w)
    blocked = _blocked(h, fm, off, s_p, r_p, cap, total, wrap)
    if name in ("pkfk", "zipf_s", "full", "ragged", "unmatched_tail"):
        assert blocked is not None, "the span check failed"
    if blocked is not None:
        for g, w in zip(got, blocked):
            np.testing.assert_array_equal(g, w)
    assert not got[0][max(total, 0):].any() and not got[1][max(total, 0):].any()


# ---- the kernel's model -----------------------------------------------------

def _merge_split(off, n_s, count, m_lo, diag, rounds=None) -> int:
    """`merge_split` of the source: a warp's 32-way search, lane by lane,
    its first round around the proportional split; `rounds` collects the
    rounds it took."""
    lo, hi = max(diag - n_s, 0), min(diag, count)
    x0 = int(float(diag) * count / (count + n_s)) - 16
    x0 = max(min(x0, hi - 32), lo)
    step, taken = 1, 0
    while lo < hi:
        taken += 1
        before = [x < hi and m_lo + x < off[diag - 1 - x]
                  for x in (x0 + lane * step for lane in range(32))]
        held = sum(before)
        assert before == [True] * held + [False] * (32 - held)
        if held == 0:
            hi = x0
        else:
            lo = x0 + (held - 1) * step + 1
            if held < 32:
                hi = min(hi, x0 + held * step)
        step, x0 = (hi - lo + 31) // 32, lo
    if rounds is not None:
        rounds.append(taken)
    return lo


@pytest.mark.parametrize("per_row,share,lap", [(1, 1.0, False), (1, 1.0, True),
                                               (3, 0.3, False), (40, 0.05, True)])
def test_split_search_is_the_merges_split(per_row, share, lap):
    """`merge_split` at every diagonal equals the split of the merge written
    out (rows first on ties); with one match a row and no lap, one round."""
    rs = np.random.RandomState(per_row)
    h = np.where(rs.rand(700) < share, per_row, 0)
    off = np.cumsum(h) - h
    total = int(h.sum())
    count = total // 2 if lap else total
    m_lo = total - count
    items = sorted([(int(o), 0) for o in off]
                   + [(m_lo + x, 1) for x in range(count)])
    rounds = []
    for diag in range(count + off.size + 1):
        want = sum(kind for _, kind in items[:diag])
        assert _merge_split(off, off.size, count, m_lo, diag, rounds) == want
    if per_row == 1 and share == 1.0 and not lap:
        assert max(rounds) == 1


def _store(sa, sb, at, out, writes, groups):
    """`store` of the source over slots [sa, sb): aligned groups of four,
    thread by thread; `groups` counts the whole (vector) and cut ones."""
    g0, g1 = sa >> 2, (sb + 3) >> 2
    groups["ranges"] += 1
    for t in range(THREADS):
        for g in range(g0 + t, g1, THREADS):
            s0 = 4 * g
            whole = s0 >= sa and s0 + 4 <= sb
            groups["whole" if whole else "cut"] += 1
            for slot in range(s0, s0 + 4):
                if sa <= slot < sb:
                    out[:, slot] = at(slot)
                    writes[slot] += 1


def _i32(x: int) -> int:
    assert -2**31 <= x < 2**31, x
    return x


def _kernel_model(off, fm, s_p, r_p, capacity: int, total: int, wrap: bool):
    """`tj_extract_pairs` block by block and thread by thread; returns
    ((out_r, out_s), the groups' counts)."""
    off, fm, s_p, r_p = (x.numpy().astype(np.int64) for x in (off, fm, s_p, r_p))
    n_s, n_r = off.size, r_p.size
    out = np.zeros((2, capacity), np.int64)
    writes = np.zeros(capacity, np.int64)
    groups = {"whole": 0, "cut": 0, "ranges": 0}
    kept = max(total, 0)
    count = min(kept, capacity)
    m_lo = kept - capacity if wrap and kept > capacity else 0
    slot0 = m_lo % capacity if capacity else 0
    merge_blocks = -(-(count + n_s) // TILE) if count else 0
    for blk in range(merge_blocks):
        diag0 = blk * TILE
        diag1 = min(diag0 + TILE, count + n_s)
        a0 = _merge_split(off, n_s, count, m_lo, diag0)
        a1 = _merge_split(off, n_s, count, m_lo, diag1)
        na = a1 - a0
        if na == 0:
            continue
        b0 = diag0 - a0
        nb = diag1 - a1 - b0
        assert 0 <= nb and na + nb <= TILE
        m0 = m_lo + a0
        rel = [0 if b0 - 1 + k < 0 else _i32(int(off[b0 - 1 + k]) - m0)
               for k in range(nb + 1)]
        own = [None] * na
        for t in range(THREADS):
            d = t * ITEMS
            if d >= na + nb:
                continue
            lo, hi = max(d - nb, 0), min(d, na)
            while lo < hi:
                mid = (lo + hi) >> 1
                if mid < rel[d - mid]:
                    lo = mid + 1
                else:
                    hi = mid
            x, y = lo, d - lo
            end = min(d + ITEMS, na + nb)
            for _ in range(ITEMS):
                if x + y < end:
                    if y < nb and (x >= na or rel[y + 1] <= x):
                        y += 1
                    else:
                        assert own[x] is None, "a match walked twice"
                        own[x] = y
                        x += 1
        assert None not in own, "a match not walked"

        def at(slot, first):
            x = slot - first
            o = own[x]
            row = min(max(b0 - 1 + o, 0), n_s - 1)
            r_pos = min(max(int(fm[row]) + x - rel[o], 0), n_r - 1)
            return r_p[r_pos], s_p[row]

        first = slot0 + a0
        if first >= capacity:
            first -= capacity
        before_wrap = min(na, capacity - first)
        _store(first, first + before_wrap, lambda s: at(s, first), out,
               writes, groups)
        if before_wrap < na:
            _store(0, na - before_wrap, lambda s: at(s, first - capacity),
                   out, writes, groups)
    for z in range(-(-(capacity - count) // TILE)):
        sa = count + z * TILE
        _store(sa, min(sa + TILE, capacity), lambda s: (0, 0), out, writes,
               groups)
    assert (writes == 1).all(), "a slot not written exactly once"
    out = np.where(out >= 2**31, out - 2**32, out).astype(np.int32)
    return (out[0], out[1]), groups


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_is_the_plain_version(name):
    h, fm, off, s_p, r_p, _, cap, total, wrap = _descriptors(name)
    (got_r, got_s), groups = _kernel_model(off, fm, s_p, r_p, cap, total, wrap)
    want = extract_pairs.torch_extract_pairs(off, fm, s_p, r_p, cap, total,
                                             wrap)
    np.testing.assert_array_equal(got_r, want[0].numpy())
    np.testing.assert_array_equal(got_s, want[1].numpy())
    assert groups["cut"] <= 2 * groups["ranges"]


# (rows, matches a matched row, the share of rows matched, capacity less the
# total, wrap): shapes at and around the tile's edges and the ring's
_EDGES = [(TILE - 1, 1, 1.0, 0, True), (TILE, 1, 1.0, 1, True),
          (TILE + 1, 1, 1.0, -1, True), (2 * TILE, 3, 0.5, -TILE, True),
          (TILE // 2, 9, 1.0, -(TILE // 2) * 9 + 5, False),
          (3 * TILE + 5, 1, 0.02, 7, True), (1, 5 * TILE, 1.0, -2, True),
          (5, 2, 1.0, 3 * TILE + 1, True)]


def _synthetic(n_s, per_row, share, slack, seed):
    rs = np.random.RandomState(seed)
    h = np.where(rs.rand(n_s) < share, per_row, 0).astype(np.int64)
    h[0] = per_row
    off = np.cumsum(h) - h
    total = int(h.sum())
    n_r = total + 17
    fm = (off + rs.randint(0, 5)).astype(np.int32)      # in order, shifted
    r_p = rs.randint(-2**31, 2**31, n_r, dtype=np.int64).astype(np.int32)
    s_p = rs.randint(-2**31, 2**31, n_s, dtype=np.int64).astype(np.int32)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    return t(off), t(fm), t(s_p), t(r_p), max(total + slack, 1), total


@pytest.mark.parametrize("edge", range(len(_EDGES)))
def test_model_at_the_tiles_edges(edge):
    n_s, per_row, share, slack, wrap = _EDGES[edge]
    off, fm, s_p, r_p, cap, total = _synthetic(n_s, per_row, share, slack, edge)
    (got_r, got_s), _ = _kernel_model(off, fm, s_p, r_p, cap, total, wrap)
    want = extract_pairs.torch_extract_pairs(off, fm, s_p, r_p, cap, total, wrap)
    np.testing.assert_array_equal(got_r, want[0].numpy())
    np.testing.assert_array_equal(got_s, want[1].numpy())


# ---- the wrapper ------------------------------------------------------------

def _args():
    x = torch.arange(8, dtype=torch.int32)
    return x, x.clone(), x.clone(), x.clone()


def _bad_inputs():
    off, fm, s_p, r_p = _args()
    return {
        "int64 off": ((off.long(), fm, s_p, r_p), 8),
        "2-D fm": ((off, fm.view(2, 4), s_p, r_p), 8),
        "strided s_p": ((off, fm, torch.arange(16, dtype=torch.int32)[::2], r_p), 8),
        "int16 r_p": ((off, fm, s_p, r_p.short()), 8),
        "lengths differ": ((off, fm[:7], s_p, r_p), 8),
        "devices differ": ((off, fm, s_p, r_p.to("meta")), 8),
        "meta tensors": (tuple(x.to("meta") for x in (off, fm, s_p, r_p)), 8),
        "negative capacity": ((off, fm, s_p, r_p), -1),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_refuses(case):
    args, cap = _bad_inputs()[case]
    with pytest.raises(ValueError):
        extract_pairs.extract_pairs(*args, cap, 3, True)


@pytest.mark.parametrize("name", ["pkfk", "ring_lap", "truncated", "no_match"])
def test_cpu_route_is_the_plain_version(name):
    _, fm, off, s_p, r_p, _, cap, total, wrap = _descriptors(name)
    before = dict(extract_pairs.LAUNCHES)
    got = extract_pairs.extract_pairs(off, fm, s_p, r_p, cap, total, wrap)
    want = extract_pairs.torch_extract_pairs(off, fm, s_p, r_p, cap, total, wrap)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert extract_pairs.LAUNCHES == before


@pytest.mark.parametrize("force", [None, "fast", "slow"])
def test_materialize_on_the_cpu_never_takes_the_wrapper(force, monkeypatch):
    """On the CPU `banded_materialize` routes as the JAX engine does, whatever
    debug_force says: the wrapper is for the card's route only."""
    def refuse(*args):
        raise AssertionError("the card's route ran on the CPU")
    monkeypatch.setattr(T, "extract_pairs", refuse)
    rs = np.random.RandomState(2)
    rk = rs.permutation(3000).astype(np.int32)
    sk = rk[rs.randint(0, 3000, 3000)]
    out_r, out_s, total = T.banded_materialize(
        *map(torch.from_numpy, (rk, rk, sk, sk)), capacity=3100,
        debug_force=force)
    assert int(total) == 3000
    assert torch.equal(torch.sort(out_r).values, torch.sort(out_s).values)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU route")
    return torch.device("cuda")


def _launched(fn):
    before = {**extract_pairs.LAUNCHES, **band_compare.LAUNCHES}
    out = fn()
    torch.cuda.synchronize()
    after = {**extract_pairs.LAUNCHES, **band_compare.LAUNCHES}
    return out, {k: after[k] - before[k] for k in after}


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_is_the_plain_version_on_the_card(card, name):
    _, fm, off, s_p, r_p, _, cap, total, wrap = _descriptors(name)
    got, launches = _launched(lambda: extract_pairs.extract_pairs(
        off.to(card), fm.to(card), s_p.to(card), r_p.to(card), cap, total,
        wrap))
    want = extract_pairs.torch_extract_pairs(off, fm, s_p, r_p, cap, total, wrap)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert launches["extract_pairs"] == 1


@pytest.mark.card
@pytest.mark.parametrize("edge", range(len(_EDGES)))
def test_kernel_at_the_tiles_edges_on_the_card(card, edge):
    n_s, per_row, share, slack, wrap = _EDGES[edge]
    args = _synthetic(n_s, per_row, share, slack, edge)
    got = extract_pairs.extract_pairs(*(x.to(card) for x in args[:4]),
                                      *args[4:], wrap)
    want = extract_pairs.torch_extract_pairs(*args, wrap)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.card
@pytest.mark.parametrize("shape", ["pkfk", "skewed", "ring", "truncated"])
def test_kernel_at_the_cells_size(card, shape):
    """2^27 slots: one match a row in order (the mat cell's shape), 0-8
    matches a row with every 4096th row matching 4096 times, a ring of 2^24
    slots under 2^27 matches, and 2^27 matches cut to 2^26."""
    n = 1 << 27
    g = torch.Generator(device=card).manual_seed(len(shape))
    if shape == "skewed":
        h = torch.randint(0, 9, (n,), generator=g, device=card, dtype=torch.int32)
        h[::4096] = 1 << 12
    else:
        h = torch.ones(n, dtype=torch.int32, device=card)
    hsum = torch.cumsum(h, 0)
    total = int(hsum[-1])
    off = (hsum - h).to(torch.int32)
    del hsum
    fm = off.clone()
    s_p = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=card,
                        dtype=torch.int32)
    r_p = torch.randint(-2**31, 2**31 - 1, (min(total, 2**31 - 1),),
                        generator=g, device=card, dtype=torch.int32)
    cap, wrap = {"ring": (1 << 24, True), "truncated": (1 << 26, False)}.get(
        shape, (n, True))
    got, launches = _launched(lambda: extract_pairs.extract_pairs(
        off, fm, s_p, r_p, cap, total, wrap))
    want = extract_pairs.torch_extract_pairs(off, fm, s_p, r_p, cap, total, wrap)
    assert launches["extract_pairs"] == 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _relations(n: int, device):
    rs = np.random.RandomState(n)
    rk = rs.permutation(n).astype(np.int32)
    sk = rk[rs.randint(0, n, n)]
    rp, sp = (rs.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
              for _ in range(2))
    return [torch.from_numpy(a).to(device) for a in (rk, rp, sk, sp)]


@pytest.mark.card
def test_materialize_takes_one_launch_on_the_card(card):
    """The routed path: one `extract_pairs` launch, neither kernel 4 nor
    kernel 2's chunk entry, and the slot path's output, slot for slot."""
    args = _relations(1 << 20, card)
    (out_r, out_s, total), launches = _launched(
        lambda: T.banded_materialize(*args, capacity=(1 << 20) + 100))
    assert launches["extract_pairs"] == 1
    assert launches["banded_interval_select"] == 0
    assert launches["banded_compare_per_s"] == 0
    want = T.banded_materialize(*args, capacity=(1 << 20) + 100,
                                debug_force="slow")
    assert int(total) == int(want[2]) == 1 << 20
    assert torch.equal(out_r, want[0]) and torch.equal(out_s, want[1])


@pytest.mark.card
def test_debug_force_fast_still_takes_kernels_4_and_2_on_the_card(card):
    args = _relations(1 << 20, card)
    (out_r, out_s, _), launches = _launched(
        lambda: T.banded_materialize(*args, capacity=(1 << 20) + 100,
                                     debug_force="fast"))
    assert launches["extract_pairs"] == 0
    assert launches["banded_interval_select"] == 1
    assert launches["banded_compare_per_s"] == 1
    want = T.banded_materialize(*args, capacity=(1 << 20) + 100)
    assert torch.equal(out_r, want[0]) and torch.equal(out_s, want[1])
