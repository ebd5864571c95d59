"""The port's ops/band_join.py against the JAX package's, bit for bit.

Sorts are unstable in both frameworks, so sorted keys are compared element
by element and payloads as per-key multisets; the windows depend only on
the sorted keys and must be equal. Per-S results are compared on the same
sorted inputs, materialized pairs as multisets, and the wrap ring exactly
where payloads are functions of the key (then every tie order gives the
same ring)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu.ops import band_join as J
from icde2019_gpu_join_tpu.utils import oracle
from icde2019_gpu_join_tpu_torch.ops import band_join as T
from tests.conftest import make_tables


def _pair(rk, rp, sk, sp, w):
    """(port, JAX) aggregate of the same inputs."""
    got = T.banded_join_aggregate(*map(torch.from_numpy, (rk, rp, sk, sp)),
                                  window_blocks=w)
    assert got.dtype == torch.int32 and got.dim() == 0
    want = J.banded_join_aggregate(*map(jnp.asarray, (rk, rp, sk, sp)),
                                   window_blocks=w)
    return int(got), int(want)


def _check_agg(rk, rp, sk, sp, w=4):
    got, want = _pair(rk, rp, sk, sp, w)
    assert got == want == oracle.join_aggregate(rk, rp, sk, sp)


@pytest.mark.parametrize("n,key_range", [(1000, 300), (3000, 7), (129, 1 << 30)])
def test_sort_by_key_matches_jax(rng, n, key_range):
    keys = rng.randint(0, key_range, n).astype(np.int32)
    pay = rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    j_sv, j_p = map(np.asarray, J.sort_by_key(jnp.asarray(keys), jnp.asarray(pay)))
    t_sv, t_p = (x.numpy() for x in T.sort_by_key(torch.from_numpy(keys),
                                                  torch.from_numpy(pay)))
    np.testing.assert_array_equal(t_sv, j_sv)
    # per-key payload multisets: order (key, payload) pairs canonically
    jo = np.lexsort((j_p, j_sv))
    to = np.lexsort((t_p, t_sv))
    np.testing.assert_array_equal(t_p[to], j_p[jo])


@pytest.mark.parametrize("n_r,n_s,key_range", [
    (2000, 3000, 300), (500, 4000, 5), (3000, 700, 1 << 20), (1, 1, 3),
])
def test_block_windows_match_jax(rng, n_r, n_s, key_range):
    rk = rng.randint(0, key_range, n_r).astype(np.int32)
    sk = rng.randint(0, key_range, n_s).astype(np.int32)
    j_r, _ = J.sort_by_key(jnp.asarray(rk), jnp.zeros(n_r, jnp.int32))
    j_s, _ = J.sort_by_key(jnp.asarray(sk), jnp.zeros(n_s, jnp.int32))
    t_r, _ = T.sort_by_key(torch.from_numpy(rk), torch.zeros(n_r, dtype=torch.int32))
    t_s, _ = T.sort_by_key(torch.from_numpy(sk), torch.zeros(n_s, dtype=torch.int32))
    j_lo, j_hi = J.block_windows(j_r, j_s)
    t_lo, t_hi = T.block_windows(t_r, t_s)
    assert t_lo.dtype == t_hi.dtype == torch.int32
    np.testing.assert_array_equal(t_lo.numpy(), np.asarray(j_lo))
    np.testing.assert_array_equal(t_hi.numpy(), np.asarray(j_hi))


@pytest.mark.parametrize("w", [1, 2, 4])
def test_aggregate_pkfk(rng, w):
    _check_agg(*make_tables(rng), w)


def test_aggregate_duplicates(rng):
    rk = rng.randint(0, 500, 4000).astype(np.int32)
    sk = rng.randint(0, 500, 6000).astype(np.int32)
    rp = rng.randint(-100, 100, rk.size).astype(np.int32)
    sp = rng.randint(-100, 100, sk.size).astype(np.int32)
    _check_agg(rk, rp, sk, sp)


def test_aggregate_heavy_skew(rng):
    # one key holds about half of S: windows widen, several rounds run
    rk = rng.permutation(2000).astype(np.int32)
    sk = np.concatenate([np.full(5000, 7, np.int32),
                         rng.randint(0, 2000, 5000).astype(np.int32)])
    rng.shuffle(sk)
    rp = rng.randint(-10, 10, rk.size).astype(np.int32)
    sp = rng.randint(-10, 10, sk.size).astype(np.int32)
    _check_agg(rk, rp, sk, sp, w=2)


def test_aggregate_no_matches():
    rk = np.arange(1000, dtype=np.int32)
    sk = np.arange(5000, 9000, dtype=np.int32)
    got, want = _pair(rk, np.ones_like(rk), sk, np.ones_like(sk), 4)
    assert got == want == 0


def test_aggregate_wraparound():
    rk = np.zeros(100, np.int32)
    sk = np.zeros(100, np.int32)
    rp = np.full(100, 2**20, np.int32)
    sp = np.full(100, 2**20, np.int32)
    _check_agg(rk, rp, sk, sp)  # 10^4 matches of 2^40 each


def test_count(rng):
    rk, _, sk, _ = make_tables(rng, dup_build=True)
    got = T.banded_join_count(torch.from_numpy(rk), torch.from_numpy(sk))
    want = J.banded_join_count(jnp.asarray(rk), jnp.asarray(sk))
    assert int(got) == int(want) == oracle.join_count(rk, sk)


@pytest.mark.parametrize("n_r,n_s", [(0, 5), (5, 0), (0, 0), (1, 1), (127, 129)])
def test_edge_shapes(n_r, n_s):
    rk = np.arange(n_r, dtype=np.int32)
    sk = np.zeros(n_s, dtype=np.int32)
    got, want = _pair(rk, np.ones(n_r, np.int32), sk, np.ones(n_s, np.int32), 1)
    assert got == want == (n_s if n_r > 0 and n_s > 0 else 0)


def test_fuzz_vs_jax(rng):
    for _ in range(8):
        n_r = int(rng.randint(1, 3000))
        n_s = int(rng.randint(1, 5000))
        kmax = int(rng.choice([10, 300, 1 << 16, 1 << 30]))
        rk = rng.randint(0, kmax, n_r).astype(np.int32)
        sk = rng.randint(0, kmax, n_s).astype(np.int32)
        rp = rng.randint(-2**31, 2**31, n_r, dtype=np.int64).astype(np.int32)
        sp = rng.randint(-2**31, 2**31, n_s, dtype=np.int64).astype(np.int32)
        w = int(rng.choice([1, 2, 4]))
        got, want = _pair(rk, rp, sk, sp, w)
        assert got == want == oracle.join_aggregate(rk, rp, sk, sp), (n_r, n_s, kmax, w)


def test_chunking_does_not_change_the_sum(rng, monkeypatch):
    """Several chunks per round give the same sum as one."""
    rk, rp, sk, sp = make_tables(rng, n_r=3000, n_s=9000, dup_build=True)
    args = [torch.from_numpy(a) for a in (rk, rp, sk, sp)]
    whole = int(T.banded_join_aggregate(*args, window_blocks=2))
    monkeypatch.setattr(T, "_CHUNK_BLOCKS", 8)
    assert int(T.banded_join_aggregate(*args, window_blocks=2)) == whole
    assert whole == oracle.join_aggregate(rk, rp, sk, sp)


def test_probe_rejects_unknown_mode():
    sv = torch.zeros(128, dtype=torch.int32)
    with pytest.raises(ValueError, match="mode"):
        T.banded_probe(sv, sv, sv, sv, 1, "xor")


def _case(kind, seed=0):
    """(rk, rp, sk, sp) with full-range payloads."""
    rng = np.random.RandomState(seed)
    if kind == "pkfk":
        return make_tables(rng, n_r=1500, n_s=3000)
    if kind == "dup":
        rk = rng.randint(0, 300, 2000).astype(np.int32)
        sk = rng.randint(0, 330, 3000).astype(np.int32)
    elif kind == "skew":   # one key holds half of S and a run of R
        rk = rng.permutation(2000).astype(np.int32)
        rk[:300] = 7
        sk = np.concatenate([np.full(2500, 7, np.int32),
                             rng.randint(0, 2000, 2500).astype(np.int32)])
        rng.shuffle(sk)
    else:                  # "wrap": one key, sums far past 2^32
        rk = np.zeros(300, np.int32)
        sk = np.zeros(200, np.int32)
    full = lambda n: rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    return rk, full(rk.size), sk, full(sk.size)


CASES = [("pkfk", 1), ("dup", 2), ("skew", 2), ("wrap", 4), ("dup", 4),
         ("skew", 1)]


def _sorted_inputs(rk, rp, sk):
    """One set of sorted inputs for both engines (the sorts are unstable)."""
    r_sv, r_p = J.sort_by_key(jnp.asarray(rk), jnp.asarray(rp))
    s_sv, _ = J.sort_by_key(jnp.asarray(sk), jnp.zeros(sk.size, jnp.int32))
    return [np.array(x) for x in (r_sv, r_p, s_sv)]


@pytest.mark.parametrize("kind,w", CASES)
def test_probe_per_s_matches_jax(kind, w):
    rk, rp, sk, _ = _case(kind)
    r_sv, r_p, s_sv = _sorted_inputs(rk, rp, sk)
    jh, jt = J.banded_probe_per_s(*map(jnp.asarray, (r_sv, r_p, s_sv)),
                                  window_blocks=w)
    th, tt = T.banded_probe_per_s(*map(torch.from_numpy, (r_sv, r_p, s_sv)), w)
    assert th.dtype == tt.dtype == torch.int32
    n = sk.size   # S pad rows carry garbage h in both engines
    np.testing.assert_array_equal(th[:n].numpy(), np.asarray(jh)[:n])
    np.testing.assert_array_equal(tt[:n].numpy(), np.asarray(jt)[:n])
    assert int(th[:n].sum()) == oracle.join_count(rk, sk)


@pytest.mark.parametrize("kind,w", CASES)
def test_match_descriptors_match_jax(kind, w):
    rk, rp, sk, _ = _case(kind)
    r_sv, _, s_sv = _sorted_inputs(rk, rp, sk)
    jh, jf = J.banded_match_descriptors(jnp.asarray(r_sv), jnp.asarray(s_sv),
                                        window_blocks=w)
    th, tf = T.banded_match_descriptors(torch.from_numpy(r_sv),
                                        torch.from_numpy(s_sv), w)
    n = sk.size
    np.testing.assert_array_equal(th[:n].numpy(), np.asarray(jh)[:n])
    np.testing.assert_array_equal(tf[:n].numpy(), np.asarray(jf)[:n])
    # the matches of S row i are exactly sorted-R rows [fm, fm + h)
    i = int(np.argmax(th[:n].numpy()))
    f, c = int(tf[i]), int(th[i])
    assert (r_sv[f:f + c] == s_sv[i]).all() and (f == 0 or r_sv[f - 1] != s_sv[i])


@pytest.mark.parametrize("kind,w", CASES)
def test_late_aggregate_add_mode_matches_jax(kind, w):
    rk, rp, sk, sp = _case(kind)
    got = T.banded_join_late_aggregate(*map(torch.from_numpy, (rk, rp, sk, sp)),
                                       window_blocks=w)
    want = J.banded_join_late_aggregate(*map(jnp.asarray, (rk, rp, sk, sp)),
                                        window_blocks=w)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(want) == oracle.join_late_materialize_sum(
        rk, np.arange(rk.size), sk, np.arange(sk.size), rp[:, None], sp[:, None])


def test_per_s_paths_do_not_depend_on_chunking(monkeypatch):
    """Several chunks per round give what one chunk gives, on every probe
    that shares the scheduler."""
    rk, rp, sk, sp = _case("skew", seed=3)
    r_sv, r_p, s_sv = map(torch.from_numpy, _sorted_inputs(rk, rp, sk))
    args = [torch.from_numpy(a) for a in (rk, rp, sk, sp)]

    def run():
        return (*T.banded_probe_per_s(r_sv, r_p, s_sv, 2),
                *T.banded_match_descriptors(r_sv, s_sv, 2),
                T.banded_join_late_aggregate(*args, window_blocks=2))

    whole = run()
    monkeypatch.setattr(T, "_CHUNK_BLOCKS", 8)
    for got, want in zip(run(), whole):
        assert torch.equal(got, want)


def _multiset(out_r, out_s):
    """The (Pr, Ps) pairs of every slot, as a sorted int64 array."""
    r = np.asarray(out_r).astype(np.int64)
    s = np.asarray(out_s).astype(np.int64) & 0xFFFFFFFF
    return np.sort((r << 32) | s)


def _oracle_multiset(rk, rp, sk, sp, capacity):
    pairs = oracle.join_materialize(rk, rp, sk, sp)
    pad = np.zeros((capacity - pairs.shape[0], 2), np.int32)
    return _multiset(*np.concatenate([pairs, pad]).T)


def _mat_case(kind, seed=4):
    rng = np.random.RandomState(seed)
    if kind == "dense":      # PK-FK-like: fast path territory
        rk = rng.permutation(4000).astype(np.int32)
        sk = rng.randint(0, 4000, 6000).astype(np.int32)
    elif kind == "sparse":   # ~1/50 of S matches: owner spans blow up
        rk = rng.permutation(100).astype(np.int32)
        sk = rng.randint(0, 5000, 6000).astype(np.int32)
    elif kind == "spread":   # ~1/50 of S matches, spread over S's order
        rk = rng.permutation(5000)[:100].astype(np.int32)
        sk = rng.randint(0, 5000, 6000).astype(np.int32)
    else:                    # heavy duplicates on both sides
        rk = rng.randint(0, 30, 2000).astype(np.int32)
        sk = rng.randint(0, 30, 1000).astype(np.int32)
    rp = rng.randint(1, 1000, rk.size).astype(np.int32)
    sp = rng.randint(1, 1000, sk.size).astype(np.int32)
    return rk, rp, sk, sp


@pytest.mark.parametrize("kind,force", [
    ("dense", None), ("dense", "fast"), ("dense", "slow"),
    ("sparse", None), ("sparse", "slow"), ("dups", None), ("dups", "slow"),
])
def test_materialize_matches_jax_and_oracle(kind, force):
    rk, rp, sk, sp = _mat_case(kind)
    cap = oracle.join_count(rk, sk) + 200
    t_r, t_s, t_tot = T.banded_materialize(
        *map(torch.from_numpy, (rk, rp, sk, sp)), capacity=cap,
        debug_force=force)
    j_r, j_s, j_tot = J.banded_materialize(
        *map(jnp.asarray, (rk, rp, sk, sp)), capacity=cap, debug_force=force)
    assert t_r.dtype == t_s.dtype == t_tot.dtype == torch.int32
    assert t_r.shape == t_s.shape == (cap,)
    assert int(t_tot) == int(j_tot) == cap - 200
    got = _multiset(t_r, t_s)
    np.testing.assert_array_equal(got, _multiset(j_r, j_s))
    np.testing.assert_array_equal(got, _oracle_multiset(rk, rp, sk, sp, cap))


@pytest.mark.parametrize("kind,fast", [("dense", True), ("sparse", True),
                                       ("spread", False)])
def test_materialize_routes_like_jax(kind, fast, monkeypatch):
    """The fast path engages on matched-dense inputs; matches spread thin
    over S fall back to the slot path. A deliberate divergence from the JAX
    engine: "sparse" has all its matches at the front of the sorted S and
    unmatched rows after them. JAX anchors the slot blocks past the last
    match at the last S block, so its span check fails and it takes the slot
    path; the port anchors them at the last match and takes the fast path.
    Both give the oracle's multiset (test_materialize_matches_jax_and_oracle)."""
    calls = []
    real = T._extract_blocked
    monkeypatch.setattr(T, "_extract_blocked",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rk, rp, sk, sp = _mat_case(kind)
    T.banded_materialize(*map(torch.from_numpy, (rk, rp, sk, sp)),
                         capacity=oracle.join_count(rk, sk) + 200)
    assert bool(calls) == fast


def test_materialize_unmatched_tail_takes_the_fast_path(monkeypatch):
    """Matches dense at the front of the sorted S, unmatched rows after them
    (S keys above R's, an exchange's received pads): the last live slot
    block is anchored at the last match, so the span check passes and the
    block-windowed path runs (the JAX engine takes the slot path here), with
    the same multiset."""
    calls = []
    real = T._extract_blocked
    monkeypatch.setattr(T, "_extract_blocked",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.RandomState(5)
    rk = rng.permutation(3000).astype(np.int32)
    sk = np.concatenate([rng.randint(0, 3000, 4000),
                         rng.randint(10**6, 2 * 10**6, 1500)]).astype(np.int32)
    rp = rng.randint(1, 1000, rk.size).astype(np.int32)
    sp = rng.randint(1, 1000, sk.size).astype(np.int32)
    cap = 4000 + 700
    t_r, t_s, total = T.banded_materialize(
        *map(torch.from_numpy, (rk, rp, sk, sp)), capacity=cap)
    j_r, j_s, _ = J.banded_materialize(*map(jnp.asarray, (rk, rp, sk, sp)),
                                       capacity=cap)
    assert calls and int(total) == 4000
    np.testing.assert_array_equal(_multiset(t_r, t_s), _multiset(j_r, j_s))
    np.testing.assert_array_equal(_multiset(t_r, t_s),
                                  _oracle_multiset(rk, rp, sk, sp, cap))


@pytest.mark.parametrize("force", [None, "fast"])
def test_materialize_fast_path_leaves_dead_slot_blocks_zero(force):
    """A buffer 4x the match total (as the distributed materializer sizes
    it): the fast path selects over the live slot blocks only and the dead
    ones come out 0; the multiset is JAX's and the oracle's."""
    rk, rp, sk, sp = _mat_case("dense")
    total = oracle.join_count(rk, sk)
    cap = 4 * total + 64
    t_r, t_s, t_tot = T.banded_materialize(
        *map(torch.from_numpy, (rk, rp, sk, sp)), capacity=cap,
        debug_force=force)
    j_r, j_s, _ = J.banded_materialize(*map(jnp.asarray, (rk, rp, sk, sp)),
                                       capacity=cap, debug_force=force)
    assert int(t_tot) == total and t_r.shape == t_s.shape == (cap,)
    assert not t_r[total:].any() and not t_s[total:].any()
    np.testing.assert_array_equal(_multiset(t_r, t_s), _multiset(j_r, j_s))
    np.testing.assert_array_equal(_multiset(t_r, t_s),
                                  _oracle_multiset(rk, rp, sk, sp, cap))


def test_materialize_sparse_wide_fm_guard():
    """A selective S whose last matched row has fm far beyond the static R
    window, plus trailing unmatched rows, must not lose the wide match (the
    fast path's R-span check covers the whole anchor range)."""
    rk = np.arange(20000, dtype=np.int32)
    rp = (rk + 1).astype(np.int32)
    sk = np.concatenate([np.asarray([0, 19999], np.int32),
                         np.arange(30000, 30300, dtype=np.int32)])
    sp = np.full(sk.size, 7, np.int32)
    t_r, t_s, total = T.banded_materialize(
        *map(torch.from_numpy, (rk, rp, sk, sp)), capacity=128)
    j_r, j_s, _ = J.banded_materialize(*map(jnp.asarray, (rk, rp, sk, sp)),
                                       capacity=128)
    assert int(total) == 2
    np.testing.assert_array_equal(_multiset(t_r, t_s), _multiset(j_r, j_s))
    np.testing.assert_array_equal(_multiset(t_r, t_s),
                                  _oracle_multiset(rk, rp, sk, sp, 128))


def _key_derived(rng, n_r, n_s, key_range):
    rk = rng.randint(0, key_range, n_r).astype(np.int32)
    sk = rng.randint(0, key_range, n_s).astype(np.int32)
    return rk, (7 * rk + 1).astype(np.int32), sk, sk ^ np.int32(0x5bd1e995)


@pytest.mark.parametrize("wrap", [True, False])
def test_materialize_ring_matches_jax_exactly(wrap):
    """With payloads that are functions of the key, the wrapped ring and
    the truncated buffer do not depend on tie order: equal to JAX slot for
    slot."""
    rk, rp, sk, sp = _key_derived(np.random.RandomState(6), 700, 1100, 50)
    total = oracle.join_count(rk, sk)
    cap = total // 3 + 1   # more than two laps around the ring
    got = T.banded_materialize(*map(torch.from_numpy, (rk, rp, sk, sp)),
                               capacity=cap, wrap=wrap)
    want = J.banded_materialize(*map(jnp.asarray, (rk, rp, sk, sp)),
                                capacity=cap, wrap=wrap)
    assert int(got[2]) == int(want[2]) == total
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_materialize_ring_is_the_s_sorted_match_stream():
    """With random payloads the ring depends on tie order, so it is held
    against the port's own S-sorted match stream: match m in slot
    m mod capacity, later matches overwriting earlier."""
    rng = np.random.RandomState(8)
    rk = rng.randint(0, 50, 700).astype(np.int32)
    sk = rng.randint(0, 50, 1100).astype(np.int32)
    rp = rng.randint(1, 1000, rk.size).astype(np.int32)
    sp = rng.randint(1, 1000, sk.size).astype(np.int32)
    # the sorts are deterministic for one input within one process
    r_sv, r_p = T.sort_by_key(torch.from_numpy(rk), torch.from_numpy(rp))
    s_sv, s_p = T.sort_by_key(torch.from_numpy(sk), torch.from_numpy(sp))
    h, fm = (x[:sk.size].numpy() for x in T.banded_match_descriptors(r_sv, s_sv))
    rows = np.repeat(np.arange(sk.size), h)
    within = np.arange(rows.size) - np.repeat(np.cumsum(h) - h, h)
    stream_r = r_p.numpy()[fm[rows] + within]
    stream_s = s_p.numpy()[:sk.size][rows]
    total = rows.size
    cap = total // 3 + 1
    exp_r, exp_s = np.zeros(cap, np.int32), np.zeros(cap, np.int32)
    exp_r[np.arange(total) % cap] = stream_r   # later writes win
    exp_s[np.arange(total) % cap] = stream_s
    out_r, out_s, tot = T.banded_materialize(
        *map(torch.from_numpy, (rk, rp, sk, sp)), capacity=cap, wrap=True)
    assert int(tot) == total
    np.testing.assert_array_equal(out_r.numpy(), exp_r)
    np.testing.assert_array_equal(out_s.numpy(), exp_s)


@pytest.mark.parametrize("n_r,n_s", [(0, 5), (5, 0), (300, 300)])
def test_materialize_without_matches_is_zero(n_r, n_s):
    rk = np.arange(n_r, dtype=np.int32)
    sk = np.arange(n_s, dtype=np.int32) + 1000
    ones = lambda n: np.ones(n, np.int32)
    out_r, out_s, total = T.banded_materialize(
        *map(torch.from_numpy, (rk, ones(n_r), sk, ones(n_s))), capacity=256)
    assert int(total) == 0 and out_r.shape == out_s.shape == (256,)
    assert not out_r.any() and not out_s.any()
    if n_s:   # the JAX function cannot index an empty S side
        j_r, j_s, j_tot = J.banded_materialize(
            *map(jnp.asarray, (rk, ones(n_r), sk, ones(n_s))), capacity=256)
        assert int(j_tot) == 0
        np.testing.assert_array_equal(out_r.numpy(), np.asarray(j_r))
        np.testing.assert_array_equal(out_s.numpy(), np.asarray(j_s))


def test_materialize_rejects_unknown_force():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="debug_force"):
        T.banded_materialize(z, z, z, z, capacity=8, debug_force="fastest")
