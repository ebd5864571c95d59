"""The port's distributed materializing join against the JAX package's, case
for case with the materialize tests of tests/test_distributed.py: per rank,
the live output slots hold the same (Pr, Ps) multiset as the same JAX
device's; totals and overflow equal; dead slots zero; all ranks together
equal to the oracle's multiset."""

import jax.numpy as jnp
import numpy as np
import pytest

from icde2019_gpu_join_tpu.parallel import dist_join as jdj
from icde2019_gpu_join_tpu_torch.parallel import dist_join as tdj
from icde2019_gpu_join_tpu_torch.utils import oracle
from tests.test_torch_dist_join import jax_mesh, port_mesh


def rows(out_r, out_s, totals, nd, cap, d):
    live = np.stack([out_r[d * cap:d * cap + totals[d]],
                     out_s[d * cap:d * cap + totals[d]]], axis=1)
    return live[np.lexsort((live[:, 1], live[:, 0]))]


def materialize_both(arrays, cap, nd=8, **kw):
    """Both packages; asserts per-rank multisets, totals and overflow equal
    (when no ring wrapped) and returns the port's (pairs [m, 2] sorted,
    totals)."""
    got = tdj.distributed_join_materialize(*arrays, port_mesh(nd),
                                           capacity_per_chip=cap, **kw)
    want = jdj.distributed_join_materialize(
        *(jnp.asarray(a) for a in arrays), jax_mesh(nd),
        capacity_per_chip=cap, **kw)
    out_r, out_s, totals, ov = (np.asarray(x) for x in got)
    w_r, w_s, w_tot, w_ov = (np.asarray(x) for x in want)
    assert int(ov) == int(w_ov) == 0
    np.testing.assert_array_equal(totals, w_tot)
    assert out_r.shape == out_s.shape == (nd * cap,)
    per_rank = []
    for d in range(nd):
        if totals[d] <= cap:
            mine = rows(out_r, out_s, totals, nd, cap, d)
            np.testing.assert_array_equal(mine, rows(w_r, w_s, w_tot, nd, cap, d))
            per_rank.append(mine)
    live = np.zeros(nd * cap, bool)
    for d in range(nd):
        live[d * cap:d * cap + min(totals[d], cap)] = True
    assert not out_r[~live].any() and not out_s[~live].any()
    pairs = np.concatenate(per_rank) if per_rank else np.zeros((0, 2), np.int32)
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))], totals


def test_distributed_materialize_matches_oracle(rng):
    n_r, n_s, nd = 4096, 16384, 8
    rk = rng.randint(0, 2 * n_r, n_r).astype(np.int32)
    sk = rk[rng.randint(0, n_r, n_s)].astype(np.int32)
    sk[rng.randint(0, n_s, n_s // 4)] = rng.randint(
        2 * n_r, 4 * n_r, n_s // 4).astype(np.int32)
    rp = rng.randint(1, 1000, n_r).astype(np.int32)
    sp = rng.randint(1, 1000, n_s).astype(np.int32)
    expect = oracle.join_materialize(rk, rp, sk, sp)
    cap = -(-(expect.shape[0] // nd + 4096) // 128) * 128
    pairs, totals = materialize_both((rk, rp, sk, sp), cap)
    assert (totals <= cap).all() and totals.sum() == expect.shape[0]
    np.testing.assert_array_equal(pairs, expect)


def test_distributed_materialize_truncates(rng):
    """wrap=False into 256 slots a rank: totals are the true counts (equal
    to JAX's) and every emitted pair is a real match. Which pairs survive
    the cut depends on the order of equal S keys, which neither sort fixes,
    so the contents are not compared with JAX's."""
    n_r, n_s, nd = 1024, 8192, 8
    rk = rng.permutation(n_r).astype(np.int32)
    sk = rk[rng.randint(0, n_r, n_s)].astype(np.int32)
    rp = rng.randint(1, 1000, n_r).astype(np.int32)
    sp = rng.randint(1, 1000, n_s).astype(np.int32)
    expect = set(map(tuple, oracle.join_materialize(rk, rp, sk, sp).tolist()))
    _, totals = materialize_both((rk, rp, sk, sp), 256, wrap=False)
    assert totals.sum() == n_s
    out_r, out_s, _, _ = tdj.distributed_join_materialize(
        rk, rp, sk, sp, port_mesh(nd), capacity_per_chip=256, wrap=False)
    pairs = np.stack([out_r.numpy(), out_s.numpy()], axis=1)
    pairs = pairs[(pairs[:, 0] != 0) | (pairs[:, 1] != 0)]
    assert pairs.shape[0] == nd * 256
    assert all(tuple(p) in expect for p in pairs.tolist())


def test_heavy_split_materialize_dominant_key(rng, monkeypatch):
    """One key at 50% of S: the heavy split runs, no rank's ring absorbs the
    whole hot key (totals within 2x uniform), per-rank outputs equal JAX's;
    without the split the owner takes over 2x."""
    calls = []
    heavy = tdj._local_materialize_heavy
    monkeypatch.setattr(tdj, "_local_materialize_heavy",
                        lambda *a, **k: calls.append(1) or heavy(*a, **k))
    n_r, n_s, nd = 2048, 16384, 8
    rk = rng.permutation(n_r).astype(np.int32)
    hot = int(rk[55])
    sk = np.where(rng.rand(n_s) < 0.5, hot,
                  rk[rng.randint(0, n_r, n_s)]).astype(np.int32)
    rp = rng.randint(1, 1000, n_r).astype(np.int32)
    sp = rng.randint(1, 1000, n_s).astype(np.int32)
    expect = oracle.join_materialize(rk, rp, sk, sp)
    uniform = expect.shape[0] / nd
    cap = -(-int(2.0 * uniform) // 128) * 128
    pairs, totals = materialize_both((rk, rp, sk, sp), cap)
    assert len(calls) == nd
    assert totals.max() <= 2.0 * uniform
    np.testing.assert_array_equal(pairs, expect)
    _, totals0 = materialize_both((rk, rp, sk, sp), cap, split_heavy=False)
    assert totals0.sum() == expect.shape[0] and totals0.max() > 2.0 * uniform


@pytest.mark.parametrize("seed", range(3))
def test_distributed_materialize_fuzz_multiset(seed):
    g = np.random.default_rng(6000 + seed)
    n_r, n_s, nd = 2048, 8192, 8
    if seed == 0:    # duplicate build keys (multi-match)
        rk = g.integers(0, 600, n_r).astype(np.int32)
        sk = g.integers(0, 1200, n_s).astype(np.int32)
    elif seed == 1:  # 40% of S on one key: the heavy materialize path
        rk = g.permutation(n_r).astype(np.int32)
        sk = np.where(g.random(n_s) < 0.4, rk[9],
                      rk[g.integers(0, n_r, n_s)]).astype(np.int32)
    else:            # sparse matches
        rk = g.integers(0, 1 << 20, n_r).astype(np.int32)
        sk = g.integers(0, 1 << 20, n_s).astype(np.int32)
    rp = g.integers(1, 1000, n_r).astype(np.int32)
    sp = g.integers(1, 1000, n_s).astype(np.int32)
    expect = oracle.join_materialize(rk, rp, sk, sp)
    cap = max(256, -(-2 * max(expect.shape[0], 1) // (nd * 128)) * 128)
    pairs, totals = materialize_both((rk, rp, sk, sp), cap)
    assert (totals <= cap).all()
    np.testing.assert_array_equal(pairs, expect)


def test_one_rank_materialize(rng):
    rk = rng.permutation(2048).astype(np.int32)
    sk = rk[rng.randint(0, 2048, 4096)].astype(np.int32)
    rp, sp = rk * 3 + 1, sk ^ 0x5bd1e995
    expect = oracle.join_materialize(rk, rp, sk, sp)
    pairs, _ = materialize_both((rk, rp, sk, sp), 8192, nd=1)
    np.testing.assert_array_equal(pairs, expect)


def test_negative_keys_are_refused_on_every_rank(rng):
    rk = rng.permutation(1024).astype(np.int32)
    sk = rk.copy()
    sk[900] = -5     # on the last rank only
    ones = np.ones(1024, np.int32)
    with pytest.raises(ValueError, match="key-domain"):
        tdj.distributed_join_materialize(rk, ones, sk, ones, port_mesh(8),
                                         capacity_per_chip=256)
