"""The port's ops/band_join.py against the JAX package's, bit for bit.

Sorts are unstable in both frameworks, so sorted keys are compared element
by element and payloads as per-key multisets; the windows depend only on
the sorted keys and must be equal."""

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


def test_probe_rejects_add_mode():
    sv = torch.zeros(128, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="queue 1, item 2"):
        T.banded_probe(sv, sv, sv, sv, 1, "add")
