"""The generator's distributions at small sizes."""

import math

import numpy as np
import pytest
import torch

from joinbench import datagen


def _cycle(n: int, maxid: int) -> np.ndarray:
    """`random_unique_gen`'s fill loop before its shuffle, as written in C."""
    out, fk = np.empty(n, np.int64), 0
    for i in range(n):
        out[i] = fk
        if fk == maxid:
            fk = 0
        fk += 1
    return out


@pytest.mark.parametrize("n", [1, 128, 1000, 4096])
def test_r_keys_and_uniform_s_are_permutations_of_the_domain(n):
    (rk, rp, sk, sp), = datagen.make_pairs(
        {"n_r": n, "n_s": n, "s_keys": "uniform", "zipf_z": 0.0}, 1, 7, "cpu")
    domain = np.arange(n)
    assert np.array_equal(np.sort(rk.numpy()), domain)
    assert np.array_equal(np.sort(sk.numpy()), domain)
    for col in (rk, rp, sk, sp):
        assert col.dtype == torch.int32 and col.shape == (n,)


@pytest.mark.parametrize("n,maxid", [(10, 10), (25, 10), (100, 7), (7, 100)])
def test_unique_keys_cycle_as_the_reference_fills_it(n, maxid):
    got = datagen.unique_keys(n, maxid, datagen.generator(3, "cpu"), "cpu")
    assert np.array_equal(np.sort(got.numpy()), np.sort(_cycle(n, maxid)))


def test_payloads_cover_the_whole_int32_range():
    p = datagen.payloads(1 << 16, datagen.generator(5, "cpu"), "cpu").numpy()
    assert p.min() < -(1 << 30) and p.max() > (1 << 30)
    assert (p < 0).mean() == pytest.approx(0.5, abs=0.02)


def test_zipf_rank_frequencies_match_the_formula():
    n_r, n_s, z = 64, 1 << 18, 1.05
    cdf = datagen.zipf_cdf(n_r, z, "cpu")
    assert float(cdf[-1]) == 1.0
    keys = datagen.zipf_keys(n_s, cdf, datagen.generator(11, "cpu"), "cpu").numpy()
    assert keys.min() >= 1 and keys.max() <= n_r
    counts = np.bincount(keys, minlength=n_r + 1)[1:]
    # the permutation relabels ranks: the k-th most frequent key is rank k
    freq = np.sort(counts)[::-1] / n_s
    p = np.arange(1, n_r + 1, dtype=np.float64) ** -z
    p /= p.sum()
    for k in range(8):
        sigma = math.sqrt(p[k] * (1 - p[k]) / n_s)
        assert abs(freq[k] - p[k]) < 5 * sigma, (k, freq[k], p[k])


def test_zipf_alphabet_is_a_permutation_of_one_to_n():
    # with all the mass on rank 1, every key is the alphabet's first entry,
    # and over many seeds each of 1..n turns up there
    n = 8
    cdf = torch.ones(n, dtype=torch.float64)
    firsts = {int(datagen.zipf_keys(4, cdf, datagen.generator(s, "cpu"), "cpu")[0])
              for s in range(200)}
    assert firsts == set(range(1, n + 1))


def test_same_seed_same_inputs_other_seed_other_inputs():
    conf = {"n_r": 512, "n_s": 512, "s_keys": "zipf", "zipf_z": 1.05}
    a = datagen.make_pairs(conf, 2, 2**31 + 99, "cpu")
    b = datagen.make_pairs(conf, 2, 2**31 + 99, "cpu")
    c = datagen.make_pairs(conf, 2, 2**31 + 100, "cpu")
    for pa, pb in zip(a, b):
        assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    assert not torch.equal(a[0][2], c[0][2])
    assert not torch.equal(a[0][2], a[1][2])   # the two pairs differ


def test_unknown_distribution_is_refused():
    with pytest.raises(ValueError):
        datagen.make_pairs({"n_r": 4, "n_s": 4, "s_keys": "normal"}, 1, 0, "cpu")
