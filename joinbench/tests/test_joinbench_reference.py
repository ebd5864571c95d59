"""The plain reference against a brute-force numpy join."""

import numpy as np
import pytest
import torch

from joinbench import reference


def _tables(seed: int, n_r: int, n_s: int, dup_r: bool):
    rng = np.random.RandomState(seed)
    dom = 2 * n_r
    r_keys = (rng.randint(0, dom, n_r) if dup_r
              else rng.permutation(dom)[:n_r]).astype(np.int32)
    s_keys = rng.randint(0, dom + 5, n_s).astype(np.int32)
    r_pay = rng.randint(-(2**31), 2**31, n_r, dtype=np.int64).astype(np.int32)
    s_pay = rng.randint(-(2**31), 2**31, n_s, dtype=np.int64).astype(np.int32)
    return r_keys, r_pay, s_keys, s_pay


def _brute(r_keys, r_pay, s_keys, s_pay, bits=32):
    """Every (r, s) with equal keys, by an n_r x n_s comparison."""
    if bits == 16:
        r_pay = r_pay.astype(np.int16).astype(np.int32)
        s_pay = s_pay.astype(np.int16).astype(np.int32)
    ri, si = np.nonzero(r_keys[:, None] == s_keys[None, :])
    agg = sum(int(r_pay[i]) * int(s_pay[j]) for i, j in zip(ri, si))
    pairs = sorted((int(r_pay[i]) << 32) | (int(s_pay[j]) & 0xFFFFFFFF)
                   for i, j in zip(ri, si))
    return reference.to_i32(agg), [p - (1 << 64) if p >= 1 << 63 else p for p in pairs]


CASES = [(seed, n_r, n_s, dup) for seed in (1, 2, 3)
         for n_r, n_s in ((1, 7), (50, 300), (257, 1000)) for dup in (False, True)]


@pytest.mark.parametrize("seed,n_r,n_s,dup", CASES)
@pytest.mark.parametrize("bits", [32, 16])
def test_aggregate_and_pairs_match_brute_force(seed, n_r, n_s, dup, bits):
    cols = _tables(seed, n_r, n_s, dup)
    agg, pairs = _brute(*cols, bits=bits)
    t = [torch.from_numpy(c) for c in cols]
    assert reference.aggregate(*t, payload_bits=bits) == agg
    n, packed = reference.pairs(*t, payload_bits=bits)
    assert n == len(pairs)
    assert packed.tolist() == pairs


def test_blocks_of_s_give_the_same_answer(monkeypatch):
    t = [torch.from_numpy(c) for c in _tables(9, 300, 2000, True)]
    whole = reference.aggregate(*t), reference.pairs(*t)[1]
    monkeypatch.setattr(reference, "_S_BLOCK", 97)
    assert reference.aggregate(*t) == whole[0]
    assert torch.equal(reference.pairs(*t)[1], whole[1])


def test_control_precision_differs_from_the_configuration_s():
    t = [torch.from_numpy(c) for c in _tables(4, 500, 4000, False)]
    assert reference.aggregate(*t, payload_bits=16) != reference.aggregate(*t)
    assert not torch.equal(reference.pairs(*t, payload_bits=16)[1],
                           reference.pairs(*t)[1])


def test_mulmod32_is_exact_at_the_extremes():
    vals = torch.tensor([0, 1, 2**16 - 1, 2**16, 2**31, 2**32 - 1],
                        dtype=torch.int64)
    a, b = torch.meshgrid(vals, vals, indexing="ij")
    got = reference._mulmod32(a.reshape(-1), b.reshape(-1)).tolist()
    want = [(int(x) * int(y)) % (1 << 32) for x, y in
            zip(a.reshape(-1).tolist(), b.reshape(-1).tolist())]
    assert got == want


def _fold_model(words):
    """`reference.fold` in Python integers, mod 2^64."""
    m = (1 << 64) - 1

    def mix(w):
        w = (w + 0x9E3779B97F4A7C15) & m
        w = ((w ^ (w >> 30)) * 0xBF58476D1CE4E5B9) & m
        w = ((w ^ (w >> 27)) * 0x94D049BB133111EB) & m
        return w ^ (w >> 31)
    return sum(w & m for w in words) & m, sum(mix(w & m) for w in words) & m


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_checksum_is_the_multiset_s_and_order_free(seed, monkeypatch):
    cols = _tables(seed, 257, 1000, True)
    t = [torch.from_numpy(c) for c in cols]
    n, packed = reference.pairs(*t)
    assert reference.fold(packed) == _fold_model(packed.tolist())
    pr, ps = (packed >> 32).to(torch.int32), packed.to(torch.int32)
    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n, generator=g)
    monkeypatch.setattr(reference, "_S_BLOCK", 61)
    assert reference.checksum(pr[perm], ps[perm]) == reference.fold(packed)
    # a pairing swapped between two rows keeps the sums of Pr and of Ps
    i, j = int(torch.argmin(ps)), int(torch.argmax(ps))
    ps2 = ps.clone()
    ps2[i], ps2[j] = ps[j], ps[i]
    got = reference.checksum(pr, ps2)
    assert got[0] == reference.fold(packed)[0]
    assert got[1] != reference.fold(packed)[1]
