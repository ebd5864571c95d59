"""The radix pair sort (`ops/radix_pairs.py`, `csrc/radix_pairs.cu`).

* the wrapper's checks, and its CPU route, which is the plain version
  (`torch_sort_pairs`: `torch.sort` + gather);
* `_radix_model`, a plain PyTorch model of the kernels' arithmetic: the
  histogram of all four digits, and each pass's tiles of kThreads x kItems
  rows, the warps' ranking rounds (rows i * 32 + lane, peers by digit, the
  warp's counter), the warps' offsets, the tile's first row of each digit,
  the look-back prefix over earlier tiles, the buckets, and the scatter of
  the rows staged in digit order, all in uint32 arithmetic. Its constants
  are read from the CUDA source; change the model with the kernel. Held
  against `torch_sort_pairs` (keys equal, each key's payloads equal as
  multisets) and against a stable sort (the kernel is stable);
* the callers switched to the kernel on the card, each of which compares
  its results as sums or multisets (ROADMAP R1): the test runs each on the
  CPU with the ties of the plain sort reversed and finds the same results;
* card-only cases (marker `card`), which skip without a card.
"""

from __future__ import annotations

import inspect
import os
import re

import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu_torch.ops import band_join, merge, radix_pairs
from icde2019_gpu_join_tpu_torch.parallel import dist_join, exchange

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "icde2019_gpu_join_tpu_torch", "csrc", "radix_pairs.cu")
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1
SIGN = 1 << 31
U32 = 1 << 32


def _constant(name: str) -> int:
    with open(SOURCE) as f:
        text = f.read()
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, f"{name} not found in {SOURCE}"
    expr = m.group(1)
    for other in ("kBits", "kThreads", "kItems"):
        if other in expr:
            expr = expr.replace(other, str(_constant(other)))
    return int(eval(expr, {}))


BITS = _constant("kBits")
DIGITS = _constant("kDigits")
THREADS = _constant("kThreads")
ITEMS = _constant("kItems")
WARPS = THREADS // 32
TILE = THREADS * ITEMS
PASSES = 32 // BITS


def test_wrapper_constants_are_the_kernels():
    assert (radix_pairs.TILE, radix_pairs.DIGITS, radix_pairs.PASSES) == (
        TILE, DIGITS, PASSES) == (_constant("kTile"), 256, 4)


# ---- the model -------------------------------------------------------------

def _digits(u: torch.Tensor, p: int) -> torch.Tensor:
    """Digit p of uint32 words held in int64, the sign bit flipped."""
    return ((u ^ SIGN) >> (BITS * p)) & (DIGITS - 1)


def _excl(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim) - x


def _pass_model(keys: torch.Tensor, vals: torch.Tensor, hist: torch.Tensor,
                p: int):
    """One tj_radix_pass over uint32 words in int64 tensors."""
    n = keys.shape[0]
    tiles = -(-n // TILE)
    total = tiles * TILE
    # rows past n: the key whose every digit is 255 (`kPastN`)
    kp = torch.full((total,), 0x7FFFFFFF, dtype=torch.int64)
    kp[:n] = keys
    # row w * kWarpRows + i * 32 + lane of a tile -> [tile, warp, i, lane]
    d = _digits(kp, p).view(tiles, WARPS, ITEMS, 32)
    counter = torch.zeros(tiles, WARPS, DIGITS, dtype=torch.int64)
    rank = torch.zeros(tiles, WARPS, ITEMS, 32, dtype=torch.int64)
    lower = torch.tril(torch.ones(32, 32, dtype=torch.bool), -1)  # [l, l'<l]
    for i in range(ITEMS):
        di = d[:, :, i, :]
        peers = di[..., :, None] == di[..., None, :]
        below = (peers & lower).sum(-1)
        before = torch.gather(counter, 2, di)
        rank[:, :, i, :] = before + below
        counter.scatter_add_(2, di, torch.ones_like(di))
    warp_off = _excl(counter, 1)
    rows = (n - torch.arange(tiles) * TILE).clamp(max=TILE)
    count = counter.sum(1)                                   # [tile, digit]
    count[:, DIGITS - 1] -= TILE - rows                      # the rows past n
    first = _excl(count, 1)
    prefix = _excl(count, 0)
    bucket = _excl(hist, 0)
    dest = (bucket[None, :] + prefix - first) % U32
    pos = (torch.gather(first[:, None, :].expand(-1, WARPS, -1), 2,
                        d.reshape(tiles, WARPS, ITEMS * 32)).view_as(d)
           + torch.gather(warp_off, 2, d.reshape(tiles, WARPS, ITEMS * 32)).view_as(d)
           + rank)
    assert torch.equal(torch.sort(pos.reshape(tiles, TILE)).values,
                       torch.arange(TILE).expand(tiles, -1)), "staging collides"
    staged_k = torch.zeros(tiles, TILE, dtype=torch.int64)
    staged_v = torch.zeros(tiles, TILE, dtype=torch.int64)
    t_of = torch.arange(tiles)[:, None, None, None].expand_as(d)
    vp = torch.zeros(total, dtype=torch.int64)
    vp[:n] = vals
    staged_k[t_of, pos] = kp.view_as(d)
    staged_v[t_of, pos] = vp.view_as(d)
    live = torch.arange(TILE)[None, :] < rows[:, None]
    out_at = (torch.gather(dest, 1, _digits(staged_k, p)) +
              torch.arange(TILE)[None, :]) % U32
    out_k = torch.full((n,), -1, dtype=torch.int64)
    out_v = torch.full((n,), -1, dtype=torch.int64)
    out_k[out_at[live]] = staged_k[live]
    out_v[out_at[live]] = staged_v[live]
    assert int((out_k < 0).sum()) == 0, "a row of the output was not written"
    return out_k, out_v


def _radix_model(sv: torch.Tensor, pv: torch.Tensor):
    """The four passes over int32 (sv, pv), as the kernels compute them."""
    keys, vals = sv.long() % U32, pv.long() % U32
    hist = torch.stack([torch.bincount(_digits(keys, p), minlength=DIGITS)
                        for p in range(PASSES)])
    for p in range(PASSES):
        keys, vals = _pass_model(keys, vals, hist[p], p)
    to32 = lambda x: torch.where(x >= SIGN, x - U32, x).to(torch.int32)
    return to32(keys), to32(vals)


def _words(sv, pv) -> torch.Tensor:
    """(key, payload) pairs as sorted int64 words: equal iff every key's
    payload multiset is."""
    return torch.sort((sv.long() << 32) | (pv.long() & 0xFFFFFFFF)).values


def _keys(kind: str, n: int, rs: np.random.RandomState) -> np.ndarray:
    if kind == "uniform":
        return rs.randint(INT32_MIN, INT32_MAX, n, dtype=np.int64)
    if kind == "sentinels":   # INT32_MIN / MAX, the pad key -1's sortval
        k = rs.randint(-50, 50, n, dtype=np.int64)
        pick = rs.randint(0, 4, n)
        return np.where(pick == 0, INT32_MIN, np.where(
            pick == 1, INT32_MAX, np.where(pick == 2, -1, k)))
    if kind == "equal":
        return np.full(n, 12345, np.int64)
    if kind == "zipf":        # ranks by Zipf(1.05), through a permutation
        alphabet = rs.permutation(1 << 20).astype(np.int64) * 4099 - 2**31
        ranks = np.minimum(rs.zipf(1.05, n), 1 << 20) - 1
        return alphabet[ranks]
    raise ValueError(kind)


SIZES = (0, 1, 127, 128, (1 << 16) + 3)
KINDS = ("uniform", "sentinels", "equal", "zipf")


def _pairs(kind: str, n: int, seed: int = 7):
    rs = np.random.RandomState(seed + n)
    sv = torch.from_numpy(_keys(kind, n, rs).astype(np.int32))
    pv = torch.from_numpy(rs.randint(INT32_MIN, INT32_MAX, n,
                                     dtype=np.int64).astype(np.int32))
    return sv, pv


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_model_sorts_like_the_plain_version(n, kind):
    sv, pv = _pairs(kind, n)
    got_k, got_v = _radix_model(sv, pv)
    want_k, want_v = radix_pairs.torch_sort_pairs(sv, pv)
    assert torch.equal(got_k, want_k)
    assert torch.equal(_words(got_k, got_v), _words(want_k, want_v))
    # and stably: equal keys keep their payloads' input order
    stable_k, idx = torch.sort(sv, stable=True)
    assert torch.equal(got_k, stable_k) and torch.equal(got_v, pv[idx])


def test_model_zipf_has_a_hot_digit():
    """The Zipf case exercises a hot bucket in every pass."""
    sv, _ = _pairs("zipf", (1 << 16) + 3)
    u = sv.long() % U32
    for p in range(PASSES):
        top = torch.bincount(_digits(u, p), minlength=DIGITS).max()
        assert int(top) > 0.05 * sv.shape[0]


# ---- the wrapper -----------------------------------------------------------

def _bad_inputs():
    sv = torch.arange(16, dtype=torch.int32)
    pv = torch.arange(16, dtype=torch.int32)
    big = torch.empty(1 << 31, dtype=torch.int32, device="meta")
    return {
        "int64 keys": (sv.long(), pv),
        "int16 keys": (sv.short(), pv),
        "int64 payloads": (sv, pv.long()),
        "int16 payloads": (sv, pv.short()),
        "float32 payloads": (sv, pv.float()),
        "2-D keys": (sv.view(4, 4), pv.view(4, 4)),
        "2-D payloads": (sv, pv.view(1, 16)),
        "strided keys": (torch.arange(32, dtype=torch.int32)[::2], pv),
        "strided payloads": (sv, torch.arange(32, dtype=torch.int32)[::2]),
        "lengths differ": (sv, pv[:15]),
        "2^31 rows": (big, big),
        "devices differ": (sv, pv.to("meta")),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_refuses(case):
    sv, pv = _bad_inputs()[case]
    with pytest.raises(ValueError):
        radix_pairs.radix_sort_pairs(sv, pv)


@pytest.mark.parametrize("kind", ["sentinels", "zipf"])
@pytest.mark.parametrize("n", SIZES)
def test_cpu_route_is_the_plain_version(n, kind):
    sv, pv = _pairs(kind, n)
    before = dict(radix_pairs.LAUNCHES)
    got = radix_pairs.radix_sort_pairs(sv, pv)
    want = radix_pairs.torch_sort_pairs(sv, pv)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert radix_pairs.LAUNCHES == before


def test_sort_pairs_lax_route_is_the_radix_sort(monkeypatch):
    calls = []
    real = radix_pairs.radix_sort_pairs
    monkeypatch.setattr(band_join, "radix_sort_pairs",
                        lambda sv, pv: calls.append(sv.shape[0]) or real(sv, pv))
    sv, pv = _pairs("uniform", 300)
    for impl in (None, "lax"):
        band_join.sort_pairs(sv, pv, impl)
    assert calls == [300, 300]


# ---- the callers switched on the card --------------------------------------

# Each caller of the pair sort on the card, and how the results it feeds are
# compared: the radix sort is stable and the plain one is not, so neither
# order among equal keys may reach an answer (ROADMAP R1).
CALLERS = {
    "band_join.sort_pairs": (
        band_join.sort_pairs,
        "sums (aggregate, count, late aggregate, config 3's groups) and "
        "multisets (materialized pairs, radix_partition's partitions)"),
    "merge.merge_sort_pairs": (
        merge.merge_sort_pairs,
        "its fallback stands in for the cascade: each key's payload multiset"),
    "exchange.partition_to_buckets": (
        exchange.partition_to_buckets,
        "each bucket's rows as a multiset; receivers sort again"),
    "dist_join._pack_heavy": (
        dist_join._pack_heavy,
        "the heavy frame's rows as a multiset, joined into sums or pairs"),
}


def _ties_reversed(sv, pv):
    """A plain sort whose ties come out in reverse input order."""
    s, idx = torch.sort(sv.flip(0), stable=True)
    return s, pv.flip(0)[idx]


def _dup_tables(n: int = 3000, seed: int = 3):
    rs = np.random.RandomState(seed)
    rk = rs.randint(0, 200, n).astype(np.int32)
    sk = rs.randint(0, 200, n).astype(np.int32)
    rp = rs.randint(INT32_MIN, INT32_MAX, n, dtype=np.int64).astype(np.int32)
    sp = rs.randint(INT32_MIN, INT32_MAX, n, dtype=np.int64).astype(np.int32)
    return [torch.from_numpy(a) for a in (rk, rp, sk, sp)]


def _rows(k, p) -> list:
    return sorted(zip(k.tolist(), p.tolist()))


def _caller_results(name: str):
    """The caller's results as they are compared: sums and multisets."""
    rk, rp, sk, sp = _dup_tables()
    if name == "band_join.sort_pairs":
        agg = int(band_join.banded_join_aggregate(rk, rp, sk, sp))
        out_r, out_s, total = band_join.banded_materialize(
            rk, rp, sk, sp, capacity=1 << 16)
        part = band_join.sort_by_key(rk, rp)
        return agg, int(total), _rows(out_r, out_s), _rows(*part)
    if name == "merge.merge_sort_pairs":
        return _rows(*merge.merge_sort_pairs(rk, rp))      # n: no power of 2
    if name == "exchange.partition_to_buckets":
        fr = exchange.partition_to_buckets(rk, rp, 4, 1024, 0)
        return [_rows(k, p) for k, p in zip(fr.keys, fr.pays)]
    if name == "dist_join._pack_heavy":
        hk, hp, ov = dist_join._pack_heavy(rk, rp, rk < 20, 1024, 0)
        return _rows(hk, hp), int(ov)
    raise ValueError(name)


@pytest.mark.parametrize("name", sorted(CALLERS))
def test_caller_goes_through_the_radix_sort(name):
    fn, compared_as = CALLERS[name]
    assert compared_as
    assert "radix_sort_pairs(" in inspect.getsource(fn)


@pytest.mark.parametrize("name", sorted(CALLERS))
def test_caller_results_do_not_depend_on_tie_order(name, monkeypatch):
    want = _caller_results(name)
    monkeypatch.setattr(radix_pairs, "torch_sort_pairs", _ties_reversed)
    assert _caller_results(name) == want


def test_no_other_module_sorts_pairs_by_the_library_route():
    """Outside `ops/radix_pairs.py` (and the sort tools' yardsticks under
    `benchmarks/`), the port reaches `torch_sort_pairs` only through
    `radix_sort_pairs`."""
    pkg = os.path.dirname(os.path.dirname(SOURCE))
    found = []
    for root, _, files in os.walk(pkg):
        if os.path.basename(root) == "benchmarks":
            continue
        for f in files:
            path = os.path.join(root, f)
            if f.endswith(".py") and f != "radix_pairs.py":
                with open(path) as fh:
                    if "torch_sort_pairs(" in fh.read():
                        found.append(os.path.relpath(path, pkg))
    assert found == []


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU route")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES + ((1 << 22) + 5,))
def test_kernel_is_a_stable_sort_on_the_card(card, n, kind):
    sv, pv = _pairs(kind, n)
    before = radix_pairs.LAUNCHES["radix_pass"]
    got_k, got_v = radix_pairs.radix_sort_pairs(sv.to(card), pv.to(card))
    torch.cuda.synchronize()
    stable_k, idx = torch.sort(sv, stable=True)
    assert torch.equal(got_k.cpu(), stable_k)
    assert torch.equal(got_v.cpu(), pv[idx])
    assert radix_pairs.LAUNCHES["radix_pass"] - before == (4 if n else 0)
