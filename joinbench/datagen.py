"""The benchmark's inputs, made on the device from the seed.

The distributions are those of the reference's generator (generator_ETHZ,
as the JAX package's `host_engine.cpp` reproduces it), rewritten in torch
so that a relation of 2^28 rows is made on the card in a few large calls:

* R: unique keys, a random permutation of 0 .. n_r - 1 (`random_unique_gen`
  with maxid = n_r).
* S uniform: `random_unique_gen(n_s, n_r)`'s cycle 0, 1, .., n_r, 1, .., n_r,
  .. shuffled; at n_s = n_r each of R's keys exactly once.
* S Zipf(z): ranks 1 .. n_r drawn with P(k) proportional to k^-z by a search
  in the float64 CDF, each rank mapped through a random permutation of
  1 .. n_r (`gen_zipf`). Key n_r is not in R, so its rows find no match.
* Payloads: int32 over the whole range.

Every draw comes from one `torch.Generator` on the device, seeded with the
run's seed, in a fixed order: the same seed gives the same inputs on the
same kind of device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# rows of S drawn and searched at a time, which bounds the Zipf draw's
# float64 transients
_ZIPF_BLOCK = 1 << 26

Pair = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed) % (1 << 64))
    return g


def payloads(n: int, g: torch.Generator, device) -> torch.Tensor:
    """n int32 payloads over the whole int32 range."""
    return torch.randint(-(1 << 31), 1 << 31, (n,), generator=g,
                         device=device, dtype=torch.int64).to(torch.int32)


def permutation(n: int, g: torch.Generator, device) -> torch.Tensor:
    return torch.randperm(n, generator=g, device=device, dtype=torch.int64)


def unique_keys(n: int, maxid: int, g: torch.Generator, device) -> torch.Tensor:
    """`random_unique_gen(n, maxid)`: 0, 1, .., maxid, then 1, .., maxid
    again and again, shuffled."""
    i = torch.arange(n, device=device, dtype=torch.int64)
    cycle = torch.where(i <= maxid, i, (i - maxid - 1) % maxid + 1)
    return cycle[permutation(n, g, device)].to(torch.int32)


def zipf_cdf(n: int, z: float, device) -> torch.Tensor:
    """The float64 CDF of ranks 1 .. n under Zipf(z); its last entry is
    exactly 1."""
    w = torch.arange(1, n + 1, device=device, dtype=torch.float64).pow_(-z)
    cdf = torch.cumsum(w, 0)
    return cdf.div_(cdf[-1].clone())


def zipf_keys(n: int, cdf: torch.Tensor, g: torch.Generator,
              device) -> torch.Tensor:
    """n keys: Zipf ranks over 1 .. len(cdf) through a random permutation of
    that alphabet."""
    alphabet = permutation(cdf.shape[0], g, device) + 1
    out = torch.empty(n, device=device, dtype=torch.int32)
    for start in range(0, n, _ZIPF_BLOCK):
        stop = min(n, start + _ZIPF_BLOCK)
        u = torch.rand(stop - start, generator=g, device=device,
                       dtype=torch.float64)
        # first rank whose CDF reaches u, as the reference's binary search
        pos = torch.searchsorted(cdf, u).clamp_(max=cdf.shape[0] - 1)
        out[start:stop] = alphabet[pos]
    return out


def make_pairs(config: Dict, n_pairs: int, seed: int, device) -> List[Pair]:
    """`n_pairs` input pairs (r_keys, r_pay, s_keys, s_pay) for a
    configuration, drawn in order from one generator seeded with `seed`."""
    n_r, n_s = int(config["n_r"]), int(config["n_s"])
    dist = config["s_keys"]
    if dist not in ("uniform", "zipf"):
        raise ValueError(f"unknown S key distribution {dist!r}")
    g = generator(seed, device)
    cdf = zipf_cdf(n_r, float(config["zipf_z"]), device) if dist == "zipf" else None
    pairs = []
    for _ in range(n_pairs):
        r_keys = permutation(n_r, g, device).to(torch.int32)
        r_pay = payloads(n_r, g, device)
        if cdf is None:
            s_keys = unique_keys(n_s, n_r, g, device)
        else:
            s_keys = zipf_keys(n_s, cdf, g, device)
        s_pay = payloads(n_s, g, device)
        pairs.append((r_keys, r_pay, s_keys, s_pay))
    return pairs
