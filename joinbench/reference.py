"""The plain reference: the join's answers worked out again from the inputs
the benchmark made, in plain torch, independent of the program.

R is sorted once; each S key finds its run of equal R keys by binary search,
[lo, hi). The aggregate adds Ps times the sum of Pr over that run; the
pairs are every (Pr, Ps) of the runs. Arithmetic is exact mod 2^32, as the
program's int32 wraparound: sums in int64 are reduced mod 2^32 and each
product is split into 16-bit halves so that no int64 overflows. S is taken
in blocks, so that a relation of 2^28 rows fits beside the inputs.

`payload_bits` narrows every payload to its low bits, sign-extended, before
the join: at 16 it is the control, the same join in the next lower integer
precision, which the comparison has to fail.

A materialized output is compared whole as a multiset by `checksum`: the
sum of its (Pr, Ps) words and the sum of a mix of each word, both mod 2^64,
which no order of the same pairs changes.
"""

from __future__ import annotations

from typing import Tuple

import torch

_S_BLOCK = 1 << 25
_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1
# splitmix64's increment and multipliers, as signed int64 values
_GOLDEN = -7046029254386353131
_MIX1 = -4658895280553007687
_MIX2 = -7723592293110705685


def narrow(pay: torch.Tensor, payload_bits: int) -> torch.Tensor:
    """Payloads as int32, narrowed to `payload_bits` (32: unchanged)."""
    if payload_bits == 32:
        return pay
    if payload_bits == 16:
        return pay.to(torch.int16).to(torch.int32)
    raise ValueError(f"no {payload_bits}-bit payloads")


def _build(r_keys: torch.Tensor, r_pay: torch.Tensor):
    keys, order = torch.sort(r_keys.to(torch.int64), stable=True)
    return keys, r_pay[order]


def _runs(r_sorted: torch.Tensor, s_keys: torch.Tensor):
    s = s_keys.to(torch.int64)
    lo = torch.searchsorted(r_sorted, s)
    hi = torch.searchsorted(r_sorted, s, right=True)
    return lo, hi


def _mulmod32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod 2^32 for int64 tensors holding values in [0, 2^32)."""
    lo16, hi16 = b & 0xFFFF, b >> 16
    return (a * lo16 + (((a * hi16) & 0xFFFF) << 16)) & _MASK32


def to_i32(v: int) -> int:
    """An integer mod 2^32 as a signed int32 value."""
    v &= _MASK32
    return v - (1 << 32) if v >= 1 << 31 else v


def aggregate(r_keys, r_pay, s_keys, s_pay, payload_bits: int = 32) -> int:
    """SUM(Pr * Ps) over key matches, mod 2^32, as a signed int32 value."""
    r_sorted, rp = _build(r_keys, narrow(r_pay, payload_bits))
    prefix = torch.zeros(rp.shape[0] + 1, dtype=torch.int64, device=rp.device)
    torch.cumsum(rp.to(torch.int64), 0, out=prefix[1:])
    total = torch.zeros((), dtype=torch.int64, device=rp.device)
    for start in range(0, s_keys.shape[0], _S_BLOCK):
        sk = s_keys[start:start + _S_BLOCK]
        sp = narrow(s_pay[start:start + _S_BLOCK], payload_bits)
        lo, hi = _runs(r_sorted, sk)
        run_sum = (prefix[hi] - prefix[lo]) & _MASK32
        total += _mulmod32(run_sum, sp.to(torch.int64) & _MASK32).sum()
        total &= _MASK32
    return to_i32(int(total))


def pack(pr: torch.Tensor, ps: torch.Tensor) -> torch.Tensor:
    """(Pr, Ps) int32 pairs as one int64 each, Pr in the high word."""
    return (pr.to(torch.int64) << 32) | (ps.to(torch.int64) & _MASK32)


def pairs(r_keys, r_pay, s_keys, s_pay, payload_bits: int = 32
          ) -> Tuple[int, torch.Tensor]:
    """(match count, every matched (Pr, Ps) pair packed by `pack`, sorted)."""
    r_sorted, rp = _build(r_keys, narrow(r_pay, payload_bits))
    out = []
    for start in range(0, s_keys.shape[0], _S_BLOCK):
        sk = s_keys[start:start + _S_BLOCK]
        sp = narrow(s_pay[start:start + _S_BLOCK], payload_bits)
        lo, hi = _runs(r_sorted, sk)
        n = hi - lo
        s_idx = torch.repeat_interleave(torch.arange(sk.shape[0], device=sk.device), n)
        first = torch.cumsum(n, 0) - n
        r_idx = lo[s_idx] + torch.arange(s_idx.shape[0], device=sk.device) - first[s_idx]
        out.append(pack(rp[r_idx], sp[s_idx]))
    packed = torch.cat(out) if out else torch.zeros(0, dtype=torch.int64)
    return packed.shape[0], torch.sort(packed).values


def _mix(w: torch.Tensor) -> torch.Tensor:
    """splitmix64's step on int64 words, wrapping mod 2^64 (logical shifts
    by masking the arithmetic ones). Pairings swapped between two rows keep
    the sums of Pr and of Ps; they do not keep the sum of this."""
    w = w + _GOLDEN
    w = (w ^ ((w >> 30) & ((1 << 34) - 1))) * _MIX1
    w = (w ^ ((w >> 27) & ((1 << 37) - 1))) * _MIX2
    return w ^ ((w >> 31) & ((1 << 33) - 1))


def fold(packed: torch.Tensor) -> Tuple[int, int]:
    """(the sum of the words, the sum of their `_mix`), each mod 2^64 as an
    unsigned value: the same for every order of the same multiset."""
    acc = torch.zeros(2, dtype=torch.int64, device=packed.device)
    for start in range(0, packed.shape[0], _S_BLOCK):
        w = packed[start:start + _S_BLOCK]
        acc[0] += w.sum()
        acc[1] += _mix(w).sum()
    a, b = acc.tolist()
    return a & _MASK64, b & _MASK64


def checksum(pr: torch.Tensor, ps: torch.Tensor) -> Tuple[int, int]:
    """`fold` of the (Pr, Ps) pairs of an output, packed a block at a time."""
    acc = [0, 0]
    for start in range(0, pr.shape[0], _S_BLOCK):
        a, b = fold(pack(pr[start:start + _S_BLOCK], ps[start:start + _S_BLOCK]))
        acc = [acc[0] + a, acc[1] + b]
    return acc[0] & _MASK64, acc[1] & _MASK64
