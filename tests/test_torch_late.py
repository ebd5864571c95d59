"""The port's late aggregate (`ClusteredJoin.late_aggregate`) against the
benchmark's plain reference of it, `late_sum` in
`joinbench/queries/late_aggregate.py`, on the CPU at small sizes: payloads
are row ids in table order (`Relation(keys)`), the extra int32 columns are
drawn from a seeded generator, and each match adds both sides' row sums,
mod 2^32."""

import importlib.util
import os

import pytest
import torch

from icde2019_gpu_join_tpu_torch.config import EngineConfig
from icde2019_gpu_join_tpu_torch.models.joins import ClusteredJoin
from icde2019_gpu_join_tpu_torch.relation import Relation
from joinbench import datagen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_R, N_S = 2048, 4096
KINDS = ("pkfk", "dup", "zipf")
COLS = ((4, 2), (0, 2), (4, 0))
# the banded path, and one partitioned mode at small probe tiles
MODES = ("auto", "blocked")


def _late_query():
    path = os.path.join(REPO, "joinbench", "queries", "late_aggregate.py")
    spec = importlib.util.spec_from_file_location("late_aggregate_query", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


late = _late_query()


def _keys(kind: str, g: torch.Generator):
    """(R keys, S keys): uniform PK-FK, duplicate R keys with some S keys
    missing, or Zipf(1.05) S keys over R's (key N_R has no match)."""
    if kind == "dup":
        rk = torch.randint(0, N_R // 8, (N_R,), generator=g)
        sk = torch.randint(0, N_R // 8 + 16, (N_S,), generator=g)
    else:
        rk = torch.randperm(N_R, generator=g)
        if kind == "pkfk":
            sk = rk[torch.randint(0, N_R, (N_S,), generator=g)]
        else:
            sk = datagen.zipf_keys(N_S, datagen.zipf_cdf(N_R, 1.05, "cpu"), g, "cpu")
    return rk.to(torch.int32), sk.to(torch.int32)


def _cols(n: int, width: int, values: str, g: torch.Generator):
    high = 0 if values == "negative" else 1 << 31
    return torch.randint(-(1 << 31), high, (n, width), generator=g,
                         dtype=torch.int64).to(torch.int32)


def _engine(mode: str) -> ClusteredJoin:
    if mode == "auto":
        return ClusteredJoin(device="cpu")
    return ClusteredJoin(EngineConfig(probe_mode=mode, probe_tile_r=64,
                                      probe_tile_s=64), device="cpu")


def _check(kind, cols, mode, values, seed):
    g = torch.Generator().manual_seed(seed)
    rk, sk = _keys(kind, g)
    rc, sc = _cols(N_R, cols[0], values, g), _cols(N_S, cols[1], values, g)
    r, s = Relation(rk), Relation(sk)
    assert torch.equal(r.payload, torch.arange(N_R, dtype=torch.int32))
    got = _engine(mode).late_aggregate(r, s, rc, sc).aggregate
    want = late.late_sum(rk, rc, sk, sc)
    assert got == want
    return want


CASES = [(k, c, m) for k in KINDS for c in COLS for m in MODES]


@pytest.mark.parametrize("kind,cols,mode", CASES)
def test_late_aggregate_matches_the_plain_reference(kind, cols, mode):
    seed = 1000 + CASES.index((kind, cols, mode))
    want = _check(kind, cols, mode, "full", seed)
    # the answer depends on the columns: narrowed to 16 bits it differs
    g = torch.Generator().manual_seed(seed)
    rk, sk = _keys(kind, g)
    rc, sc = _cols(N_R, cols[0], "full", g), _cols(N_S, cols[1], "full", g)
    assert late.late_sum(rk, rc, sk, sc, payload_bits=16) != want


@pytest.mark.parametrize("kind,mode", [(k, m) for k in KINDS for m in MODES])
def test_late_aggregate_with_negative_columns(kind, mode):
    _check(kind, (4, 2), mode, "negative", 77 + KINDS.index(kind))


def test_row_sums_wrap_and_narrow():
    cols = torch.tensor([[2**31 - 1, 1, 0], [-2**31, -1, 0], [0x12345, 0x10000, -3]],
                        dtype=torch.int32)
    assert late.row_sums(cols).tolist() == [-2**31, 2**31 - 1, 0x22342]
    # narrowed to 16 bits, sign-extended: 0x12345 -> 0x2345, 0x10000 -> 0
    assert late.row_sums(cols, 16).tolist() == [-1 + 1, 0 - 1, 0x2345 - 3]
    assert late.row_sums(torch.zeros((5, 0), dtype=torch.int32)).tolist() == [0] * 5
