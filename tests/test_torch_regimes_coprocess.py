"""The port's co-processing regime and its overlap leg against the JAX
package's on the same numpy inputs (mirrors test_joins.py::
test_coprocess_join and test_fuzz_engine.py::
test_coprocess_fuzz_vs_host_oracle). Every aggregate equals JAX's
`coprocess_join_aggregate` bit for bit, as an int32, and the host
oracle's. The port pads no partition slice (JAX pads to powers of two for
its jit cache); the sentinels add nothing, so the sums agree."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu import config as jconfig
from icde2019_gpu_join_tpu import datagen as jdatagen
from icde2019_gpu_join_tpu.models import joins as jjoins
from icde2019_gpu_join_tpu.models.coprocess import (
    coprocess_join_aggregate as jax_coprocess)
from icde2019_gpu_join_tpu.relation import Relation as JaxRelation
from icde2019_gpu_join_tpu_torch import datagen as tdatagen
from icde2019_gpu_join_tpu_torch.benchmarks import overlap_bench
from icde2019_gpu_join_tpu_torch.config import EngineConfig, RadixConfig
from icde2019_gpu_join_tpu_torch.models import clustered_probe_join
from icde2019_gpu_join_tpu_torch.models import coprocess as cp
from icde2019_gpu_join_tpu_torch.relation import Relation
from icde2019_gpu_join_tpu_torch.utils import oracle as toracle
from icde2019_gpu_join_tpu_torch.utils import placement
from tests.conftest import make_tables


def _port_rels(rk, rp, sk, sp):
    return (Relation.from_numpy(rk, rp, device="cpu"),
            Relation.from_numpy(sk, sp, device="cpu"))


def _coprocess(rk, rp, sk, sp, **kw):
    """The port's co-processed aggregate, equal to JAX's and the host
    oracle's; returns the port's JoinResult."""
    got = cp.coprocess_join_aggregate(*_port_rels(rk, rp, sk, sp),
                                      EngineConfig(**kw), device="cpu")
    want = jax_coprocess(JaxRelation(rk, rp), JaxRelation(sk, sp),
                         jconfig.EngineConfig(**kw)).aggregate
    assert got.aggregate == want
    assert got.aggregate == tdatagen.host_oracle_aggregate(rk, rp, sk, sp)
    return got


def _full(rng, n):
    return rng.integers(-2**31, 2**31, n).astype(np.int64).astype(np.int32)


def test_coprocess_join(rng):
    rk, rp, sk, sp = make_tables(rng, n_r=5000, n_s=5000, dup_build=True)
    res = _coprocess(rk, rp, sk, sp, probe_tile_r=64, probe_tile_s=64)
    assert res.aggregate == toracle.join_aggregate(rk, rp, sk, sp)
    assert [p.name for p in res.timer.phases] == [
        "host_partition_R", "host_partition_S", "pairs"]


def _keys(rng, kind, n, dom):
    if kind == "unique":
        return rng.permutation(max(n, dom + 1))[:n].astype(np.int32)
    if kind == "dupes":
        return rng.integers(0, max(dom // 16, 1), n).astype(np.int32)
    if kind == "full31":
        return rng.integers(0, 2**31, n).astype(np.int64).astype(np.int32)
    raise AssertionError(kind)


@pytest.mark.parametrize("seed", range(3))
def test_coprocess_fuzz_vs_jax_and_host_oracle(seed):
    """Duplicate-heavy and full-domain keys, full-range payloads."""
    rng = np.random.default_rng(3000 + seed)
    n_r, n_s = 9_000, 13_000
    rkind, skind = [("dupes", "dupes"), ("full31", "unique"),
                    ("unique", "dupes")][seed]
    rk, sk = _keys(rng, rkind, n_r, 25_000), _keys(rng, skind, n_s, 25_000)
    _coprocess(rk, _full(rng, n_r), sk, _full(rng, n_s))


@pytest.mark.parametrize("n_r,n_s", [(3000, 0), (0, 3000), (0, 0), (1, 1),
                                     (17, 5000)])
def test_coprocess_edges_match_jax(n_r, n_s):
    rng = np.random.default_rng(n_r * 7 + n_s)
    rk = rng.integers(0, 300, n_r).astype(np.int32)
    sk = rng.integers(0, 600, n_s).astype(np.int32)
    res = _coprocess(rk, _full(rng, n_r), sk, _full(rng, n_s))
    if n_r == 0 or n_s == 0:
        assert res.aggregate == 0


def test_coprocess_schedule_with_empty_batches():
    """R keys in only 6 of the 16 outer partitions: the other 10 have gain 0
    and get a batch each with no pair, which the staging loop steps over."""
    rng = np.random.default_rng(8)
    parts = np.array([0, 3, 4, 9, 10, 15])
    rk = (rng.integers(0, 2000, 6000) * 16 + parts[rng.integers(0, 6, 6000)]
          ).astype(np.int32)
    sk = rng.integers(0, 32_000, 9000).astype(np.int32)
    rp, sp = _full(rng, rk.size), _full(rng, sk.size)
    _, _, cnt_r, off_r = tdatagen.host_partition(rk, rp, cp.OUTER_BITS)
    batch_of = cp.build_batches(cnt_r, rk.size)
    _, _, _, off_s = tdatagen.host_partition(sk, sp, cp.OUTER_BITS)
    schedule = cp.pair_schedule(batch_of, off_r, off_s)
    empty = set(range(batch_of.max() + 1)) - {b for b, _, _, _ in schedule}
    assert len(empty) == 10 and sorted(p for _, p, _, _ in schedule) == list(parts)
    _coprocess(rk, rp, sk, sp)


def test_coprocess_stages_ahead(rng, monkeypatch):
    """Batch 0's R uploads come first; then, before the first join, pair 0's
    S upload, batch 1's R uploads and pair 1's S upload."""
    log = []
    real_put = placement.Uploader.put
    real_join = cp.banded_join_aggregate
    monkeypatch.setattr(placement.Uploader, "put", lambda self, *t: log.append(
        "R" if len(t) > 2 else "S") or real_put(self, *t))
    monkeypatch.setattr(cp, "banded_join_aggregate", lambda *a, **k: log.append(
        "join") or real_join(*a, **k))
    rk, rp, sk, sp = make_tables(rng, n_r=4000, n_s=8000)
    _coprocess(rk, rp, sk, sp)
    assert log[:7] == ["R", "S", "R", "S", "join", "S", "join"]
    assert log.count("join") == 16 and log.count("R") >= 3


@pytest.mark.parametrize("impl", ["lax", "merge", "packed"])
def test_coprocess_sort_impls_match_jax(impl):
    rng = np.random.default_rng(21)
    rk = (rng.permutation(1 << 15)[:8192] + 1).astype(np.int32)
    sk = rk[rng.integers(0, 8192, 16384)]
    _coprocess(rk, _full(rng, rk.size), sk, _full(rng, sk.size),
               sort_impl=impl)


@pytest.mark.parametrize("first_bit,w", [(5, 1), (0, 2)])
def test_coprocess_radix_field_and_window(first_bit, w):
    rng = np.random.default_rng(first_bit + w)
    rk = rng.integers(0, 1 << 16, 7000).astype(np.int32)
    sk = rk[rng.integers(0, 7000, 11000)]
    _coprocess(rk, _full(rng, rk.size), sk, _full(rng, sk.size),
               radix=RadixConfig(first_bit=first_bit), band_window_blocks=w)


def test_dispatcher_routes_to_coprocess(rng):
    rk, rp, sk, sp = make_tables(rng, n_r=3000, n_s=2000, dup_build=True)
    cfg = EngineConfig(resident_limit_rows=2500)
    res = clustered_probe_join(*_port_rels(rk, rp, sk, sp), cfg, device="cpu")
    want = jjoins.clustered_probe_join(
        JaxRelation(jnp.asarray(rk), jnp.asarray(rp)), JaxRelation(sk, sp),
        jconfig.EngineConfig(resident_limit_rows=2500))
    assert res.aggregate == want.aggregate
    assert "pairs" in [p.name for p in res.timer.phases]
    res = clustered_probe_join(*_port_rels(rk, rp, sk, sp),
                               EngineConfig(build_placement="pinned_host"),
                               device="cpu")
    assert res.aggregate == want.aggregate
    assert "pairs" in [p.name for p in res.timer.phases]


def test_host_partition_pinned_on_the_cpu_is_pageable():
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 1 << 20, 5000).astype(np.int32)
    pays = _full(rng, 5000)
    k, p, counts, offsets = cp.host_partition_pinned(keys, pays, 0, "cpu")
    assert isinstance(k, torch.Tensor) and not k.is_pinned()
    for g, w in zip((k.numpy(), p.numpy(), counts, offsets),
                    jdatagen.host_partition(keys, pays, cp.OUTER_BITS, 0)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("lg", [12, 14])
def test_overlap_coprocess_leg(lg):
    rng = np.random.RandomState(lg)
    rk, rp, sk, sp = make_tables(rng, n_r=1 << lg, n_s=1 << lg, dup_build=True)
    line = overlap_bench.coprocess_leg(rk, rp, sk, sp, device="cpu")
    assert line["correct"] is True and line["device"] == "cpu"
    assert line["pairs"] == 16 and line["batches"] >= 4   # 16 parts, 5 a batch
    assert line["aggregate"] == jdatagen.host_oracle_aggregate(rk, rp, sk, sp)
    for key in ("t_transfer_s", "t_compute_s", "t_pipeline_s",
                "t_host_partition_s", "lower_bound_ratio"):
        assert line[key] > 0
    assert 0.0 <= line["overlap_fraction"] <= 1.0


def test_overlap_main_coprocess(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TPU_JOIN_DATA_DIR", str(tmp_path))
    assert overlap_bench.main(["coprocess", "--log2-s", "12",
                               "--device", "cpu"]) == 0
    assert '"correct": true' in capsys.readouterr().out
