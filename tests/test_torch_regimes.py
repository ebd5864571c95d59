"""The port's streaming regime, size dispatcher, placement helpers and the
streaming overlap tool against the JAX package's on the same numpy inputs
(mirrors the streaming, dispatcher and placement tests of tests/test_joins.py
and tests/test_fuzz_engine.py). Every aggregate equals JAX's bit for bit, as
an int32, and the host oracle's. Co-processing: test_torch_regimes_coprocess.py."""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu import config as jconfig
from icde2019_gpu_join_tpu import datagen as jdatagen
from icde2019_gpu_join_tpu.models import joins as jjoins
from icde2019_gpu_join_tpu.models.streaming import (
    streaming_join_aggregate as jax_streaming)
from icde2019_gpu_join_tpu.relation import Relation as JaxRelation
from icde2019_gpu_join_tpu_torch import datagen as tdatagen
from icde2019_gpu_join_tpu_torch.benchmarks import overlap_bench
from icde2019_gpu_join_tpu_torch.config import EngineConfig
from icde2019_gpu_join_tpu_torch.models import (clustered_probe_join,
                                                dispatch_regime)
from icde2019_gpu_join_tpu_torch.models import streaming as st
from icde2019_gpu_join_tpu_torch.models.streaming import (
    streaming_join_aggregate)
from icde2019_gpu_join_tpu_torch.ops import _launches, merge
from icde2019_gpu_join_tpu_torch.relation import Relation
from icde2019_gpu_join_tpu_torch.utils import oracle as toracle
from icde2019_gpu_join_tpu_torch.utils import placement
from tests.conftest import make_tables

PLACEMENTS = ["hbm", "device", "host", "pinned_host", "unpinned_host"]


def _cfgs(**kw):
    """The same configuration in both packages (small probe tiles, as
    tests/test_joins.py runs the JAX engine)."""
    kw = dict(probe_tile_r=64, probe_tile_s=64, **kw)
    return EngineConfig(**kw), jconfig.EngineConfig(**kw)


def _port_rels(rk, rp, sk, sp):
    return (Relation.from_numpy(rk, rp, device="cpu"),
            Relation.from_numpy(sk, sp, device="cpu"))


def _jax_rels(rk, rp, sk, sp):
    """R on the device, S in host numpy, as the JAX tests stream it."""
    return JaxRelation(jnp.asarray(rk), jnp.asarray(rp)), JaxRelation(sk, sp)


def _stream(rk, rp, sk, sp, **kw):
    """The port's streamed aggregate, equal to JAX's and the host oracle's;
    returns the port's JoinResult."""
    cfg, jcfg = _cfgs(**kw)
    got = streaming_join_aggregate(*_port_rels(rk, rp, sk, sp), cfg,
                                   device="cpu")
    want = jax_streaming(*_jax_rels(rk, rp, sk, sp), jcfg).aggregate
    assert got.aggregate == want
    assert got.aggregate == tdatagen.host_oracle_aggregate(rk, rp, sk, sp)
    return got


def _full(rng, n):
    return rng.integers(-2**31, 2**31, n).astype(np.int64).astype(np.int32)


# ---- mirrors of tests/test_joins.py -----------------------------------------

def test_streaming_join(rng):
    rk, rp, sk, sp = make_tables(rng, n_r=2000, n_s=10000, dup_build=True)
    res = _stream(rk, rp, sk, sp, segment_rows=3000)
    assert res.aggregate == toracle.join_aggregate(rk, rp, sk, sp)
    assert [p.name for p in res.timer.phases] == ["build_sort", "stream"]


def test_streaming_uses_staging_copy(rng, monkeypatch):
    """Segment assembly goes through datagen.staging_copy (the threaded
    staging gather), keys and payloads once a segment."""
    calls = {"n": 0}
    real = tdatagen.staging_copy

    def counted(dst, src, num_threads=0):
        calls["n"] += 1
        real(dst, src, num_threads)

    monkeypatch.setattr(st.datagen, "staging_copy", counted)
    rk, rp, sk, sp = make_tables(rng, n_r=2000, n_s=10000, dup_build=True)
    _stream(rk, rp, sk, sp, segment_rows=3000)
    assert calls["n"] == 2 * 4


def test_dispatcher_routes_by_size(rng):
    rk, rp, sk, sp = make_tables(rng, n_r=1000, n_s=3000, dup_build=True)
    # a small resident limit forces the streaming path
    cfg, jcfg = _cfgs(resident_limit_rows=2000, segment_rows=1000)
    res = clustered_probe_join(*_port_rels(rk, rp, sk, sp), cfg, device="cpu")
    want = jjoins.clustered_probe_join(*_jax_rels(rk, rp, sk, sp), jcfg)
    assert res.aggregate == want.aggregate
    assert res.aggregate == toracle.join_aggregate(rk, rp, sk, sp)
    assert "stream" in [p.name for p in res.timer.phases]
    # both small: the in-memory path
    cfg, _ = _cfgs()
    res2 = clustered_probe_join(*_port_rels(rk, rp, sk, sp), cfg, device="cpu")
    assert res2.aggregate == res.aggregate
    assert [p.name for p in res2.timer.phases] == ["join"]


def test_placement_routes_to_streaming(rng):
    """probe_placement="host" routes through the streaming regime even when
    S fits in memory (the MEM_TYPE placement analog)."""
    rk, rp, sk, sp = make_tables(rng)
    cfg = EngineConfig(probe_placement="host", segment_rows=1024)
    jcfg = jconfig.EngineConfig(probe_placement="host", segment_rows=1024)
    res = clustered_probe_join(*_port_rels(rk, rp, sk, sp), cfg, device="cpu")
    want = jjoins.clustered_probe_join(*_jax_rels(rk, rp, sk, sp), jcfg)
    assert res.aggregate == want.aggregate
    assert res.aggregate == toracle.join_aggregate(rk, rp, sk, sp)
    assert any(p.name == "stream" for p in res.timer.phases)


def test_dispatcher_materialize(rng):
    """In memory, `materialize=True` takes ClusteredJoin.materialize; the
    streamed regimes return the aggregate and ignore it, as in JAX."""
    rk, rp, sk, sp = make_tables(rng, n_r=300, n_s=900, dup_build=True)
    res = clustered_probe_join(*_port_rels(rk, rp, sk, sp),
                               EngineConfig(out_capacity=4096),
                               materialize=True, device="cpu")
    assert res.count == toracle.join_count(rk, sk) and res.pairs is not None
    cfg, jcfg = _cfgs(resident_limit_rows=500)
    res = clustered_probe_join(*_port_rels(rk, rp, sk, sp), cfg,
                               materialize=True, device="cpu")
    want = jjoins.clustered_probe_join(*_jax_rels(rk, rp, sk, sp), jcfg,
                                       materialize=True)
    assert res.pairs is None and res.aggregate == want.aggregate


def test_placement_helpers():
    x = np.arange(256, dtype=np.int32)
    hbm = placement.place(x, "hbm", device="cpu")
    assert isinstance(hbm, torch.Tensor) and np.array_equal(hbm.numpy(), x)
    host = placement.place(x, "host", device="cpu")
    assert isinstance(host, np.ndarray) and np.array_equal(host, x)
    pinned = placement.place(x, "pinned_host", device="cpu")  # no card: pageable
    assert np.array_equal(pinned.numpy(), x) and not pinned.is_pinned()
    rel = placement.place_relation(Relation.from_numpy(x, device="cpu"), "hbm",
                                   device="cpu")
    assert rel.num_rows == 256
    rel = placement.place_relation(rel, "host", device="cpu")
    assert rel.device.type == "cpu"
    assert np.array_equal(rel.payload.numpy(), x)
    assert np.array_equal(placement.place(torch.from_numpy(x), "host"), x)
    with pytest.raises(ValueError, match="unknown placement policy"):
        placement.place(x, "l2", device="cpu")


@pytest.mark.parametrize("policy,device,want", [
    ("hbm", "cuda", ("cuda", False)), ("device", "cpu", ("cpu", False)),
    ("pinned_host", "cuda", ("cpu", True)),
    ("pinned_host", "cpu", ("cpu", False)),
    ("unpinned_host", "cuda", ("cpu", False)),
])
def test_placement_sharding_says_what_place_does(policy, device, want):
    got = placement.placement_sharding(policy, device)
    assert (got.device.type, got.pinned) == want
    if device == "cpu":
        t = placement.place(np.arange(5, dtype=np.int32), policy, device)
        assert t.device == got.device and t.is_pinned() == got.pinned


@pytest.mark.parametrize("policy", ["host", "vmem", ""])
def test_placement_sharding_rejects_non_tensor_policies(policy):
    """As JAX's `placement_sharding`: "host" has no device placement."""
    with pytest.raises(ValueError, match="unknown placement policy"):
        placement.placement_sharding(policy)


def test_a_failed_pin_raises():
    """With the card as the device, "pinned_host" pins or raises; it never
    falls back to pageable memory (this torch has no card to pin for)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: pinning succeeds")
    with pytest.raises(RuntimeError, match="pin"):
        placement.place(np.arange(8, dtype=np.int32), "pinned_host")
    with pytest.raises(RuntimeError, match="pin"):
        placement.pinned_empty(8)


def test_the_regimes_need_the_card_by_default(rng):
    """Without `device="cpu"` the streamed regime goes to the card, and with
    no card it raises rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rk, rp, sk, sp = make_tables(rng, n_r=100, n_s=300)
    with pytest.raises((AssertionError, RuntimeError)):
        streaming_join_aggregate(*_port_rels(rk, rp, sk, sp))
    with pytest.raises((AssertionError, RuntimeError)):
        clustered_probe_join(*_port_rels(rk, rp, sk, sp),
                             EngineConfig(resident_limit_rows=10))


# ---- the size dispatcher ----------------------------------------------------

@pytest.mark.parametrize("build,probe", itertools.product(PLACEMENTS,
                                                          PLACEMENTS))
def test_dispatch_regime_matches_jax(build, probe):
    sizes = (0, 1, 999, 1000, 1001, 1 << 27, 128_000_001, 1 << 29)
    for limit in (1, 1000, 1 << 27, 128_000_001):
        kw = dict(resident_limit_rows=limit, build_placement=build,
                  probe_placement=probe)
        cfg, jcfg = EngineConfig(**kw), jconfig.EngineConfig(**kw)
        for n_r, n_s in itertools.product(sizes, sizes):
            assert (dispatch_regime(n_r, n_s, cfg)
                    == jjoins.dispatch_regime(n_r, n_s, jcfg)), (n_r, n_s, kw)


def test_dispatch_regime_at_the_headline():
    """2^27 rows a side already exceed the default limit (128,000,001):
    co-processing; streaming through the dispatcher needs the limit raised
    to 2^27."""
    assert dispatch_regime(1 << 27, 1 << 27) == "coprocess"
    assert dispatch_regime(1 << 27, 1 << 29,
                           EngineConfig(resident_limit_rows=1 << 27)) == "streaming"
    assert dispatch_regime(1 << 24, 1 << 24) == "join1"


# ---- the streaming regime: fuzz and edges ------------------------------------

def _keys(rng, kind, n, dom):
    """tests/test_fuzz_engine.py's key generators (keys >= 0)."""
    if kind == "unique":
        return rng.permutation(max(n, dom + 1))[:n].astype(np.int32)
    if kind == "dupes":
        return rng.integers(0, max(dom // 16, 1), n).astype(np.int32)
    if kind == "full31":
        return rng.integers(0, 2**31, n).astype(np.int64).astype(np.int32)
    if kind == "one_key":
        return np.full(n, 42, np.int32)
    raise AssertionError(kind)


@pytest.mark.parametrize("seed", range(4))
def test_streaming_fuzz_vs_jax_and_host_oracle(seed):
    """A segment size that does not divide n_s, duplicate-heavy and
    full-domain keys, full-range payloads."""
    rng = np.random.default_rng(2000 + seed)
    n_r, n_s = 6_000, 19_001
    rkind, skind = [("unique", "dupes"), ("dupes", "dupes"),
                    ("full31", "full31"), ("unique", "one_key")][seed]
    rk, sk = _keys(rng, rkind, n_r, 30_000), _keys(rng, skind, n_s, 30_000)
    _stream(rk, _full(rng, n_r), sk, _full(rng, n_s), segment_rows=4_096)


@pytest.mark.parametrize("n_r,n_s,seg", [
    (3000, 10_001, 4096),   # a ragged tail of 1809 rows, padded in place
    (3000, 2500, 4096),     # S shorter than one segment
    (3000, 0, None),        # an empty S: 0
    (0, 5000, 2048),        # an empty R: 0
    (1, 1, None),           # one row a side
    (3000, 12_288, None),   # the default: ceil(n_s / 4) rows, 4 segments
])
def test_streaming_edges_match_jax(n_r, n_s, seg):
    rng = np.random.default_rng(n_r + n_s)
    rk = rng.integers(0, 2000, n_r).astype(np.int32)
    sk = rng.integers(0, 4000, n_s).astype(np.int32)
    res = _stream(rk, _full(rng, n_r), sk, _full(rng, n_s), segment_rows=seg)
    if n_r == 0 or n_s == 0:
        assert res.aggregate == 0


def test_streaming_segment_rows_default():
    cfg = EngineConfig()
    assert st.segment_rows_for(0, cfg) == 1
    assert st.segment_rows_for(10_001, cfg) == 2501
    assert st.segment_rows_for(1 << 29, cfg) == 1 << 27
    assert st.segment_rows_for(3 << 29, cfg) == 1 << 27
    assert st.segment_rows_for(5, EngineConfig(segment_rows=3)) == 3


def test_streaming_distinct_segments(monkeypatch):
    """Five segments of disjoint keys and payloads that differ by segment,
    so a segment probed twice, skipped or overwritten by a later one changes
    the sum; each slot is staged three times."""
    seg, nseg = 1024, 5
    rng = np.random.default_rng(5)
    rk = np.arange(nseg * 300, dtype=np.int32)
    rp = _full(rng, rk.size)
    sk = np.concatenate([rng.integers(300 * i, 300 * (i + 1), seg)
                         for i in range(nseg)]).astype(np.int32)
    sp = np.repeat(np.arange(1, nseg + 1, dtype=np.int32) * 7919, seg)
    staged = []
    real = placement.Uploader.put
    monkeypatch.setattr(placement.Uploader, "put",
                        lambda self, *t: staged.append(t[0].clone())
                        or real(self, *t))
    _stream(rk, rp, sk, sp, segment_rows=seg)
    assert len(staged) == nseg
    for i, keys in enumerate(staged):
        assert torch.equal(keys, torch.from_numpy(sk[i * seg:(i + 1) * seg]))


def test_uploader_copies_on_the_cpu():
    """`Tensor.to("cpu")` would return the staging buffer itself; the
    uploader's CPU path copies, so restaging a slot leaves what was sent."""
    up = placement.Uploader("cpu")
    slot = torch.arange(10, dtype=torch.int32)
    (sent,), event = up.put(slot)
    assert event is None
    slot.fill_(-1)
    assert torch.equal(sent, torch.arange(10, dtype=torch.int32))
    up.wait(event)


@pytest.mark.parametrize("impl", ["lax", "merge", "packed"])
def test_streaming_sort_impls_match_jax(impl):
    """Power-of-two segments of keys >= 1: under "merge" the R sort and both
    segment sorts take the cascade."""
    rng = np.random.RandomState(99)
    rk = (rng.permutation(4 * 8192 - 1)[:8192] + 1).astype(np.int32)
    sk = rk[rng.randint(0, 8192, 16384)].astype(np.int32)
    rp = rng.randint(-2**31, 2**31, 8192, dtype=np.int64).astype(np.int32)
    sp = rng.randint(-2**31, 2**31, 16384, dtype=np.int64).astype(np.int32)
    _launches.reset()
    _stream(rk, rp, sk, sp, segment_rows=8192, sort_impl=impl)
    want = {"cascade": 3 if impl == "merge" else 0, "fallback": 0}
    assert merge.ROUTES == want


def test_streaming_reads_back_a_relation_given_as_numpy_views(rng):
    """S given by a relation over numpy memory is read in place (no copy of
    S before staging) and left unchanged."""
    rk, rp, sk, sp = make_tables(rng, n_r=500, n_s=3000)
    sk0, sp0 = sk.copy(), sp.copy()
    _stream(rk, rp, sk, sp, segment_rows=700)
    assert np.array_equal(sk, sk0) and np.array_equal(sp, sp0)
    assert np.shares_memory(placement.host_numpy(torch.from_numpy(sk)), sk)


# ---- the overlap tool ---------------------------------------------------------

@pytest.mark.parametrize("lg_r,lg_s,segments", [(12, 14, 4), (12, 13, 3)])
def test_overlap_streaming_leg(lg_r, lg_s, segments):
    rng = np.random.RandomState(lg_s)
    rk, rp, sk, sp = make_tables(rng, n_r=1 << lg_r, n_s=1 << lg_s,
                                 dup_build=True)
    line = overlap_bench.streaming_leg(rk, rp, sk, sp, segments, device="cpu")
    assert line["correct"] is True and line["device"] == "cpu"
    assert line["segments"] == segments
    assert line["aggregate"] == jdatagen.host_oracle_aggregate(rk, rp, sk, sp)
    for key in ("t_staging_s", "t_transfer_s", "t_compute_s", "t_pipeline_s"):
        assert line[key] > 0
    assert 0.0 <= line["overlap_fraction"] <= 1.0


def test_overlap_main_streaming(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TPU_JOIN_DATA_DIR", str(tmp_path))
    assert overlap_bench.main(["streaming", "--log2-r", "10", "--log2-s", "12",
                               "--segments", "3", "--device", "cpu"]) == 0
    assert '"correct": true' in capsys.readouterr().out


def test_config_carries_regime_fields_from_jax():
    jcfg = jconfig.EngineConfig(segment_rows=3 << 25, build_placement="host",
                                probe_placement="pinned_host",
                                resident_limit_rows=1 << 27)
    cfg = EngineConfig.from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dispatch_regime(1 << 20, 1 << 20, cfg) == "coprocess"
    from icde2019_gpu_join_tpu_torch import config as tconfig
    for name in ("CHUNK_SIZE", "REF_BUCKET_SIZE", "REF_CHAIN_THRESHOLD"):
        assert getattr(tconfig, name) == getattr(jconfig, name)
