"""The port's ClusteredJoin, config, datagen and datasets against the JAX
package's, and the rule that the port never imports JAX."""

import dataclasses
import inspect
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu import config as jconfig
from icde2019_gpu_join_tpu import datagen as jdatagen
from icde2019_gpu_join_tpu.models import ClusteredJoin as JaxJoin
from icde2019_gpu_join_tpu.relation import Relation as JaxRelation
from icde2019_gpu_join_tpu.utils import datasets as jdatasets
from icde2019_gpu_join_tpu.utils import oracle
from icde2019_gpu_join_tpu_torch import datagen as tdatagen
from icde2019_gpu_join_tpu_torch.config import EngineConfig, RadixConfig
from icde2019_gpu_join_tpu_torch.benchmarks import overlap_bench
from icde2019_gpu_join_tpu_torch.models import ClusteredJoin, clustered_probe_join
from icde2019_gpu_join_tpu_torch.models import coprocess, streaming
from icde2019_gpu_join_tpu_torch.ops import bits as tbits, probe as tprobe
from icde2019_gpu_join_tpu_torch.parallel import dryrun, mesh as tmesh
from icde2019_gpu_join_tpu_torch.relation import PartitionedRelation, Relation
from icde2019_gpu_join_tpu_torch.utils import datasets as tdatasets
from icde2019_gpu_join_tpu_torch.utils import oracle as toracle
from icde2019_gpu_join_tpu_torch.utils import placement, profiling, timing
from icde2019_gpu_join_tpu_torch import cli as tcli, entry as tentry
from icde2019_gpu_join_tpu_torch.benchmarks import bench as tbench
from icde2019_gpu_join_tpu_torch.benchmarks import run_configs
from tests.conftest import make_tables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rels(rk, rp, sk, sp):
    port = (Relation.from_numpy(rk, rp, device="cpu"),
            Relation.from_numpy(sk, sp, device="cpu"))
    jax = (JaxRelation(jnp.asarray(rk), jnp.asarray(rp)),
           JaxRelation(jnp.asarray(sk), jnp.asarray(sp)))
    return port, jax


@pytest.mark.parametrize("n_r,n_s,dup", [
    (1 << 10, 1 << 12, False), (1 << 12, 1 << 12, True), (1 << 14, 1 << 16, False),
])
def test_aggregate_and_count_match_jax(rng, n_r, n_s, dup):
    rk, rp, sk, sp = make_tables(rng, n_r=n_r, n_s=n_s, dup_build=dup)
    (tr, ts), (jr, js) = _rels(rk, rp, sk, sp)
    res = ClusteredJoin(device="cpu").aggregate(tr, ts)
    assert res.aggregate == JaxJoin().aggregate(jr, js).aggregate
    assert res.aggregate == toracle.join_aggregate(rk, rp, sk, sp)
    assert res.timer.seconds("join") > 0
    cnt = ClusteredJoin(device="cpu").count(tr, ts).count
    assert cnt == JaxJoin().count(jr, js).count == toracle.join_count(rk, sk)


@pytest.mark.parametrize("w", [2, 4])
def test_window_blocks_from_config(rng, w):
    rk, rp, sk, sp = make_tables(rng, dup_build=True)
    (tr, ts), (jr, js) = _rels(rk, rp, sk, sp)
    got = ClusteredJoin(EngineConfig(band_window_blocks=w),
                        device="cpu").aggregate(tr, ts)
    want = JaxJoin(jconfig.EngineConfig(band_window_blocks=w)).aggregate(jr, js)
    assert got.aggregate == want.aggregate


def test_engine_config_from_jax_dict():
    jcfg = jconfig.EngineConfig(
        radix=jconfig.RadixConfig(total_bits=9, first_bit=2),
        band_window_blocks=2, probe_tile_s=512)
    for jc in (jconfig.EngineConfig(), jcfg):
        port = EngineConfig.from_dict(dataclasses.asdict(jc))
        assert isinstance(port.radix, RadixConfig)
        assert dataclasses.asdict(port) == dataclasses.asdict(jc)
        assert port.radix.pass_plan() == jc.radix.pass_plan()


def test_default_bits_match_jax():
    from icde2019_gpu_join_tpu_torch.config import default_bits_for
    for n in (0, 1, 255, 4096, 1 << 20, 1 << 31):
        assert default_bits_for(n) == jconfig.default_bits_for(n)


def test_unported_modes_raise():
    with pytest.raises(ValueError, match="unknown probe_mode 'hash'"):
        ClusteredJoin(EngineConfig(probe_mode="hash"), device="cpu")
    with pytest.raises(ValueError, match="unknown sort_impl 'bitonic'"):
        ClusteredJoin(EngineConfig(sort_impl="bitonic"), device="cpu")


@pytest.mark.parametrize("entry", [
    ClusteredJoin.__init__, Relation.from_numpy, PartitionedRelation.from_numpy,
    tprobe.ProbePlan.as_device, tbits.partition_boundaries,
    streaming.streaming_join_aggregate, coprocess.coprocess_join_aggregate,
    coprocess.host_partition_pinned, clustered_probe_join, placement.place,
    placement.place_relation, placement.placement_sharding,
    placement.pinned_empty, placement.Uploader.__init__,
    overlap_bench.streaming_leg, overlap_bench.coprocess_leg,
    tmesh.make_mesh, tmesh.make_mesh_2d, tmesh.Mesh.__init__,
    dryrun.dryrun_multichip, tcli.main, tentry.entry, tbench.run,
    run_configs.config1, run_configs.config2, run_configs.config3,
    run_configs.config4, run_configs.config5, run_configs.config6,
    profiling.trace, profiling.maybe_trace, profiling.annotate],
    ids=lambda f: f.__qualname__)
def test_the_card_is_the_default_device(entry):
    """The port's entry points run on the card unless the caller asks for
    the CPU (as every test here does); without a card the default raises,
    as torch does."""
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_benchmark_tools_default_to_the_card():
    from icde2019_gpu_join_tpu_torch.benchmarks import (
        construct_probes, merge_fix_validate, merge_sort_bench)
    for fn in (merge_sort_bench.bench_stages, merge_sort_bench.bench_packed,
               merge_sort_bench.bench_full, merge_fix_validate.validate,
               construct_probes.run_probes):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_relation_device_must_match_engine():
    r = Relation(torch.zeros(4, dtype=torch.int32), device="meta")
    with pytest.raises(ValueError, match="meta"):
        ClusteredJoin(device="cpu").aggregate(r, r)


def test_relation_rejects_non_int32():
    with pytest.raises(ValueError):
        Relation(torch.zeros(4, dtype=torch.int64))


@pytest.mark.parametrize("device", [None, "meta"])
def test_relation_default_payload_is_row_ids_on_its_device(device):
    keys = torch.arange(300, 0, -1, dtype=torch.int32)
    rel = Relation(keys, device=device)
    assert rel.payload.device == rel.keys.device == torch.device(device or "cpu")
    assert rel.payload.dtype == torch.int32 and rel.payload.shape == (300,)
    if device is None:
        assert torch.equal(rel.payload, torch.arange(300, dtype=torch.int32))
    rel = Relation.from_numpy(np.zeros(5, np.int32), device="cpu")
    assert torch.equal(rel.payload, torch.arange(5, dtype=torch.int32))


@pytest.mark.parametrize("n_r,n_s,dup,w", [
    (1 << 12, 1 << 12, False, 1), (1 << 11, 1 << 13, True, 2),
])
def test_materialize_matches_jax(rng, n_r, n_s, dup, w):
    rk, _, sk, _ = make_tables(rng, n_r=n_r, n_s=n_s, dup_build=dup)
    rp = rng.randint(1, 1000, n_r).astype(np.int32)
    sp = rng.randint(1, 1000, n_s).astype(np.int32)
    (tr, ts), (jr, js) = _rels(rk, rp, sk, sp)
    total = toracle.join_count(rk, sk)
    cap = total + 300
    res = ClusteredJoin(EngineConfig(band_window_blocks=w), device="cpu").materialize(
        tr, ts, capacity=cap)
    want = JaxJoin(jconfig.EngineConfig(band_window_blocks=w)).materialize(
        jr, js, capacity=cap)
    assert res.count == want.count == total
    assert res.timer.seconds("join") > 0

    def multiset(out_r, out_s):
        pairs = np.stack([np.asarray(out_r), np.asarray(out_s)], axis=1)
        pairs = pairs[(pairs[:, 0] != 0) | (pairs[:, 1] != 0)]
        return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]

    got = multiset(*res.pairs)
    np.testing.assert_array_equal(got, multiset(*want.pairs))
    np.testing.assert_array_equal(got, toracle.join_materialize(rk, rp, sk, sp))


def test_materialize_default_capacity_is_out_capacity(rng):
    rk, rp, sk, sp = make_tables(rng, n_r=500, n_s=900)
    tr, ts = (Relation.from_numpy(rk, rp, device="cpu"),
              Relation.from_numpy(sk, sp, device="cpu"))
    res = ClusteredJoin(EngineConfig(out_capacity=1 << 10),
                        device="cpu").materialize(tr, ts)
    assert res.pairs[0].shape == res.pairs[1].shape == (1 << 10,)
    assert res.count == toracle.join_count(rk, sk)


@pytest.mark.parametrize("c1,c2,dup", [(4, 2, False), (3, 0, True), (0, 0, False)])
def test_late_aggregate_matches_jax(rng, c1, c2, dup):
    rk, _, sk, _ = make_tables(rng, n_r=1 << 11, n_s=1 << 12, dup_build=dup)
    r_cols = rng.randint(-2**31, 2**31, (rk.size, c1), dtype=np.int64).astype(np.int32)
    s_cols = rng.randint(-2**31, 2**31, (sk.size, c2), dtype=np.int64).astype(np.int32)
    r_ids = np.arange(rk.size, dtype=np.int32)
    s_ids = rng.permutation(sk.size).astype(np.int32)   # payloads are row ids
    tr = Relation.from_numpy(rk, device="cpu")
    ts = Relation.from_numpy(sk, s_ids, device="cpu")
    got = ClusteredJoin(device="cpu").late_aggregate(
        tr, ts, torch.from_numpy(r_cols), torch.from_numpy(s_cols))
    want = JaxJoin().late_aggregate(
        JaxRelation(jnp.asarray(rk), jnp.asarray(r_ids)),
        JaxRelation(jnp.asarray(sk), jnp.asarray(s_ids)),
        jnp.asarray(r_cols), jnp.asarray(s_cols))
    assert got.aggregate == want.aggregate == toracle.join_late_materialize_sum(
        rk, r_ids, sk, s_ids, r_cols, s_cols)


def test_late_aggregate_clamps_row_ids_like_jax():
    rk = np.arange(6, dtype=np.int32)
    sk = np.array([0, 1, 2, 5, 5, 9], np.int32)
    r_ids = np.array([0, -1, 7, -9, 2, 5], np.int32)   # out of range, negative
    s_ids = np.array([3, 20, -2, 0, 1, 4], np.int32)
    r_cols = np.arange(12, dtype=np.int32).reshape(6, 2) * 1000
    s_cols = np.arange(6, dtype=np.int32)[:, None] + 1
    got = ClusteredJoin(device="cpu").late_aggregate(
        Relation.from_numpy(rk, r_ids, device="cpu"),
        Relation.from_numpy(sk, s_ids, device="cpu"),
        torch.from_numpy(r_cols), torch.from_numpy(s_cols))
    want = JaxJoin().late_aggregate(
        JaxRelation(jnp.asarray(rk), jnp.asarray(r_ids)),
        JaxRelation(jnp.asarray(sk), jnp.asarray(s_ids)),
        jnp.asarray(r_cols), jnp.asarray(s_cols))
    assert got.aggregate == want.aggregate


def test_late_aggregate_columns_must_be_on_the_engine_device():
    r = Relation(torch.zeros(4, dtype=torch.int32))
    cols = torch.zeros((4, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="r_cols is on meta"):
        ClusteredJoin(device="cpu").late_aggregate(r, r, cols.to("meta"), cols)


def test_make_pk_fk_byte_identical(tmp_path, monkeypatch):
    assert tdatagen.native_lib() is not None and jdatagen.native_lib() is not None
    monkeypatch.setenv("TPU_JOIN_DATA_DIR", str(tmp_path / "jax"))
    j_r, j_s = jdatasets.make_pk_fk(1000, 4000)
    monkeypatch.setenv("TPU_JOIN_DATA_DIR", str(tmp_path / "port"))
    t_r, t_s = tdatasets.make_pk_fk(1000, 4000)
    assert t_r.tobytes() == j_r.tobytes() and t_s.tobytes() == j_s.tobytes()
    for name in os.listdir(tmp_path / "jax"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    monkeypatch.setenv("TPU_JOIN_DATA_DIR", str(tmp_path / "zipf"))
    assert np.array_equal(tdatasets.make_pk_fk(1000, 4000, skew=1.05)[1],
                          jdatagen.gen_zipf(4000, 1000, 1.05, 12345))


@pytest.mark.parametrize("gen,args", [
    ("random_gen", (5000, 700, 3)),
    ("random_unique_gen", (5000, 1200, 4)),
    ("gen_zipf", (5000, 300, 0.8, 5)),
])
def test_generators_byte_identical(gen, args):
    assert getattr(tdatagen, gen)(*args).tobytes() == \
        getattr(jdatagen, gen)(*args).tobytes()


def test_fk_from_pk_byte_identical():
    pk = jdatagen.random_unique_gen(700, 700, 9)
    assert tdatagen.fk_from_pk(3000, pk, 9).tobytes() == \
        jdatagen.fk_from_pk(3000, pk, 9).tobytes()


@pytest.mark.parametrize("name,args", [
    ("nonunique_filename", ("R", 123)), ("nonunique_filename", ("S", 9)),
    ("pk_filename", (77,)), ("fk_filename", (300, 77)),
    ("unique_filename", (5,)), ("zipf_filename", (40, 1.05))])
def test_dataset_file_names_equal_jax(tmp_path, monkeypatch, name, args):
    monkeypatch.setenv("TPU_JOIN_DATA_DIR", str(tmp_path))
    assert getattr(tdatasets, name)(*args) == getattr(jdatasets, name)(*args)


def test_dataset_helpers_byte_identical(tmp_path, monkeypatch):
    """create_relation_nonunique, create_relation_fk_from_pk (full-range PK
    keys, as --full-range draws them) and create_relation_n write and
    return what the JAX package's do."""
    out = {}
    for pkg, mod in (("jax", jdatasets), ("port", tdatasets)):
        monkeypatch.setenv("TPU_JOIN_DATA_DIR", str(tmp_path / pkg))
        pk = mod.create_relation_nonunique(mod.pk_filename(900), 900,
                                           2**31 - 1, 5)
        fk = mod.create_relation_fk_from_pk(4000, pk, 5)
        nu = mod.create_relation_nonunique(mod.nonunique_filename("S", 700),
                                           700, 350, 5)
        out[pkg] = (pk, fk, nu, mod.create_relation_n(nu, 3))
    for a, b in zip(out["port"], out["jax"]):
        assert a.dtype == b.dtype == np.int32 and a.tobytes() == b.tobytes()
    assert out["port"][0].max() > 2**30 and out["port"][3].size == 2100
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a card: lets the timer's device choice be
    seen without one."""
    index = 0

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", self.index)


def _on_card(index):
    t = torch.zeros(1).as_subclass(_OnCard)
    t.index = index
    return t


@pytest.mark.parametrize("result,want", [
    (None, None), (3, None), (torch.zeros(2), None),
    ((torch.zeros(2), torch.ones(1, device="meta")), None),
    ([torch.zeros(1), "x"], None),
    ("card1", torch.device("cuda", 1)),
    ("cpu_card1_card0", torch.device("cuda", 1))])
def test_timer_syncs_the_device_of_the_first_cuda_tensor(monkeypatch, result,
                                                         want):
    if result == "card1":
        result = _on_card(1)
    elif result == "cpu_card1_card0":
        result = (torch.zeros(1), _on_card(1), _on_card(0))
    assert timing.cuda_device_of(result) == want
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    timer = timing.PhaseTimer()
    with timer.phase("p") as out:
        out["result"] = result
    assert synced == ([] if want is None else [want])
    assert timer.seconds("p") >= 0


def test_cpp_oracle_matches_jax(rng):
    rk, rp, sk, sp = make_tables(rng, n_r=3000, n_s=12000, dup_build=True)
    got = tdatagen.oracle_join_aggregate(rk, rp, sk, sp)
    assert got == jdatagen.oracle_join_aggregate(rk, rp, sk, sp)
    assert got == tdatagen.host_oracle_aggregate(rk, rp, sk, sp)
    assert got == toracle.join_aggregate(rk, rp, sk, sp) == \
        oracle.join_aggregate(rk, rp, sk, sp)


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import icde2019_gpu_join_tpu_torch\n"
        "import icde2019_gpu_join_tpu_torch.models.joins\n"
        "import icde2019_gpu_join_tpu_torch.ops.band_join\n"
        "import icde2019_gpu_join_tpu_torch.ops.filter\n"
        "import icde2019_gpu_join_tpu_torch.models.pipelines\n"
        "import icde2019_gpu_join_tpu_torch.models.streaming\n"
        "import icde2019_gpu_join_tpu_torch.models.coprocess\n"
        "import icde2019_gpu_join_tpu_torch.utils.placement\n"
        "import icde2019_gpu_join_tpu_torch.ops.band_compare\n"
        "import icde2019_gpu_join_tpu_torch.ops.partition\n"
        "import icde2019_gpu_join_tpu_torch.ops.sort\n"
        "import icde2019_gpu_join_tpu_torch.ops.probe\n"
        "import icde2019_gpu_join_tpu_torch.ops.probe_ranges\n"
        "import icde2019_gpu_join_tpu_torch.ops.join_sorted\n"
        "import icde2019_gpu_join_tpu_torch.ops.perfect_hash\n"
        "import icde2019_gpu_join_tpu_torch.ops.merge\n"
        "import icde2019_gpu_join_tpu_torch.ops._build\n"
        "import icde2019_gpu_join_tpu_torch.ops._launches\n"
        "import icde2019_gpu_join_tpu_torch.datagen\n"
        "import icde2019_gpu_join_tpu_torch.utils.datasets\n"
        "import icde2019_gpu_join_tpu_torch.utils.oracle\n"
        "import icde2019_gpu_join_tpu_torch.utils.timing\n"
        "import icde2019_gpu_join_tpu_torch.ops.partition_radix\n"
        "import icde2019_gpu_join_tpu_torch.ops as O, pkgutil, importlib\n"
        "names = [m.name for m in pkgutil.iter_modules(O.__path__)]\n"
        "assert {'groupby', 'scan'} <= set(names), names\n"
        "for name in names:\n"
        "    importlib.import_module(O.__name__ + '.' + name)\n"
        "import icde2019_gpu_join_tpu_torch.ops._build as BLD\n"
        "assert not BLD._loaded, 'importing ops built a library'\n"
        "import icde2019_gpu_join_tpu_torch.utils as U\n"
        "names = [m.name for m in pkgutil.iter_modules(U.__path__)]\n"
        "assert sorted(names) == ['datasets', 'debug', 'oracle', "
        "'placement', 'profiling', 'timing'], names\n"
        "for name in names:\n"
        "    importlib.import_module(U.__name__ + '.' + name)\n"
        "import icde2019_gpu_join_tpu_torch.cli\n"
        "import icde2019_gpu_join_tpu_torch.entry\n"
        "import icde2019_gpu_join_tpu_torch.parallel as P, pkgutil, importlib\n"
        "names = [m.name for m in pkgutil.iter_modules(P.__path__)]\n"
        "assert sorted(names) == ['comm', 'dist_join', 'dryrun', 'exchange', "
        "'mesh', 'plan'], names\n"
        "for name in names:\n"
        "    importlib.import_module(P.__name__ + '.' + name)\n"
        "import icde2019_gpu_join_tpu_torch.benchmarks as B, pkgutil, importlib\n"
        "names = [m.name for m in pkgutil.iter_modules(B.__path__)]\n"
        "assert sorted(names) == ['bench', 'construct_probes', 'dist_bench', "
        "'experimental_sort', 'merge_fix_validate', 'merge_sort_bench', "
        "'overlap_bench', 'precache_oracles', 'run_configs'], names\n"
        "for name in names:\n"
        "    importlib.import_module(B.__name__ + '.' + name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'icde2019_gpu_join_tpu', 'benchmarks'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


# ---- the radix-partitioned modes ------------------------------------------

PARTITIONED = ["pallas", "blocked", "sort_merge", "perfect"]


def _small(mode, **kw):
    """Small probe tiles, as tests/test_joins.py runs the JAX engine."""
    return (EngineConfig(probe_mode=mode, probe_tile_r=64, probe_tile_s=64,
                         **kw),
            jconfig.EngineConfig(probe_mode=mode, probe_tile_r=64,
                                 probe_tile_s=64, **kw))


def _skewed_tables(rng, n_r=1000, n_s=6000):
    rk = rng.permutation(4000)[:n_r].astype(np.int32)
    sk = rk[np.minimum(rng.zipf(1.3, n_s) - 1, n_r - 1)].astype(np.int32)
    rp = rng.randint(-2**31, 2**31, n_r, dtype=np.int64).astype(np.int32)
    sp = rng.randint(-2**31, 2**31, n_s, dtype=np.int64).astype(np.int32)
    return rk, rp, sk, sp


def _mode_tables(rng, kind):
    if kind == "skew":
        return _skewed_tables(rng)
    return make_tables(rng, n_r=2000, n_s=6000, dup_build=kind == "dup")


def test_with_bits_matches_jax():
    for bits in (4, 13, 18):
        port = EngineConfig(probe_tile_s=512).with_bits(bits)
        jax_ = jconfig.EngineConfig(probe_tile_s=512).with_bits(bits)
        assert dataclasses.asdict(port) == dataclasses.asdict(jax_)
        assert port.radix.total_bits == bits


@pytest.mark.parametrize("mode", ["auto", "banded", *PARTITIONED])
@pytest.mark.parametrize("n", [100, 5000, 1 << 20])
def test_radix_bits_per_mode_match_jax(mode, n):
    cfg, jcfg = _small(mode)
    assert (ClusteredJoin(cfg, device="cpu")._bits(n, 3 * n)
            == JaxJoin(jcfg)._bits(n, 3 * n))


@pytest.mark.parametrize("mode", PARTITIONED)
@pytest.mark.parametrize("kind", ["pkfk", "dup", "skew"])
def test_partitioned_aggregate_and_count(rng, mode, kind):
    """Every mode against the oracle; against the JAX engine where it runs
    on the CPU (its "pallas" aggregate runs the Pallas kernel, which needs
    interpret mode there: tests/test_torch_probe_ranges.py holds the kernel
    against it)."""
    rk, rp, sk, sp = _mode_tables(rng, kind)
    (tr, ts), (jr, js) = _rels(rk, rp, sk, sp)
    cfg, jcfg = _small(mode)
    got = ClusteredJoin(cfg, device="cpu").aggregate(tr, ts)
    assert got.aggregate == toracle.join_aggregate(rk, rp, sk, sp)
    if mode != "pallas":
        assert got.aggregate == JaxJoin(jcfg).aggregate(jr, js).aggregate
    cnt = ClusteredJoin(cfg, device="cpu").count(tr, ts).count
    assert cnt == JaxJoin(jcfg).count(jr, js).count == toracle.join_count(rk, sk)


@pytest.mark.parametrize("mode", PARTITIONED)
def test_partitioned_materialize_matches_jax(rng, mode):
    rk, _, sk, _ = make_tables(rng, n_r=1500, n_s=4000, dup_build=True)
    rp = rng.randint(1, 1000, rk.size).astype(np.int32)
    sp = rng.randint(1, 1000, sk.size).astype(np.int32)
    (tr, ts), (jr, js) = _rels(rk, rp, sk, sp)
    cfg, jcfg = _small(mode)
    total = toracle.join_count(rk, sk)
    res = ClusteredJoin(cfg, device="cpu").materialize(tr, ts, capacity=total + 50)
    want = JaxJoin(jcfg).materialize(jr, js, capacity=total + 50)
    assert res.count == want.count == total
    assert res.pairs[0].shape == (total + 50,)

    def multiset(out_r, out_s):
        pairs = np.stack([np.asarray(out_r), np.asarray(out_s)], axis=1)
        return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]

    got = multiset(*res.pairs)
    np.testing.assert_array_equal(got, multiset(*want.pairs))
    np.testing.assert_array_equal(
        got[50:], toracle.join_materialize(rk, rp, sk, sp))   # 50 zero slots


def test_blocked_materialize_ring_wraps_like_jax(rng):
    """A ring smaller than the match count, key-derived payloads (the order
    of duplicate keys cannot matter), a capacity above every JAX scan
    step's matches: slot for slot equal to the JAX engine."""
    rk, _, sk, _ = make_tables(rng, n_r=3000, n_s=9000, dup_build=True)
    rp = (7 * rk.astype(np.int64) + 1).astype(np.int32)
    sp = sk ^ np.int32(0x5BD1E995)
    (tr, ts), (jr, js) = _rels(rk, rp, sk, sp)
    cfg, jcfg = _small("blocked")
    total = toracle.join_count(rk, sk)
    res = ClusteredJoin(cfg, device="cpu").materialize(tr, ts, capacity=2800)
    want = JaxJoin(jcfg).materialize(jr, js, capacity=2800)
    assert res.count == want.count == total > 2 * 2800
    for g, w in zip(res.pairs, want.pairs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", PARTITIONED)
def test_partitioned_late_aggregate_matches_jax(rng, mode):
    rk, _, sk, _ = make_tables(rng, n_r=1500, n_s=4000, dup_build=True)
    r_cols = rng.randint(-2**31, 2**31, (rk.size, 4), dtype=np.int64).astype(np.int32)
    s_cols = rng.randint(-2**31, 2**31, (sk.size, 2), dtype=np.int64).astype(np.int32)
    r_ids = np.arange(rk.size, dtype=np.int32)
    s_ids = rng.permutation(sk.size).astype(np.int32)
    cfg, jcfg = _small(mode)
    got = ClusteredJoin(cfg, device="cpu").late_aggregate(
        Relation.from_numpy(rk, device="cpu"),
        Relation.from_numpy(sk, s_ids, device="cpu"),
        torch.from_numpy(r_cols), torch.from_numpy(s_cols))
    want = JaxJoin(jcfg).late_aggregate(
        JaxRelation(jnp.asarray(rk), jnp.asarray(r_ids)),
        JaxRelation(jnp.asarray(sk), jnp.asarray(s_ids)),
        jnp.asarray(r_cols), jnp.asarray(s_cols))
    assert got.aggregate == want.aggregate == toracle.join_late_materialize_sum(
        rk, r_ids, sk, s_ids, r_cols, s_cols)


def test_pallas_mode_routes_to_the_range_probe(rng, monkeypatch):
    """probe_mode "pallas": partition at radix.total_bits, tiles of at least
    1024 rows, the stream-range probe for the aggregate and the blocked
    probe for the rest, as the JAX engine routes them."""
    from icde2019_gpu_join_tpu_torch.ops import probe as tprobe
    from icde2019_gpu_join_tpu_torch.ops import probe_ranges
    calls = []
    real = probe_ranges.probe_aggregate_ranges

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(probe_ranges, "probe_aggregate_ranges", spy)
    rk, rp, sk, sp = make_tables(rng, n_r=3000, n_s=9000)
    tr, ts = (Relation.from_numpy(rk, rp, device="cpu"),
              Relation.from_numpy(sk, sp, device="cpu"))
    engine = ClusteredJoin(EngineConfig(probe_mode="pallas", probe_tile_s=2048)
                           .with_bits(7), device="cpu")
    res = engine.aggregate(tr, ts)
    assert res.aggregate == toracle.join_aggregate(rk, rp, sk, sp)
    assert calls == [{"tile_r": 1024, "tile_s": 2048}]
    assert [p.name for p in res.timer.phases] == ["partition", "plan", "join"]
    monkeypatch.setattr(tprobe, "blocked_probe_count",
                        lambda *a, **k: torch.tensor(-5, dtype=torch.int32))
    assert engine.count(tr, ts).count == -5    # JAX's int(c), signed


def test_perfect_mode_takes_the_blocked_probe(rng, monkeypatch):
    """The JAX engine never routes "perfect" to ops/perfect_hash.py: it
    falls through to the blocked probe at radix.total_bits bits."""
    from icde2019_gpu_join_tpu_torch.ops import probe as tprobe
    seen = []
    real = tprobe.blocked_probe_aggregate

    def spy(*args, **kw):
        seen.append(args[0].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(tprobe, "blocked_probe_aggregate", spy)
    rk, rp, sk, sp = make_tables(rng, n_r=1000, n_s=3000)
    tr, ts = (Relation.from_numpy(rk, rp, device="cpu"),
              Relation.from_numpy(sk, sp, device="cpu"))
    res = ClusteredJoin(EngineConfig(probe_mode="perfect").with_bits(5), device="cpu"
                        ).aggregate(tr, ts)
    assert res.aggregate == toracle.join_aggregate(rk, rp, sk, sp)
    assert seen == [1000]


def test_partitioned_modes_with_an_empty_side(rng):
    rk = rng.permutation(500).astype(np.int32)
    empty = np.zeros(0, np.int32)
    for mode in PARTITIONED:
        engine = ClusteredJoin(_small(mode)[0], device="cpu")
        for r, s in ((rk, empty), (empty, rk)):
            tr, ts = (Relation.from_numpy(r, device="cpu"),
                      Relation.from_numpy(s, device="cpu"))
            assert engine.aggregate(tr, ts).aggregate == 0
            assert engine.count(tr, ts).count == 0
