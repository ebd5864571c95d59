"""The port's benchmark scripts on the CPU at reduced scales: the headline
bench (benchmarks/bench.py), `run_configs` configs 1-6 through their
functions, `precache_oracles`, and `entry`. The oracle caches and the .bin
datasets go to `tmp_path`. `_fingerprint` and `_cache_path` are held
against those of the repository's `benchmarks/run_configs.py`, loaded by
path as the repository's precache script loads it."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu_torch import entry as tentry
from icde2019_gpu_join_tpu_torch.benchmarks import bench
from icde2019_gpu_join_tpu_torch.benchmarks import precache_oracles as pre
from icde2019_gpu_join_tpu_torch.benchmarks import run_configs as rc
from icde2019_gpu_join_tpu_torch.config import EngineConfig
from icde2019_gpu_join_tpu_torch.models import coprocess, joins

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "correct", "aggregate", "elapsed_s",
        "phases", "sort_impl", "device"}


def _load_jax_run_configs():
    spec = importlib.util.spec_from_file_location(
        "jax_run_configs", os.path.join(REPO, "benchmarks", "run_configs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def data(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_JOIN_DATA_DIR", str(tmp_path))
    return str(tmp_path)


@pytest.mark.parametrize("skew,metric", [
    (0.0, "join_throughput_0Mx0M"), (1.05, "join_throughput_0Mx0M_zipf1.05")])
def test_bench_line_at_scale_12(data, skew, metric):
    line = bench.run(scale=12, skew=skew, reps=2, device="cpu", cache_dir=data)
    assert set(line) == KEYS            # no vs_* share, no hbm_gbps
    assert line["correct"] is True and line["metric"] == metric
    assert line["unit"] == "Mrows/s" and line["value"] > 0
    assert line["sort_impl"] == "lax" and line["device"] == "cpu"
    assert line["phases"]["join"] > 0
    cached = os.path.join(
        data, f"oracle_agg_pkfk_s12_z{skew}_seed12345_gnative.json")
    assert os.path.exists(cached)


def test_bench_hands_the_sort_to_the_engine(data, monkeypatch):
    seen = []
    real = bench.ClusteredJoin

    def spy(config, device):
        seen.append(config.sort_impl)
        return real(config, device)

    monkeypatch.setattr(bench, "ClusteredJoin", spy)
    line = bench.run(scale=13, reps=1, sort_impl="packed", device="cpu",
                     cache_dir=data)
    assert seen == ["packed"] and line["sort_impl"] == "packed"
    assert line["correct"] is True


def test_bench_reads_the_checked_in_oracle(monkeypatch, tmp_path):
    """Scale 18's value is checked in under data/: the gate reads it rather
    than computing it."""
    monkeypatch.setenv("TPU_JOIN_DATA_DIR", str(tmp_path))
    monkeypatch.setattr(bench.datagen, "host_oracle_aggregate",
                        lambda *a: pytest.fail("oracle recomputed"))
    ones = np.ones(1, np.int32)
    got = bench.oracle_expect_cached(ones, ones, ones, ones, 18, 0.0)
    assert got == 262144


def test_fingerprint_and_cache_path_equal_jax(rng):
    jrc = _load_jax_run_configs()
    arrays = [rng.randint(0, 2**31 - 1, n).astype(np.int32)
              for n in (1, 5000, 20000)]
    for k in range(1, 4):
        assert rc._fingerprint(*arrays[:k]) == jrc._fingerprint(*arrays[:k])
    assert rc._fingerprint(np.zeros(0, np.int32)) == jrc._fingerprint(
        np.zeros(0, np.int32))
    fp = rc._fingerprint(*arrays)
    for tag in ("c3_s26_seed42", "c4_pkfk_s26_z1.05_seed12345",
                "c6_r16777216_s67108864_seed12345"):
        assert rc._cache_path(tag, fp) == jrc._cache_path(tag, fp)


def test_config1(data):
    line = rc.config1(device="cpu", n_r=1 << 12, n_s=1 << 14)
    assert line["correct"] is True and line["rows"] == (1 << 12) + (1 << 14)


def test_config2_both_legs(data):
    agg, mat = rc.config2(12, device="cpu", cache_dir=data, ring=1 << 12)
    assert agg["correct"] and mat["correct"]
    assert mat["metric"] == "materialize_0Mx0M_fold12"
    assert mat["matches_mod32"] == 4096


def test_config3_fused_then_streamed(data, monkeypatch):
    fused = rc.config3(13, device="cpu", cache_dir=data, n_r=1 << 10)
    assert fused["correct"] and "segments" not in fused
    monkeypatch.setattr(rc, "_c3_fused_fits", lambda *a: False)
    monkeypatch.setattr(rc, "C3_SEGMENT_ROWS", 1500)
    streamed = rc.config3(13, device="cpu", cache_dir=data, n_r=1 << 10)
    assert streamed["correct"] and streamed["segments"] == 8


@pytest.mark.parametrize("n_s,fits,want", [
    (1 << 29, False, 4),                  # n_s >> 27, as before
    (1 << 26, False, 1),
    (3 << 27, False, 3),
    (600_000_000, False, 5),              # not a power of two
    (7 * 11 << 23, False, 7),             # 5 and 6 do not divide it
    ((1 << 27) + 1, False, 3),            # 2 does not divide it
    ((1 << 27) + 29, False, (1 << 27) + 29),   # a prime: rows of one
    (7 * 11 << 23, True, 1)])
def test_config3_segment_rule(n_s, fits, want):
    seg = rc.config3_segments(n_s, fits)
    assert seg == want
    assert n_s % seg == 0 and (fits or n_s // seg <= rc.C3_SEGMENT_ROWS)


def test_config4_and_config6(data):
    assert rc.config4(12, device="cpu", cache_dir=data)["correct"]
    line = rc.config6(14, device="cpu", cache_dir=data)
    assert line["correct"] and set(line["phases"]) == {"build_sort", "stream"}


def test_config4_coprocessed_branch(data, monkeypatch):
    """Config 4 from C4_COPROCESS_SCALE rows a side: the relations stay in
    host memory and the dispatcher co-processes them. Here the threshold is
    lowered to scale 12 and the engine's resident limit under 2^12 rows, so
    that branch runs and is held against the oracle."""
    seen = []
    real = coprocess.coprocess_join_aggregate

    def spy(r, s, config=None, device="cuda"):
        seen.append((r.device.type, s.device.type, r.num_rows, s.num_rows))
        return real(r, s, config, device)

    monkeypatch.setattr(rc, "C4_COPROCESS_SCALE", 12)
    monkeypatch.setattr(joins, "EngineConfig",
                        lambda: EngineConfig(resident_limit_rows=1 << 11))
    monkeypatch.setattr(coprocess, "coprocess_join_aggregate", spy)
    line = rc.config4(12, device="cpu", cache_dir=data)
    assert line["correct"] and line["regime"] == "coprocess"
    assert seen == [("cpu", "cpu", 1 << 12, 1 << 12)]     # one call, no warm-up


def test_config5_one_rank_legs_and_dryrun(data, capsys):
    lines = rc.config5(12, device="cpu", cache_dir=data)
    assert [line["metric"] for line in lines] == [
        "distributed_exchange_1chip_0Mx0M", "distributed_oneshot_1chip_0Mx0M",
        "distributed_zipf_1chip_0Mx0M"]
    assert all(line["correct"] and line["overflow"] == 0 for line in lines)
    assert "dryrun_multichip(8) on cpu" in capsys.readouterr().out


def test_config5_legs_through_a_callers_runner(data):
    """The hook that lets a caller time and count each leg its own way:
    every leg goes through it once, and its result decides the line."""
    calls = []

    def run(tag, fn):
        calls.append(tag)
        fn()
        return 1.0, fn()

    lines = rc._one_rank_legs(1 << 12, "cpu", data, run=run)
    assert calls == ["distributed_exchange_1chip", "distributed_oneshot_1chip",
                     "distributed_zipf_1chip"]
    assert all(line["correct"] and line["seconds"] == 1.0 for line in lines)


def test_config5_two_process_gloo_world(data):
    """The branch for several cards, one process a rank, here as a gloo
    world of two CPU processes (unverified on cards)."""
    (line,) = rc.config5(12, device="cpu", cache_dir=data, ranks=2)
    assert line["correct"] and line["metric"] == "distributed_0Mx0M_2dev"


def test_precache_fills_the_keys_the_configs_read(data, monkeypatch):
    pre.c3(12, n_r=1 << 10, cache_dir=data)
    pre.c4(12, cache_dir=data)
    monkeypatch.setattr(rc.oracle, "filter_probe_groupby",
                        lambda *a: pytest.fail("config 3 oracle recomputed"))
    monkeypatch.setattr(rc.datagen, "host_oracle_aggregate",
                        lambda *a: pytest.fail("config 4 oracle recomputed"))
    assert rc.config3(12, device="cpu", cache_dir=data, n_r=1 << 10)["correct"]
    assert rc.config4(12, device="cpu", cache_dir=data)["correct"]


def test_entry_forward_equals_jax():
    import __graft_entry__ as graft
    jfn, jargs = graft.entry()
    fn, args = tentry.entry(device="cpu")
    for a, b in zip(args, jargs):
        assert np.array_equal(a.numpy(), np.asarray(b))
    got = fn(*args)
    assert got.dtype == torch.int32
    assert int(got) == int(jfn(*jargs)) == 1 << 20
