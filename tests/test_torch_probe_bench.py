"""The port's benchmarks/probe_bench.py on the CPU at small sizes: every
line's keys, kernels 1, 2 and 3 seen through the wrappers band_join calls,
kernel 5 at the "pallas" joins' plans, the results checked against the
checked-in oracle value (2^18) and the oracles."""

import json

import pytest

from icde2019_gpu_join_tpu_torch.benchmarks import probe_bench
from icde2019_gpu_join_tpu_torch.ops import band_join


def test_steps_time_each_step_and_every_launch():
    agg, desc = probe_bench.steps(18, 1, "cpu")
    assert agg["op"] == "aggregate_steps" and agg["device"] == "cpu"
    for key in ("aggregate_best_ms", "sorts_ms", "block_windows_ms",
                "probe_ms", "total_ms"):
        assert agg[key] > 0
    k1 = agg["kernels"]["banded_window_sum"]
    # one chunk of 2048 S blocks, round 0
    assert k1["launches"] == 1 and list(k1["by_shape"]) == ["[2048, 1]"]
    assert set(agg["kernels"]) == {"banded_window_sum"}
    k3 = desc["kernels"]["banded_window_first"]
    assert desc["op"] == "descriptors" and k3["launches"] == 1
    assert desc["descriptors_ms"] > 0


def test_cli_join_records_kernel_1_by_shape(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_JOIN_DATA_DIR", str(tmp_path))
    argv = ["-b", "7", "-a", "HJC", "-R", "4000", "-S", "16000"]
    join, rank = probe_bench.cli_join(1, "cpu", cli_args=argv, rank_log2n=18)
    shapes = join["kernels"]["banded_window_sum"]["by_shape"]
    # the warm-up and the timed call: 125 S blocks in one round-0 chunk,
    # and round 1 over the 31 that straddle an R block boundary
    assert shapes["[125, 1]"]["launches"] == 2
    assert shapes["[31, 1]"]["launches"] == 2
    assert join["result"] and join["result"][0].endswith(" results")
    assert rank["kernels"]["banded_window_first"]["by_shape"]["[2048, 1]"][
        "launches"] == 1


def test_kernel_events_restore_the_wrappers():
    before = {n: getattr(band_join, n) for n in ("banded_window_sum",
                                                 "banded_window_first")}
    with probe_bench.kernel_events("cpu") as calls:
        assert band_join.banded_window_sum is not before["banded_window_sum"]
    assert calls == []
    for name, fn in before.items():
        assert getattr(band_join, name) is fn


@pytest.mark.parametrize("shape", [(8, 1), (5, 2), (33, 3)])
def test_isolated_times_every_entry_point(shape):
    lines = probe_bench.isolated("cpu", shapes=[shape], reps=1)
    assert sorted(ln["kernel"] for ln in lines) == sorted(probe_bench.SHAPE_OF)
    for ln in lines:
        assert ln["shape"] == list(shape) and ln["ms"] > 0
        assert ln["bound_ms"] is None   # the card's rates only


def test_main_prints_json_lines_then_the_card(capsys, monkeypatch):
    monkeypatch.setattr(probe_bench, "SHAPES", [(4, 1)])
    monkeypatch.setattr(probe_bench, "WIDE_SHAPES", [])
    assert probe_bench.main(["isolated", "--device", "cpu", "--reps", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "cpu"
    assert len([json.loads(ln) for ln in out[:-1]]) == len(probe_bench.SHAPE_OF)


def test_isolated_times_kernel_2_also_at_the_wide_shapes(monkeypatch):
    monkeypatch.setattr(probe_bench, "SHAPES", [(4, 1)])
    monkeypatch.setattr(probe_bench, "WIDE_SHAPES", [(3, 6)])
    lines = probe_bench.isolated("cpu", reps=1)
    shapes = {}
    for ln in lines:
        shapes.setdefault(ln["kernel"], []).append(tuple(ln["shape"]))
    for name in probe_bench.SHAPE_OF:
        wide = probe_bench.KIND[name] == "per_s"
        assert shapes[name] == [(4, 1)] + ([(3, 6)] if wide else [])


def test_per_s_steps_time_config_3s_probe_and_every_launch():
    (line,) = probe_bench.per_s_steps(1, "cpu", (1 << 12, 1 << 16, 64, 100,
                                                 600))
    assert line["op"] == "per_s_steps" and line["n_s"] == 1 << 16
    for key in ("pipeline_best_ms", "sort_r_ms", "filter_sort_s_ms",
                "block_windows_ms", "probe_ms", "total_ms"):
        assert line[key] > 0
    # 512 S blocks, half of them filtered rows with empty windows: a
    # round-0 chunk of the others, and round 1 over those whose window
    # straddles an R block boundary
    k2 = line["kernels"]["banded_window_per_s"]
    assert set(line["kernels"]) == {"banded_window_per_s"}
    assert k2["launches"] == len(k2["by_shape"]) >= 2
    assert all(0 < json.loads(shape)[0] <= 512 and json.loads(shape)[1] == 1
               for shape in k2["by_shape"])


def test_late_steps_time_the_add_probe(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_JOIN_DATA_DIR", str(tmp_path))
    (line,) = probe_bench.late_steps(14, 1, "cpu")
    assert line["op"] == "late_steps" and line["n"] == 1 << 14
    for key in ("late_aggregate_best_ms", "colsums_ms", "sorts_ms",
                "block_windows_ms", "probe_ms", "total_ms"):
        assert line[key] > 0
    assert set(line["kernels"]) == {"banded_window_per_s"}


def test_ranges_time_kernel_5_at_each_plan(tmp_path, monkeypatch):
    """Config 1, the Zipf relations and config 2 (2^18: its oracle value is
    checked in) through the "pallas" join, each result against its oracle;
    then the plan of one key a tile."""
    monkeypatch.setenv("TPU_JOIN_DATA_DIR", str(tmp_path))
    lines = probe_bench.ranges(1, "cpu", config1=(1 << 12, 1 << 14),
                               zipf_log2n=13, config2_log2n=18,
                               one_key=(1 << 13, 1 << 16))
    assert [ln["plan"] for ln in lines] == ["config 1", "zipf 1.05 2^13",
                                           "config 2", "one key a tile"]
    for ln in lines:
        assert ln["op"] == "ranges" and ln["kernel_ms"] > 0
        assert ln["items"] > 0 and ln["rows"] >= ln["items"] * 1024
        assert ln["bound_by"] == "bytes" and ln["bound_ms"] > 0
    assert lines[2]["bits"] == 18 and lines[2]["max_chunks"] == 1
    # one key a tile: 8 tiles, 2^13 S rows a key, 8 or 9 chunks a tile
    assert lines[3]["max_chunks"] >= 8
