"""The port's benchmarks/probe_bench.py on the CPU at small sizes: every
line's keys, kernels 1 and 3 seen through the wrappers band_join calls, the
results checked against the checked-in oracle value (2^18)."""

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
    assert probe_bench.main(["isolated", "--device", "cpu", "--reps", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "cpu"
    assert len([json.loads(ln) for ln in out[:-1]]) == len(probe_bench.SHAPE_OF)
