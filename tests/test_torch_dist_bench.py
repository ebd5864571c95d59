"""The distributed layer's timing tool (`benchmarks/dist_bench.py`) on the
CPU at a tiny size: every leg runs, checks its result against the oracle
and reports its numbers."""

import json

from icde2019_gpu_join_tpu_torch.benchmarks import dist_bench


def test_dist_bench_runs_every_leg_on_the_cpu(capsys):
    assert dist_bench.main(["--log2-rank", "9", "--log2-process", "12",
                            "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    scaling, mat, proc = line["scaling"], line["materialize"], line["process"]
    assert scaling["correct"] and mat["correct"] and proc["correct"]
    assert set(scaling["segmented_ms"]) == {"1", "2", "4", "8"}
    assert scaling["all_gather_call_ms"] > 0
    assert len(mat["routed_ms"]) == len(mat["slot_ms"]) == 2
    assert len(mat["routed_busy_ms"]) == len(mat["slot_busy_ms"]) == 2
    assert mat["capacity_per_chip"] >= 2 * mat["pairs"] > 0
    assert proc["backend"] == "gloo"
    assert set(proc["profiled"]["spans"]) == {"plan", "exchange", "probe"}


def test_dist_bench_runs_the_legs_it_is_given(capsys):
    assert dist_bench.main(["process", "--log2-process", "10",
                            "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"process"} and line["process"]["correct"]
