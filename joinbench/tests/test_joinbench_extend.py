"""A configuration, a mix, a per-layer metric and a span added as new files,
with new `BENCHMARK.json` entries and no edit to any file the benchmark
has, are found by name and used."""

import json
import os

from joinbench import harness


def _add(root: str, rel: str, text: str) -> None:
    path = os.path.join(root, rel)
    assert not os.path.exists(path)
    with open(path, "w") as f:
        f.write(text)


def test_new_files_are_picked_up_without_an_edit(tiny_root):
    before = {}
    for dirpath, _, files in os.walk(os.path.join(tiny_root, "joinbench")):
        for name in files:
            with open(os.path.join(dirpath, name), "rb") as f:
                before[os.path.join(dirpath, name)] = f.read()

    _add(tiny_root, "joinbench/configs/dup_keys_4K.json", json.dumps({
        "n_r": 2048, "n_s": 8192, "s_keys": "uniform", "zipf_z": 0.0,
        "engine": {"band_window_blocks": 2}}))
    _add(tiny_root, "joinbench/mixes/agg3.json", json.dumps(
        {"query": "aggregate", "clients": 1, "pairs": 3}))
    _add(tiny_root, "joinbench/metrics/windows_calls.py",
         "def read(view):\n    return float(view.queries)\n")
    _add(tiny_root, "joinbench/spans/torch_sort_pairs.json", json.dumps(
        {"module": "icde2019_gpu_join_tpu_torch.ops.merge",
         "function": "torch_sort_pairs", "layer": "sorts"}))
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "dup_keys_4K", "source": "test",
                             "file": "joinbench/configs/dup_keys_4K.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dup_keys_4K.agg3", "config": "dup_keys_4K",
                               "traffic": "agg3", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "windows_calls", "unit": "queries",
                               "better": "higher", "source": "program_span",
                               "layer": "query", "moves": "join_throughput",
                               "workloads": ["dup_keys_4K.agg3"]})
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    line = harness.run_cell("dup_keys_4K.agg3", 17, 0.3, True, device="cpu",
                            root=tiny_root)
    assert line["correct"] is True
    assert line["metrics"]["windows_calls"]["value"] == line["attempted"]
    # the window queried each of the three input pairs
    assert line["attempted"] >= 3
    with open(os.path.join(tiny_root, "joinbench", harness.TRACE_FILE)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "joinbench.torch_sort_pairs" in names
    assert "joinbench.sort_by_key" in names

    for path, data in before.items():
        with open(path, "rb") as f:
            assert f.read() == data, path


def test_spans_are_put_back_after_the_window(tiny_root):
    from icde2019_gpu_join_tpu_torch.models import joins
    from icde2019_gpu_join_tpu_torch.ops import band_join
    before = (band_join.sort_by_key, band_join.banded_probe,
              joins.banded_materialize, joins.ClusteredJoin.aggregate)
    harness.run_cell("uniform_128Mx128M.mat", 3, 0.2, True, device="cpu",
                     root=tiny_root)
    assert before == (band_join.sort_by_key, band_join.banded_probe,
                      joins.banded_materialize, joins.ClusteredJoin.aggregate)
