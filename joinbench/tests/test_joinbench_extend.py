"""A configuration, a mix, a query type, a per-layer metric and a span added
as new files, with new `BENCHMARK.json` entries and no edit to any file the
benchmark has, are found by name and used."""

import json
import os

import pytest

from joinbench import harness

# A late-materialization query type, as a later cell would add it: payloads
# are row ids, each side carries extra int32 columns (their numbers are keys
# of the configuration that only this file reads), and each match adds the
# row sums of both sides.
LATE = '''"""Query type `late_cols`: `ClusteredJoin.late_aggregate` with row-id
payloads and `r_cols` / `s_cols` (keys of the configuration) extra int32
columns a side, drawn over the whole int32 range from a generator of its
own, seeded with the run's seed XOR 2^62: no run's pairs use that seed.
Each match adds the row sums of both sides, mod 2^32."""

import torch

from joinbench import datagen, reference

SALT = 1 << 62


def late_sum(r_keys, r_cols, s_keys, s_cols, payload_bits=32):
    """SUM over matches of (R's row sum + S's row sum) mod 2^32, each
    column narrowed to `payload_bits` first."""
    def row_sums(cols):
        v = reference.narrow(cols, payload_bits).to(torch.int64).sum(1)
        return ((v + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)
    rc, sc = row_sums(r_cols), row_sums(s_cols)
    return reference.to_i32(
        reference.aggregate(r_keys, rc, s_keys, torch.ones_like(sc))
        + reference.aggregate(r_keys, torch.ones_like(rc), s_keys, sc))


class LateCols:
    limits = {"wrong_answers": 0}

    def __init__(self, cell, seed):
        self.widths = int(cell.config["r_cols"]), int(cell.config["s_cols"])
        self.seed = seed
        self.cols = []
        self.answers = []
        self.failed = 0

    def inputs(self, pairs, device):
        from icde2019_gpu_join_tpu_torch.relation import Relation
        g = datagen.generator(self.seed ^ SALT, device)
        out = []
        for rk, _, sk, _ in pairs:
            rc, sc = (datagen.payloads(k.shape[0] * w, g, device).view(-1, w)
                      for k, w in zip((rk, sk), self.widths))
            self.cols.append((rc, sc))
            out.append((Relation(rk), Relation(sk), rc, sc))
        return out

    def program(self, engine):
        return lambda r, s, rc, sc: engine.late_aggregate(r, s, rc, sc).aggregate

    def control(self, payload_bits):
        return lambda r, s, rc, sc: late_sum(r.keys, rc, s.keys, sc, payload_bits)

    def record(self, i, pair, answer):
        self.answers.append((pair, answer))

    def judge(self, pairs):
        expect = [late_sum(rk, rc, sk, sc)
                  for (rk, _, sk, _), (rc, sc) in zip(pairs, self.cols)]
        self.failed = sum(a != expect[p] for p, a in self.answers)
        self.compared = f"{len(self.answers)} late sums"
        return {"wrong_answers": self.failed}
'''


def _add(root: str, rel: str, text: str) -> None:
    path = os.path.join(root, rel)
    assert not os.path.exists(path)
    with open(path, "w") as f:
        f.write(text)


def _files(root: str) -> dict:
    out = {}
    for dirpath, _, files in os.walk(os.path.join(root, "joinbench")):
        for name in files:
            with open(os.path.join(dirpath, name), "rb") as f:
                out[os.path.join(dirpath, name)] = f.read()
    return out


def _add_cell(root: str, config: str, traffic: str) -> str:
    """Entries for a new configuration and its cell in `BENCHMARK.json`."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": config, "source": "test",
                             "file": f"joinbench/configs/{config}.json",
                             "reduced": [], "why": "test"})
    name = f"{config}.{traffic}"
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1, "why": "test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return name


def test_new_files_are_picked_up_without_an_edit(tiny_root):
    before = _files(tiny_root)

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
    _add_cell(tiny_root, "dup_keys_4K", "agg3")
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
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


def test_a_new_query_type_is_picked_up_without_an_edit(tiny_root):
    before = _files(tiny_root)
    _add(tiny_root, "joinbench/queries/late_cols.py", LATE)
    _add(tiny_root, "joinbench/configs/late_4K.json", json.dumps({
        "n_r": 2048, "n_s": 4096, "s_keys": "uniform", "zipf_z": 0.0,
        "engine": {}, "r_cols": 1, "s_cols": 1}))
    _add(tiny_root, "joinbench/mixes/late.json", json.dumps(
        {"query": "late_cols", "clients": 1, "pairs": 2}))
    cell = _add_cell(tiny_root, "late_4K", "late")

    line = harness.run_cell(cell, 2**31 + 9, 0.3, False, device="cpu",
                            root=tiny_root)
    assert line["correct"] is True and line["attempted"] >= 2
    assert line["compared"] == f"{line['attempted']} late sums"
    assert line["checks"] == {"wrong_answers": {"value": 0, "limit": 0}}
    # the control, its columns narrowed to int16, gets every answer wrong
    line = harness.run_cell(cell, 2**31 + 9, 0.3, False, device="cpu",
                            root=tiny_root, control_bits=16)
    assert line["correct"] is False
    assert line["checks"]["wrong_answers"]["value"] == line["attempted"] >= 2

    for path, data in before.items():
        with open(path, "rb") as f:
            assert f.read() == data, path


def test_a_mix_without_its_query_file_fails_with_the_files_name(tiny_root):
    _add(tiny_root, "joinbench/mixes/nosuch.json", json.dumps(
        {"query": "nosuch", "clients": 1, "pairs": 2}))
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "uniform_128Mx128M.nosuch",
                               "config": "uniform_128Mx128M",
                               "traffic": "nosuch", "chips": 1, "why": "test"})
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    with pytest.raises(FileNotFoundError, match="queries/nosuch.py"):
        harness.run_cell("uniform_128Mx128M.nosuch", 1, 0.1, False,
                         device="cpu", root=tiny_root)


def test_spans_are_put_back_after_the_window(tiny_root):
    from icde2019_gpu_join_tpu_torch.models import joins
    from icde2019_gpu_join_tpu_torch.ops import band_join
    before = (band_join.sort_by_key, band_join.banded_probe,
              joins.banded_materialize, joins.ClusteredJoin.aggregate)
    harness.run_cell("uniform_128Mx128M.mat", 3, 0.2, True, device="cpu",
                     root=tiny_root)
    assert before == (band_join.sort_by_key, band_join.banded_probe,
                      joins.banded_materialize, joins.ClusteredJoin.aggregate)
