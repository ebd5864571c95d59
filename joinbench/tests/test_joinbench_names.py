"""`BENCHMARK.json` within the contract's shapes, and every file it names
present and readable."""

import importlib
import json
import os
import re

import pytest

from conftest import REPO

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}\Z")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes(bench):
    assert set(bench) == KEYS["top"]
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[kind]:
            extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
            assert KEYS[kind] <= set(entry) <= KEYS[kind] | extra, entry


def test_names_units_and_lines(bench):
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[k]]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in bench[kind]}) == len(bench[kind])
    for name in names:
        assert NAME.match(name), name
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert _line(c["why"]) and _line(c["source"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert _line(m["layer"])


def test_metrics_sources_bounds_and_cells(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 2 <= len(e2e) <= 16
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        assert any(cell in m["workloads"] for m in bench["per_layer"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_named_file_is_there(bench):
    bench_dir = os.path.join(REPO, bench["paths"][0])
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")
        with open(os.path.join(REPO, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]
        changed = {k for k, v in conf["published"].items() if conf[k] != v}
        assert changed == set(c["reduced"])
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(bench_dir, "mixes", w["traffic"] + ".json"))
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(bench_dir, "metrics", m["name"] + ".py"))


@pytest.mark.parametrize("name", sorted(
    os.path.splitext(f)[0] for f in os.listdir(os.path.join(REPO, "joinbench", "spans"))))
def test_each_span_names_a_function_of_the_program(name):
    with open(os.path.join(REPO, "joinbench", "spans", name + ".json")) as f:
        spec = json.load(f)
    assert set(spec) == {"module", "function", "layer"}
    assert spec["module"].split(".")[0] == "icde2019_gpu_join_tpu_torch"
    owner = importlib.import_module(spec["module"])
    for part in spec["function"].split("."):
        owner = getattr(owner, part)
    assert callable(owner)


def test_layers_of_the_per_layer_metrics_are_listed_in_perf_md(bench):
    with open(os.path.join(REPO, "PERF.md")) as f:
        perf = f.read()
    for m in bench["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]
