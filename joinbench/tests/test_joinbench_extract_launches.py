"""`extract_kernel_launches`, the reader of the port's extraction kernel
launches (`ops/extract_pairs.LAUNCHES`) a query: on made-up counter tables,
in the mat cell's traced run on the CPU, and on a card."""

import importlib.util
import json
import os
import subprocess
import sys
import types

import pytest

from conftest import REPO
from joinbench import harness, program_spans

NAME = "extract_kernel_launches"
CELL = "uniform_128Mx128M.mat"


def _reader(root):
    path = os.path.join(root, "joinbench", "metrics", NAME + ".py")
    spec = importlib.util.spec_from_file_location(NAME, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _tables(monkeypatch, events, launches):
    """The port's counter tables as made-up modules; None: no such table."""
    for module, table, value in (("ops._launches", "EVENTS", events),
                                 ("ops.extract_pairs", "LAUNCHES", launches)):
        mod = types.ModuleType(module)
        if value is not None:
            setattr(mod, table, value)
        monkeypatch.setitem(sys.modules, program_spans.PORT + module, mod)


def test_the_metric_is_the_mat_cells():
    cell = harness.load_cell(CELL)
    (entry,) = [m for m in cell.metrics("per_layer") if m["name"] == NAME]
    assert entry == {"name": NAME, "unit": "launches", "better": "lower",
                     "source": "program_counter", "layer": "materialization",
                     "moves": "join_throughput", "workloads": [CELL]}


def test_launches_a_query(monkeypatch):
    _tables(monkeypatch, {"queries": 10, "probe_rounds": 10, "host_syncs": 40},
            {"extract_pairs": 10})
    assert _reader(REPO)(None) == 1.0


@pytest.mark.parametrize("events,launches", [
    ({"queries": 4}, None),                               # the parent's port
    (None, {"extract_pairs": 4}),                         # no engine table
    ({"queries": 0}, {"extract_pairs": 0}),               # no engine call
    ({"queries": 4}, {"extract_pairs": 0}),               # the CPU: no launch
])
def test_nothing_to_read_reads_nothing(monkeypatch, events, launches):
    _tables(monkeypatch, events, launches)
    assert _reader(REPO)(None) is None


def test_a_traced_cpu_run_leaves_it_out(tiny_root):
    line = harness.run_cell(CELL, 2**31 + 17, 0.3, True, device="cpu",
                            root=tiny_root)
    assert line["correct"] is True
    assert NAME not in line["metrics"]


@pytest.mark.card
def test_one_a_query_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "-m", "joinbench.run", "--workload", CELL,
         "--seed", str(2**31 + 29), "--seconds", "2", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["metrics"][NAME]["value"] == 1.0
    assert line["metrics"][NAME]["unit"] == "launches"
    assert line["metrics"]["host_syncs"]["value"] == 4.0
