"""The late-materialization cell, `uniform_128Mx128M_late.late`: its
configuration, its query type (`queries/late_aggregate.py`) and the four
readers of the port's `tpujoin.colsums`, `tpujoin.probe` and
`tpujoin.reduce` spans, on the CPU at a tiny scale; on a card, the command
as the benchmark runs it."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import REPO, TINY
from joinbench import datagen, harness, program_spans, trace
from test_joinbench_program_spans import _op, _span, _write_trace

CELL = "uniform_128Mx128M_late.late"
SEED = 2**31 + 11
READERS = ("span_colsum_ms", "colsum_roofline", "span_late_probe_ms",
           "late_probe_roofline")
# at `TINY` rows a side and SEED: each pair's column sums (int64) and first
# R row and last S row of columns, and the answers of the program and of
# the control at 16-bit columns
PINNED = [
    (-113571387939, 31436332742, [-61050247, -129531109, -45797807, 2067214351],
     [1696810056, -1331991197], -530676573, 33955),
    (142341764435, 78922508392, [-2060611154, -35408994, 1025849011, 1129252315],
     [882151316, 164844975], -2074026565, 56763),
]


def test_the_cell_is_in_the_benchmark():
    cell = harness.load_cell(CELL)
    c = cell.config
    assert cell.chips == 1 and cell.mix["query"] == "late_aggregate"
    assert int(cell.mix["pairs"]) == 2 and int(cell.mix["clients"]) == 1
    assert c["n_r"] == c["n_s"] == 1 << 27 and c["published"] == {
        "n_r": 1 << 27, "n_s": 1 << 27}
    assert c["reduced"] == [] and c["engine"] == {}
    assert (c["r_cols"], c["s_cols"]) == (4, 2)
    assert c["s_keys"] == "uniform" and c["zipf_z"] == 0
    assert harness.query_type(cell).__name__ == "LateAggregate"
    names = {m["name"] for m in cell.metrics("per_layer")}
    assert names == set(READERS)


def _query(root):
    cell = harness.load_cell(CELL, root)
    query = harness.query_type(cell)(cell, SEED)
    pairs = datagen.make_pairs(cell.config, int(cell.mix["pairs"]), SEED, "cpu")
    return cell, query, pairs


def test_inputs_and_answers_are_pinned(tiny_root):
    cell, query, pairs = _query(tiny_root)
    args = query.inputs(pairs, "cpu")
    program = query.program(harness.engine_for(cell, "cpu"))
    control = query.control(16)
    assert len(args) == len(PINNED) == 2
    for i, ((r, s, rc, sc), (rk, _, sk, _), pin) in enumerate(zip(args, pairs, PINNED)):
        # keys as made, payloads row ids in table order
        assert torch.equal(r.keys, rk) and torch.equal(s.keys, sk)
        assert torch.equal(r.payload, torch.arange(TINY, dtype=torch.int32))
        assert torch.equal(s.payload, torch.arange(TINY, dtype=torch.int32))
        assert rc.shape == (TINY, 4) and sc.shape == (TINY, 2)
        assert rc.dtype == sc.dtype == torch.int32
        assert (int(rc.long().sum()), int(sc.long().sum()),
                rc[0].tolist(), sc[-1].tolist()) == pin[:4]
        assert (program(r, s, rc, sc), control(r, s, rc, sc)) == pin[4:]
        query.record(i, i, program(r, s, rc, sc))
    assert query.judge(pairs) == {"wrong_answers": 0}
    assert query.compared == "2 late sums"


def test_the_cpu_copy_is_correct_and_its_control_is_not(tiny_root):
    line = harness.run_cell(CELL, 2**31 + 9, 0.3, False, device="cpu",
                            root=tiny_root)
    assert line["correct"] is True and line["attempted"] >= 2
    assert line["compared"] == f"{line['attempted']} late sums"
    assert line["checks"] == {"wrong_answers": {"value": 0, "limit": 0}}
    line = harness.run_cell(CELL, 2**31 + 9, 0.3, False, device="cpu",
                            root=tiny_root, control_bits=16)
    assert line["correct"] is False
    assert line["checks"]["wrong_answers"]["value"] == line["attempted"] >= 2


def test_a_traced_cpu_run_has_the_spans_and_no_device_time(tiny_root):
    line = harness.run_cell(CELL, 2**31 + 7, 0.3, True, device="cpu",
                            root=tiny_root)
    assert line["correct"] is True
    for name in READERS:          # no device on the CPU
        assert name not in line["metrics"], name
    program = program_spans.load(os.path.join(tiny_root, "joinbench",
                                              harness.TRACE_FILE))
    n = line["attempted"]
    for name in ("tpujoin.join", "tpujoin.colsums", "tpujoin.probe",
                 "tpujoin.reduce"):
        assert program.spans[name] == n, name
    assert program.spans["tpujoin.sort"] == 2 * n


# --- the readers, on made-up traces ---

def _readers(root):
    out = {}
    for name in READERS:
        path = os.path.join(root, "joinbench", "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod.read
    return out


def _events(late=True):
    """One query in a 1000 us window: the column sums 10-110 (device
    20-100), two sorts 110-300, the probe 300-500 (windows 310-350, device
    310-350 and 360-460), the add-mode sum 500-560 (device 505-555). With
    `late` False, the parent's program: no `tpujoin.colsums` and no
    `tpujoin.reduce`, its device work under the join alone."""
    events = [_span("joinbench.window", 0, 1000), _span("joinbench.query", 0, 900),
              _span("tpujoin.join", 5, 600),
              _span("tpujoin.sort", 110, 90), _span("tpujoin.sort", 200, 100),
              _span("tpujoin.probe", 300, 200), _span("tpujoin.windows", 310, 40),
              *_op("sum", 19, 20, 60, 1), *_op("gather", 59, 60, 100, 2),
              *_op("radix", 119, 120, 190, 3), *_op("radix", 209, 210, 290, 4),
              *_op("ranks", 311, 312, 350, 5), *_op("kernel2", 359, 360, 460, 6),
              *_op("reduce", 504, 505, 555, 7)]
    if late:
        events += [_span("tpujoin.colsums", 10, 100), _span("tpujoin.reduce", 500, 60)]
    return events


def _view(queries=1):
    return trace.LayerView(trace.Summary(), queries, TINY, TINY, 3350.0)


def _set_widths(root, r_cols, s_cols):
    path = os.path.join(root, "joinbench", "configs", "uniform_128Mx128M_late.json")
    with open(path) as f:
        config = json.load(f)
    config.update(r_cols=r_cols, s_cols=s_cols)
    with open(path, "w") as f:
        json.dump(config, f)


def test_span_readers(tiny_root):
    _write_trace(tiny_root, _events())
    read = _readers(tiny_root)
    assert read["span_colsum_ms"](_view()) == pytest.approx(0.08)
    # the probe (its windows included) and the sum after it
    assert read["span_late_probe_ms"](_view()) == pytest.approx(0.188)
    assert read["span_late_probe_ms"](_view(queries=4)) == pytest.approx(0.047)


@pytest.mark.parametrize("r_cols,s_cols", [(4, 2), (3, 5), (0, 1)])
def test_rooflines_take_their_bytes_from_the_configuration(tiny_root, r_cols, s_cols):
    _set_widths(tiny_root, r_cols, s_cols)
    _write_trace(tiny_root, _events())
    read = _readers(tiny_root)
    view = _view()
    ms_at_rate = lambda n_bytes: n_bytes / 3350e9 * 1e3
    colsum_bytes = TINY * (4 * r_cols + 8) + TINY * (4 * s_cols + 8)
    assert read["colsum_roofline"](view) == pytest.approx(
        100 * ms_at_rate(colsum_bytes) / 0.08)
    assert read["late_probe_roofline"](view) == pytest.approx(
        100 * ms_at_rate(8 * 2 * TINY) / 0.188)
    # a run at sizes that no configuration of the metric's cells has
    other = trace.LayerView(trace.Summary(), 1, TINY, 2 * TINY, 3350.0)
    assert read["colsum_roofline"](other) is None


@pytest.mark.parametrize("events", [None, "parent", "no_device"])
def test_readers_read_nothing_without_their_spans(tiny_root, events):
    """No trace file; the parent's program, whose trace has a probe but no
    `tpujoin.colsums` or `tpujoin.reduce`; spans with no device time."""
    if events == "parent":
        _write_trace(tiny_root, _events(late=False))
    elif events == "no_device":
        _write_trace(tiny_root, [e for e in _events() if e["cat"] == "user_annotation"])
    read = _readers(tiny_root)
    for name in READERS:
        assert read[name](_view()) is None, name
    # without a memory rate (the CPU) the rooflines read nothing either
    _write_trace(tiny_root, _events())
    cpu = trace.LayerView(trace.Summary(), 1, TINY, TINY, None)
    assert read["colsum_roofline"](cpu) is None
    assert read["late_probe_roofline"](cpu) is None


@pytest.mark.card
@pytest.mark.parametrize("trace_on", [0, 1])
def test_the_command_is_correct_on_the_card(card, trace_on):
    proc = subprocess.run(
        [sys.executable, "-m", "joinbench.run", "--workload", CELL,
         "--seed", str(2**31 + 21), "--seconds", "2", "--trace", str(trace_on)],
        cwd=REPO, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace_on:
        for name in READERS:
            assert line["metrics"][name]["value"] > 0, name
        for name in ("colsum_roofline", "late_probe_roofline"):
            assert line["metrics"][name]["value"] <= 100, name
