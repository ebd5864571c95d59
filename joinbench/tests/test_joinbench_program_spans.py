"""The program's spans and counters as the benchmark reads them
(`program_spans.py` and the seven readers that use it): on a made-up Chrome
trace, on made-up counter tables, and in a traced run on the CPU."""

import importlib.util
import json
import os
import sys
import types

import pytest

from joinbench import harness, program_spans, trace

MAIN, OTHER = 1, 2
SPAN_READERS = ("span_sort_ms", "span_probe_ms", "span_extract_ms",
                "probe_idle_ms")
COUNTER_READERS = ("probe_rounds", "probe_launches", "host_syncs")


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid, "args": args}


def _span(name, ts, dur, tid=MAIN):
    return _x("user_annotation", name, ts, dur, tid)


def _op(name, launch, start, end, corr):
    return [_x("cuda_runtime", "cudaLaunchKernel", launch, 1, correlation=corr),
            _x("kernel", name, start, end - start, tid=7, correlation=corr)]


def _events():
    """Window 0-1000 us, one query 0-900. The program: join 10-800 with two
    sorts (each with its gather), the probe 210-500 (windows 215-260, its
    read-back 270-350), the extraction 505-790 (a read 600-650), and the
    phase's synchronise 810-880. The benchmark's own wrappers lie around
    some of them. Device idle: 0-30 (join), 205-220 (probe), 270-355
    (the probe's read-back), 500-520 (extraction), 600-660 (the
    extraction's read), 790-1000 (the query, outside the program)."""
    return [
        _span("joinbench.window", 0, 1000),
        _span("joinbench.query", 0, 900),
        _span("joinbench.clustered_aggregate", 5, 885),
        _span("tpujoin.join", 10, 790),
        _span("joinbench.sort_by_key", 20, 100),
        _span("tpujoin.sort", 21, 98),
        _span("tpujoin.sort.gather", 60, 50),
        _span("tpujoin.sort", 125, 75),
        _span("tpujoin.sort.gather", 160, 35),
        _span("joinbench.banded_probe", 208, 294),
        _span("tpujoin.probe", 210, 290),
        _span("tpujoin.windows", 215, 45),
        _span("tpujoin.sync", 270, 80),
        _span("tpujoin.extract", 505, 285),
        _span("tpujoin.sync", 600, 50),
        _span("tpujoin.sync", 810, 70),
        _span("tpujoin.sort", 20, 100, tid=OTHER),
        *_op("onesweep", 30, 30, 100, 1),
        *_op("gather", 65, 100, 150, 2),
        *_op("onesweep", 130, 150, 190, 3),
        *_op("gather", 165, 190, 205, 4),
        *_op("ranks", 220, 220, 270, 5),
        *_op("window_sum", 352, 355, 500, 6),
        *_op("select", 515, 520, 600, 7),
        *_op("per_s", 655, 660, 790, 8),
    ]


def _readers(root):
    out = {}
    for name in SPAN_READERS + COUNTER_READERS:
        path = os.path.join(root, "joinbench", "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod.read
    return out


def _write_trace(root, events):
    path = os.path.join(root, "joinbench", harness.TRACE_FILE)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return path


def _view(queries=1):
    return trace.LayerView(trace.Summary(), queries, 1 << 20, 1 << 20, 3350.0)


def test_program_spans_are_renamed_with_their_chain():
    kept, spans = program_spans.program_events(_events())
    names = [e["name"] for e in kept if e.get("cat") == "user_annotation"]
    assert "joinbench.sort_by_key" not in names
    assert "joinbench.clustered_aggregate" not in names
    assert {"joinbench.window", "joinbench.query"} <= set(names)
    assert "joinbench.tpujoin.join/tpujoin.sort/tpujoin.sort.gather" in names
    assert "joinbench.tpujoin.join/tpujoin.probe/tpujoin.sync" in names
    assert "joinbench.tpujoin.join/tpujoin.extract/tpujoin.sync" in names
    assert "joinbench.tpujoin.sync" in names          # the phase's synchronise
    # the other thread's sort is not counted in the window's thread
    assert spans == {"tpujoin.join": 1, "tpujoin.sort": 2,
                     "tpujoin.sort.gather": 2, "tpujoin.probe": 1,
                     "tpujoin.windows": 1, "tpujoin.sync": 3,
                     "tpujoin.extract": 1}


def test_device_time_and_idle_by_program_span(tiny_root):
    _write_trace(tiny_root, _events())
    read = _readers(tiny_root)
    view = _view()
    assert read["span_sort_ms"](view) == pytest.approx(0.175)
    assert read["span_probe_ms"](view) == pytest.approx(0.195)   # windows too
    assert read["span_extract_ms"](view) == pytest.approx(0.21)
    # the gap inside the probe's read-back counts and so does the one
    # between its spans; the one inside the extraction's read does not
    assert read["probe_idle_ms"](view) == pytest.approx(0.1)
    assert read["span_sort_ms"](_view(queries=5)) == pytest.approx(0.035)
    program = program_spans.load(os.path.join(tiny_root, "joinbench",
                                              harness.TRACE_FILE))
    assert program.busy == 580
    assert sum(program.idle.values()) == pytest.approx(420)
    assert program.idle[frozenset({"tpujoin.join", "tpujoin.extract",
                                   "tpujoin.sync"})] == pytest.approx(60)
    assert program.idle[frozenset()] == pytest.approx(210)
    # the benchmark's own reading of the same trace is as it was
    plain = trace.summarize(_events())
    assert plain.chains[frozenset({"clustered_aggregate", "sort_by_key"})] == 120


def test_the_parse_is_shared_until_the_file_changes(tiny_root):
    path = _write_trace(tiny_root, _events())
    first = program_spans.load(path)
    assert program_spans.load(path) is first
    _write_trace(tiny_root, _events() + [_span("tpujoin.sync", 950, 20)])
    again = program_spans.load(path)
    assert again is not first and again.spans["tpujoin.sync"] == 4


def test_a_trace_without_program_spans_reads_nothing(tiny_root):
    """The parent's program: the benchmark's wrappers and no `tpujoin.*`."""
    _write_trace(tiny_root, [e for e in _events()
                             if not e["name"].startswith("tpujoin.")])
    read = _readers(tiny_root)
    for name in SPAN_READERS:
        assert read[name](_view()) is None, name


def test_no_trace_file_reads_nothing(tiny_root):
    read = _readers(tiny_root)
    for name in SPAN_READERS:
        assert read[name](_view()) is None, name


def _tables(monkeypatch, events, launches):
    """The port's counter tables as made-up modules."""
    for module, table, value in (("ops._launches", "EVENTS", events),
                                 ("ops.band_compare", "LAUNCHES", launches)):
        mod = types.ModuleType(module)
        if value is not None:
            setattr(mod, table, value)
        monkeypatch.setitem(sys.modules, program_spans.PORT + module, mod)


def test_counters_a_query(tiny_root, monkeypatch):
    _tables(monkeypatch,
            {"queries": 10, "probe_rounds": 10, "host_syncs": 30},
            {"banded_window_sum": 320, "banded_window_first": 0,
             "banded_compare_per_s": 7, "banded_interval_select": 9})
    read = _readers(tiny_root)
    assert read["probe_rounds"](_view()) == 1.0
    assert read["probe_launches"](_view()) == 32.0
    assert read["host_syncs"](_view()) == 3.0


@pytest.mark.parametrize("events,launches", [
    (None, {"banded_window_sum": 320}),                  # the parent's port
    ({"queries": 0, "probe_rounds": 0, "host_syncs": 0},
     {"banded_window_sum": 0}),                          # no engine call
    ({"queries": 4, "probe_rounds": 4, "host_syncs": 8},
     {"banded_window_sum": 0}),                          # the CPU: no launch
])
def test_counters_absent_read_nothing(tiny_root, monkeypatch, events, launches):
    _tables(monkeypatch, events, launches)
    read = _readers(tiny_root)
    assert read["probe_launches"](_view()) is None
    if not events or not events["queries"]:
        assert read["probe_rounds"](_view()) is None
        assert read["host_syncs"](_view()) is None


@pytest.mark.parametrize("cell", ["uniform_128Mx128M.agg", "uniform_128Mx128M.mat"])
def test_a_traced_cpu_run_reads_what_its_sources_allow(tiny_root, cell):
    before = {}
    for dirpath, _, files in os.walk(os.path.join(tiny_root, "joinbench")):
        for name in files:
            with open(os.path.join(dirpath, name), "rb") as f:
                before[os.path.join(dirpath, name)] = f.read()
    line = harness.run_cell(cell, 2**31 + 7, 0.3, True, device="cpu",
                            root=tiny_root)
    assert line["correct"] is True
    metrics = line["metrics"]
    # no device on the CPU: no device time, no idle gaps, no launches
    for name in SPAN_READERS + ("probe_launches",):
        assert name not in metrics, name
    # the counters: cumulative in this process, so a mean of every run
    assert metrics["probe_rounds"]["value"] >= 1
    assert metrics["probe_rounds"]["unit"] == "rounds"
    assert metrics["host_syncs"]["value"] >= 2
    program = program_spans.load(os.path.join(tiny_root, "joinbench",
                                              harness.TRACE_FILE))
    n = line["attempted"]
    assert program.spans["tpujoin.sort"] == 2 * n
    assert program.spans["tpujoin.sort.gather"] == 2 * n
    assert program.spans["tpujoin.probe"] == program.spans["tpujoin.windows"] == n
    syncs = 4 if cell.endswith(".mat") else 2
    assert program.spans["tpujoin.sync"] == syncs * n
    assert program.spans["tpujoin.extract"] == (n if cell.endswith(".mat") else 0)
    for path, data in before.items():
        with open(path, "rb") as f:
            assert f.read() == data, path
