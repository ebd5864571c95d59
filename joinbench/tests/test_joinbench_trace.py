"""The trace's reading on a made-up Chrome trace, and the metric readers'
arithmetic on it."""

import importlib.util
import os

import pytest

from conftest import REPO
from joinbench import trace

MAIN, OTHER = 1, 2


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid, "args": args}


def _launch(ts, corr):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 1, correlation=corr)


def _kernel(name, ts, dur, corr=None, ext=None):
    args = {}
    if corr is not None:
        args["correlation"] = corr
    if ext is not None:
        args["External id"] = ext
    return _x("kernel", name, ts, dur, tid=7, **args)


def _events():
    """Window 0-1000 us, one query 0-800: inside it materialize 10-790, with
    a sort 20-100 and descriptors 120-300 under it. Kernels launched at 30
    (sort), 150 (descriptors), 400 and 500 (materialize itself), one whose
    launch has only an external id (at 600), one with no launch at all, and
    one launched outside the window."""
    return [
        _x("user_annotation", "joinbench.window", 0, 1000),
        _x("user_annotation", "joinbench.query", 0, 800),
        _x("user_annotation", "joinbench.banded_materialize", 10, 780),
        _x("user_annotation", "joinbench.sort_by_key", 20, 80),
        _x("user_annotation", "joinbench.banded_match_descriptors", 120, 180),
        _x("user_annotation", "joinbench.sort_by_key", 20, 80, tid=OTHER),
        _launch(30, 1), _kernel("sortk", 40, 50, corr=1),
        _launch(150, 2), _kernel("desc", 160, 100, corr=2),
        _launch(400, 3), _kernel("extract", 405, 200, corr=3),
        _launch(500, 4), _kernel("extract", 605, 100, corr=4),
        _x("cpu_op", "aten::item", 590, 20, **{"External id": 9}),
        _kernel("gather", 710, 10, ext=9),
        _kernel("orphan", 720, 5, corr=99),
        _x("cpu_op", "aten::sort", 850, 100),
        _launch(1500, 5), _kernel("late", 1500, 10, corr=5),
    ]


def test_span_chains_busy_and_gaps():
    s = trace.summarize(_events())
    assert s.window == 1000
    assert s.chains == {
        frozenset({"banded_materialize"}): 310,
        frozenset({"banded_materialize", "sort_by_key"}): 50,
        frozenset({"banded_materialize", "banded_match_descriptors"}): 100}
    assert s.unattributed == 1
    # busy: 40-90, 160-260, 405-705, 710-725
    assert s.busy == 50 + 100 + 300 + 15
    assert s.ops["extract"] == 300 and "late" not in s.ops
    assert sum(s.gaps.values()) == pytest.approx(1000 - s.busy)
    assert s.gaps["between queries:aten::sort"] == 275   # 725-1000, host in sort
    b = s.breakdown()
    assert b["device_ops"][0] == ["extract", 300e-6]
    assert len(b["idle_gaps"]) <= trace.TOP


def test_no_window_span_reads_nothing():
    s = trace.summarize([e for e in _events() if e["name"] != "joinbench.window"])
    assert s.window == 0 and s.busy == 0 and not s.chains


def test_the_check_span_is_cut_out_of_the_window():
    """A check 800-900 us, after the query: its kernel, its length and its
    idle time leave the window; the rest reads as without it."""
    plain = trace.summarize(_events())
    events = _events() + [
        _x("user_annotation", "joinbench.check", 800, 100),
        _launch(810, 6), _kernel("checksum", 820, 30, corr=6)]
    s = trace.summarize(events)
    assert s.window == 900
    assert s.busy == plain.busy and "checksum" not in s.ops
    assert s.chains == plain.chains
    assert sum(s.gaps.values()) == pytest.approx(900 - s.busy)
    assert not any(k.startswith("check") for k in s.gaps)


def test_trace_minus_cuts():
    assert trace._minus([(0, 10), (20, 30)], [(5, 22), (25, 26)]) == [
        (0, 5), (22, 25), (26, 30)]
    assert trace._minus([(0, 10)], []) == [(0, 10)]
    assert trace._minus([(0, 10)], [(0, 10)]) == []


def _reader(name):
    path = os.path.join(REPO, "joinbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_readers_on_the_made_up_trace():
    view = trace.LayerView(trace.summarize(_events()), queries=1, n_r=1 << 20,
                           n_s=1 << 20, hbm_gbps=3350.0)
    assert _reader("sort_ms")(view) == pytest.approx(0.05)
    assert _reader("probe_ms")(view) == pytest.approx(0.1)
    assert _reader("output_ms")(view) == pytest.approx(0.31)
    assert _reader("device_idle_share")(view) == pytest.approx(1 - 0.465)
    sol = 16 * (2 << 20) / 3350e9 * 1e3
    assert _reader("sort_roofline")(view) == pytest.approx(100 * sol / 0.05)
    # no banded_probe span: the probe's roofline finds nothing
    assert _reader("probe_roofline")(view) is None


def test_a_span_added_inside_the_extraction_leaves_output_ms_as_it_is():
    """A new span file for a function inside `banded_materialize` (the
    extraction, 400-720 us) moves none of the readers."""
    nested = _events() + [
        _x("user_annotation", "joinbench._extract_blocked", 395, 325)]
    views = [trace.LayerView(trace.summarize(e), queries=1, n_r=1 << 20,
                             n_s=1 << 20, hbm_gbps=3350.0)
             for e in (_events(), nested)]
    for name in ("output_ms", "sort_ms", "probe_ms", "sort_roofline"):
        assert _reader(name)(views[1]) == pytest.approx(_reader(name)(views[0]))
    assert views[1].span_ms("_extract_blocked") == pytest.approx(0.31)


@pytest.mark.parametrize("name", ["sort_ms", "sort_roofline", "probe_ms",
                                  "probe_roofline", "output_ms",
                                  "device_idle_share"])
def test_readers_return_nothing_without_device_time(name):
    view = trace.LayerView(trace.Summary(), queries=10, n_r=8, n_s=8,
                           hbm_gbps=None)
    assert _reader(name)(view) is None


def test_chains_follow_nesting():
    spans = [(0, 100, "a"), (10, 50, "b"), (20, 30, "c"), (60, 90, "d")]
    assert trace._chains([5, 25, 40, 55, 70, 95, 150], spans) == [
        ("a",), ("a", "b", "c"), ("a", "b"), ("a",), ("a", "d"), ("a",), ()]
