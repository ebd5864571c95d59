"""The port's spans and counters (utils/profiling.py, ops/_launches.py) on
the CPU: under `torch.profiler` every `ClusteredJoin` call emits the
`tpujoin.*` spans at the banded path's layer boundaries, nested as the
engine nests them; the counters agree with the schedule and with the spans;
and with no profiler recording no span is entered at all."""

import functools

import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu_torch.config import EngineConfig
from icde2019_gpu_join_tpu_torch.models import joins
from icde2019_gpu_join_tpu_torch.models.joins import ClusteredJoin
from icde2019_gpu_join_tpu_torch.ops import _launches, band_compare, band_join
from icde2019_gpu_join_tpu_torch.relation import Relation
from icde2019_gpu_join_tpu_torch.utils import profiling

N_R, N_S = 4096, 8192
# R keys repeated this often: an S block's window spans several R blocks
DUP = 300
QUERIES = ("aggregate", "count", "late_aggregate", "materialize")


def _inputs(kind: str):
    rng = np.random.default_rng(11)
    if kind == "pkfk":
        rk = rng.permutation(N_R)
        sk = rng.integers(0, N_R, N_S)
    else:
        rk = rng.permutation(np.arange(N_R) // DUP)
        sk = rng.integers(0, N_R // DUP + 1, N_S // 4)
    rp = rng.integers(-2**31, 2**31, rk.size)
    sp = rng.integers(-2**31, 2**31, sk.size)
    return tuple(torch.from_numpy(x.astype(np.int32)) for x in (rk, rp, sk, sp))


def _call(query: str, kind: str):
    """The engine call of `query` on the CPU, and its rounds as the schedule
    implies them: the length of its round histogram less one."""
    rk, rp, sk, sp = _inputs(kind)
    engine = ClusteredJoin(device="cpu")
    r, s = Relation(rk, rp), Relation(sk, sp)
    if query == "late_aggregate":
        rows_r = torch.arange(rk.numel(), dtype=torch.int32)
        rows_s = torch.arange(sk.numel(), dtype=torch.int32)
        r, s = Relation(rk, rows_r), Relation(sk, rows_s)
        call = functools.partial(engine.late_aggregate, r, s,
                                 rp.view(-1, 1), sp.view(-1, 1))
    elif query == "materialize":
        call = functools.partial(engine.materialize, r, s, capacity=1 << 20)
    else:
        call = functools.partial(getattr(engine, query), r, s)
    r_sv, _ = band_join.sort_by_key(rk, rp)
    s_sv, _ = band_join.sort_by_key(sk, sp)
    lo, hi = band_join.block_windows(r_sv, s_sv)
    hist = torch.bincount(hi - lo).tolist()    # window_blocks is 1
    return call, len(hist) - 1


def _spans(prof):
    """(name, chain of enclosing tpujoin spans, innermost first) of every
    tpujoin span, in order of start."""
    out = []
    for ev in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not ev.name.startswith("tpujoin."):
            continue
        chain, p = [], ev.cpu_parent
        while p is not None:
            if p.name.startswith("tpujoin."):
                chain.append(p.name)
            p = p.cpu_parent
        out.append((ev.name, tuple(chain)))
    return out


def _force(monkeypatch, debug_force):
    if debug_force is not None:
        monkeypatch.setattr(joins, "banded_materialize", functools.partial(
            band_join.banded_materialize, debug_force=debug_force))


CASES = ([(q, "pkfk", None) for q in QUERIES]
         + [(q, "dup", None) for q in QUERIES]
         + [("materialize", "pkfk", "fast"), ("materialize", "pkfk", "slow")])


@pytest.mark.parametrize("query,kind,debug_force", CASES)
def test_spans_nest_at_the_layer_boundaries(query, kind, debug_force,
                                            monkeypatch):
    _force(monkeypatch, debug_force)
    call, rounds = _call(query, kind)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = call()
    spans = _spans(prof)
    names = [n for n, _ in spans]
    join = ("tpujoin.join",)
    sorts = [c for n, c in spans if n == "tpujoin.sort"]
    assert sorts == [join, join]
    # the CPU's sort (`torch_sort_pairs`) opens no span inside its own
    assert [n for n, c in spans if "tpujoin.sort" in c] == []
    assert [c for n, c in spans if n == "tpujoin.probe"] == [join]
    assert [c for n, c in spans if n == "tpujoin.windows"] == [
        ("tpujoin.probe",) + join]
    syncs = [c for n, c in spans if n == "tpujoin.sync"]
    # the probe's read-back, then the read of the answer after the phase
    # (a card's phase also synchronises; the CPU's does not)
    want = [("tpujoin.probe",) + join]
    if query == "late_aggregate":
        # both sides' column sums, before the sorts; the add-mode sum after
        # its probe, outside it
        assert [c for n, c in spans if n == "tpujoin.colsums"] == [join]
        assert names.index("tpujoin.colsums") < names.index("tpujoin.sort")
        assert [c for n, c in spans if n == "tpujoin.reduce"] == [join]
        assert names.index("tpujoin.reduce") > names.index("tpujoin.probe")
    else:
        assert "tpujoin.colsums" not in names
        assert "tpujoin.reduce" not in names
    if query == "materialize":
        assert [c for n, c in spans if n == "tpujoin.extract"] == [join]
        extract = ("tpujoin.extract",) + join
        want.append(extract)                 # the total's read
        if debug_force is None and res.count <= 1 << 20:
            want.append(extract)             # the span check's read
    else:
        assert "tpujoin.extract" not in names
    want.append(())
    assert syncs == want
    assert res.counts["queries"] == 1
    assert res.counts["host_syncs"] == len(syncs)
    assert res.counts["probe_rounds"] == rounds
    assert rounds >= (2 if kind == "dup" else 1)
    # the CPU runs the kernels' plain versions: nothing is launched
    assert res.counts["banded_window_sum"] == 0


@pytest.mark.parametrize("query", QUERIES)
def test_no_span_is_entered_without_a_profiler(query, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("entered a span with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    call, rounds = _call(query, "pkfk")
    before = _launches.snapshot(_launches.EVENTS)
    res = call()
    # the counters count all the same
    assert res.counts["queries"] == 1 and res.counts["probe_rounds"] == rounds
    after = _launches.snapshot(_launches.EVENTS)
    assert {k: after[k] - before[k] for k in after} == {
        k: res.counts[k] for k in _launches.EVENTS}
    assert profiling.annotate("tpujoin.x") is profiling.annotate("tpujoin.y")


def test_annotate_records_while_a_profiler_records():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("tpujoin.outer", device="cpu"):
            with profiling.host_wait():
                torch.ones(4).sum()
    assert _spans(prof) == [("tpujoin.outer", ()),
                            ("tpujoin.sync", ("tpujoin.outer",))]


def test_counts_are_the_difference_across_the_call():
    """`JoinResult.counts` is what one call added to the cumulative tables;
    the tables are cumulative since their reset."""
    call, _ = _call("aggregate", "pkfk")
    first = call().counts
    assert call().counts == first
    tables = (_launches.EVENTS, band_compare.LAUNCHES)
    saved = _launches.snapshot(*tables)
    try:
        _launches.reset(*tables)
        call()
        call()
        now = _launches.snapshot(_launches.EVENTS)
        assert now == {k: 2 * first[k] for k in _launches.EVENTS}
    finally:
        for table in tables:
            for name in table:
                _launches.count(table, name, saved[name])


@pytest.mark.parametrize("mode", ["blocked", "sort_merge"])
def test_partitioned_late_aggregate_spans_its_column_sums(mode):
    """Off the banded path a late aggregate's column sums, at the
    partitioned row ids, are one `tpujoin.colsums` span inside its join
    phase; there is no add-mode sum."""
    call, _ = _call("late_aggregate", "pkfk")
    engine = ClusteredJoin(EngineConfig(probe_mode=mode), device="cpu")
    call = functools.partial(getattr(engine, call.func.__name__), *call.args)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
    spans = _spans(prof)
    assert [c for n, c in spans if n == "tpujoin.colsums"] == [("tpujoin.join",)]
    assert "tpujoin.reduce" not in [n for n, _ in spans]


def test_partitioned_modes_count_their_answer_reads():
    """Outside the banded path a call counts its query and its answer's
    read; its schedule walks no banded rounds."""
    rk, rp, sk, sp = _inputs("pkfk")
    engine = ClusteredJoin(EngineConfig(probe_mode="sort_merge"), device="cpu")
    counts = engine.aggregate(Relation(rk, rp), Relation(sk, sp)).counts
    assert counts["queries"] == 1 and counts["host_syncs"] == 1
    assert counts["probe_rounds"] == 0
