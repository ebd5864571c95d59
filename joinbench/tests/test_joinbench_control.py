"""`correct` has to fail where it should: under the control (the reference
in a lower precision in the program's place) and with the timed path
broken underneath, once for each fault a one-card join cell can have."""

import pytest
import torch

from icde2019_gpu_join_tpu_torch.models import joins
from icde2019_gpu_join_tpu_torch.relation import Relation
from joinbench import control, harness, reference

CELLS = ["uniform_128Mx128M.agg", "zipf1.05_512Mx512M.agg", "uniform_128Mx128M.mat"]


@pytest.mark.parametrize("workload", CELLS)
def test_program_reads_zero_and_the_control_fails(tiny_root, workload):
    program, ctrl = control.readings(workload, [2**31 + 1, 7, 8], [2**31 + 2, 9, 10],
                                     0.2, device="cpu", root=tiny_root)
    readings = control.summary(program, ctrl)
    assert all(r["correct"] for r in program)
    assert not any(r["correct"] for r in ctrl)
    assert all(r["lower"] == 0 for r in readings.values())
    assert any(r["upper"] > 0 for r in readings.values())


def _half(rel: Relation) -> Relation:
    n = rel.num_rows // 2
    return Relation(rel.keys[:n], rel.payload[:n])


def _stale(method):
    """The state of the first call, returned unchanged by every later one."""
    first = {}

    def call(self, r, s, *args, **kwargs):
        if "res" not in first:
            first["res"] = method(self, r, s, *args, **kwargs)
        return first["res"]
    return call


def _half_batch(method):
    """Half of S left out; the aggregate scaled up as a mean over the rest."""
    def call(self, r, s, *args, **kwargs):
        res = method(self, r, _half(s), *args, **kwargs)
        if res.aggregate is not None:
            res.aggregate = reference.to_i32(2 * res.aggregate)
        return res
    return call


def _altered(method):
    """One answer altered where it is produced."""
    def call(self, r, s, *args, **kwargs):
        res = method(self, r, s, *args, **kwargs)
        if res.aggregate is not None:
            res.aggregate = reference.to_i32(res.aggregate + 1)
        else:
            out_r, out_s = res.pairs
            out_r = out_r.clone()
            out_r[0] ^= 1
            res.pairs = (out_r, out_s)
        return res
    return call


@pytest.mark.parametrize("fault", [_stale, _half_batch, _altered])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, workload, fault):
    for name in ("aggregate", "materialize"):
        monkeypatch.setattr(joins.ClusteredJoin, name,
                            fault(getattr(joins.ClusteredJoin, name)))
    line = harness.run_cell(workload, 2**31 + 3, 0.2, False, device="cpu",
                            root=tiny_root)
    assert line["correct"] is False
    assert line["failed"] > 0
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def _swapped(method):
    """Two rows' Ps exchanged: the sums of Pr and of Ps stay as they were."""
    def call(self, r, s, *args, **kwargs):
        res = method(self, r, s, *args, **kwargs)
        out_r, out_s = res.pairs
        out_s = out_s.clone()
        out_s[0], out_s[1] = out_s[1].clone(), out_s[0].clone()
        res.pairs = (out_r, out_s)
        return res
    return call


def _late(method, at: int = 3):
    """Only the query numbered `at` (the warm-up's two first) altered."""
    calls = [0]

    def call(self, r, s, *args, **kwargs):
        res = method(self, r, s, *args, **kwargs)
        calls[0] += 1
        if calls[0] == at:
            res = _altered(lambda *a, **k: res)(self, r, s)
        return res
    return call


@pytest.mark.parametrize("fault", [_swapped, _late])
def test_every_output_is_compared_whole(tiny_root, monkeypatch, fault):
    monkeypatch.setattr(joins.ClusteredJoin, "materialize",
                        fault(joins.ClusteredJoin.materialize))
    line = harness.run_cell("uniform_128Mx128M.mat", 2**31 + 4, 0.2, False,
                            device="cpu", root=tiny_root)
    assert line["attempted"] >= 2
    want = line["attempted"] if fault is _swapped else 1
    assert line["checks"]["wrong_answers"]["value"] == want
    assert line["correct"] is False
