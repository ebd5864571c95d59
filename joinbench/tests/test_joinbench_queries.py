"""The query types `queries/aggregate.py` and `queries/materialize.py`, at a
fixed seed on the CPU: their inputs are the pairs `datagen.make_pairs`
makes, tensor for tensor, and their answers, `compared` text, checks and
control readings are pinned to what these cells read when the two classes
lived in the harness. The harness's own modules name no query type."""

import json
import os

import pytest
import torch

from conftest import REPO
from joinbench import control, datagen, harness

SEED = 2**31 + 11
CELLS = ["uniform_128Mx128M.agg", "zipf1.05_512Mx512M.agg", "uniform_128Mx128M.mat"]
MAT = "{} outputs (0 with a wrong count or size, {} with wrong pair sums)"
# three queries on pairs 0, 1, 0 at `TINY` rows a side: the program's
# answers (`None`) and the control's at 16-bit payloads; an aggregate's
# answer is its sum, an output's (count, slots, its two pair sums)
PINNED = {
    "uniform_128Mx128M.agg": {
        None: ([-2021360090, -931258872], "3 sums", 0),
        16: ([-301629914, 1661083144], "3 sums", 3)},
    "zipf1.05_512Mx512M.agg": {
        None: ([2005812556, 1563442040], "3 sums", 0),
        16: ([1539786060, -2000667784], "3 sums", 3)},
    "uniform_128Mx128M.mat": {
        None: ([(4096, 4096, (13726347954800025974, 6474822533930478795)),
                (4096, 4096, (18360922983352629235, 3207202095997541018))],
               MAT.format(3, 0), 0),
        16: ([(4096, 4096, (18441898478720573814, 1688254744423706860)),
              (4096, 4096, (1999195606087667, 1822331190522687372))],
             MAT.format(3, 3), 3)},
}


def _query(root, workload):
    cell = harness.load_cell(workload, root)
    query = harness.query_type(cell)(cell, SEED)
    pairs = datagen.make_pairs(cell.config, int(cell.mix["pairs"]), SEED, "cpu")
    return cell, query, pairs


@pytest.mark.parametrize("workload", CELLS)
def test_inputs_are_the_pairs_as_made(tiny_root, workload):
    cell, query, pairs = _query(tiny_root, workload)
    args = query.inputs(pairs, "cpu")
    again = datagen.make_pairs(cell.config, len(pairs), SEED, "cpu")
    assert len(args) == len(again) == 2
    for (r, s), (rk, rp, sk, sp) in zip(args, again):
        for got, want in ((r.keys, rk), (r.payload, rp), (s.keys, sk), (s.payload, sp)):
            assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("bits", [None, 16])
@pytest.mark.parametrize("workload", CELLS)
def test_answers_and_checks_are_pinned(tiny_root, workload, bits):
    cell, query, pairs = _query(tiny_root, workload)
    args = query.inputs(pairs, "cpu")
    call = (query.program(harness.engine_for(cell, "cpu")) if bits is None
            else query.control(bits))
    for i in range(3):
        query.record(i, i % 2, call(*args[i % 2]))
    checks = query.judge(pairs)
    answers, compared, wrong = PINNED[workload][bits]
    got = [a[1] if len(a) == 2 else a[1:] for a in query.answers]
    assert [a[0] for a in query.answers] == [0, 1, 0]
    assert got == [answers[0], answers[1], answers[0]]
    assert query.compared == compared
    assert checks == {"wrong_answers": wrong} and query.failed == wrong
    assert query.limits == {"wrong_answers": 0}


@pytest.mark.parametrize("workload", CELLS)
def test_runs_and_control_readings_are_pinned(tiny_root, workload):
    """A window of no seconds queries each of the two pairs once."""
    line = harness.run_cell(workload, SEED, 0.0, False, device="cpu",
                            root=tiny_root)
    mat = workload.endswith(".mat")
    assert line["compared"] == (MAT.format(2, 0) if mat else "2 sums")
    assert line["checks"] == {"wrong_answers": {"value": 0, "limit": 0}}
    line = harness.run_cell(workload, SEED + 3, 0.0, False, device="cpu",
                            root=tiny_root, control_bits=control.CONTROL_BITS)
    assert line["compared"] == (MAT.format(2, 2) if mat else "2 sums")
    assert line["checks"] == {"wrong_answers": {"value": 2, "limit": 0}}
    program, ctrl = control.readings(workload, [SEED + 1, 13], [SEED + 3, 15],
                                     0.0, device="cpu", root=tiny_root)
    assert control.summary(program, ctrl) == {"wrong_answers": {"lower": 0, "upper": 2}}


def test_the_harness_names_no_query_type(bench):
    queries = os.path.join(REPO, "joinbench", "queries")
    names = set()
    for file in os.listdir(queries):
        if file.endswith(".py"):
            names.add(file[:-3])
            with open(os.path.join(queries, file)) as f:
                names.update(line.split()[1].split("(")[0].rstrip(":")
                             for line in f if line.startswith("class "))
    assert {"aggregate", "materialize", "Aggregate", "Materialize"} <= names
    for module in ("harness", "control", "run", "datagen", "reference"):
        with open(os.path.join(REPO, "joinbench", module + ".py")) as f:
            text = f.read()
        assert "QUERIES" not in text, module
        for name in names:
            assert f'"{name}"' not in text and f"'{name}'" not in text, (module, name)
            assert not name[0].isupper() or name not in text, (module, name)
    for w in bench["workloads"]:
        with open(os.path.join(REPO, "joinbench", "mixes", w["traffic"] + ".json")) as f:
            assert json.load(f)["query"] in names
