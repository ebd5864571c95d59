"""On the card: the command as the benchmark runs it, short, for each cell.

    python -m pytest joinbench/tests/test_joinbench_card.py -q   (on a card)
"""

import json
import subprocess
import sys

import pytest

from conftest import REPO


@pytest.mark.card
@pytest.mark.parametrize("workload", ["uniform_128Mx128M.agg",
                                      "zipf1.05_512Mx512M.agg",
                                      "uniform_128Mx128M.mat"])
@pytest.mark.parametrize("trace", [0, 1])
def test_the_command_is_correct_on_the_card(card, workload, trace):
    proc = subprocess.run(
        [sys.executable, "-m", "joinbench.run", "--workload", workload,
         "--seed", str(2**31 + 21), "--seconds", "2", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        for name, m in line["metrics"].items():
            if m["unit"] in ("%", "fraction"):
                assert 0 < m["value"] <= (100 if m["unit"] == "%" else 1), name
