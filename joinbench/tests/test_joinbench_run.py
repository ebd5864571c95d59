"""A cell end to end on the CPU at a tiny scale, in a process of its own:
its last line, and what the process loaded. The look for a card is the one
step a CPU run skips (`run.report` is `run.main` past it)."""

import json
import os
import subprocess
import sys

import pytest

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "icde2019_gpu_join_tpu"}
PORT = "icde2019_gpu_join_tpu_torch"

RUN = """
import json, sys
from joinbench import run
run.report({workload!r}, {seed}, {seconds}, {traced}, device="cpu", root={root!r})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})), file=sys.stderr)
"""


def _python(code: str):
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout.strip().splitlines(), proc.stderr.strip().splitlines()


def _check_line(line: dict, bench: dict, workload: str, traced: bool):
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    dev = line["device"]
    assert dev["count"] == 1 and dev["platform"] == "cpu"
    assert isinstance(dev["memory_peak_bytes"], int)
    kind = "per_layer" if traced else "end_to_end"
    names = {m["name"]: m["unit"] for m in bench[kind]
             if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) <= set(names)
    for name, m in line["metrics"].items():
        assert m["unit"] == names[name] and isinstance(m["value"], float)
    if traced:
        assert dev["window_s"] > 0 and dev["busy_s"] == 0.0   # no device here
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    else:
        assert set(line["metrics"]) == set(names)
        assert all(m["value"] > 0 for m in line["metrics"].values())
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", ["uniform_128Mx128M.agg",
                                      "zipf1.05_512Mx512M.agg",
                                      "uniform_128Mx128M.mat"])
def test_a_cell_runs_end_to_end_and_prints_a_well_formed_last_line(
        tiny_root, bench, workload, traced):
    out, err = _python(RUN.format(workload=workload, seed=2**31 + 5,
                                  seconds=0.3, traced=traced, root=tiny_root))
    line = json.loads(out[-1])
    _check_line(line, bench, workload, traced)
    # the numbers compared, beside their limits, end standard error
    checks = [f"check {k} {v['value']} limit {v['limit']}"
              for k, v in line["checks"].items()]
    assert err[-1 - len(checks):-1] == checks
    loaded = set(json.loads(err[-1]))
    assert PORT in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    _, err = _python("import json, sys; import joinbench.reference; "
                     "print(json.dumps(sorted(sys.modules)), file=sys.stderr)")
    tops = {m.split(".")[0] for m in json.loads(err[-1])}
    assert PORT not in tops and not tops & FORBIDDEN


def test_without_a_card_the_command_fails_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "joinbench.run", "--workload",
         "uniform_128Mx128M.agg", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_without_the_program_the_command_fails_and_prints_no_result(tmp_path):
    from conftest import copy_bench
    root = copy_bench(tmp_path)
    code = (f"import sys; sys.path.insert(0, {root!r}); from joinbench import run; "
            f"run.report('uniform_128Mx128M.agg', 1, 0.1, False, device='cpu', "
            f"root={root!r})")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": root})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert PORT in proc.stderr


def test_a_query_file_that_loads_jax_fails_the_run(tmp_path):
    from conftest import copy_bench
    root = copy_bench(tmp_path)
    path = os.path.join(root, "joinbench", "queries", "aggregate.py")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write("import jax\n" + text)
    code = (f"from joinbench import run; run.report('uniform_128Mx128M.agg', 1, "
            f"0.1, False, device='cpu', root={root!r})")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "loaded by the end of the run: jax" in proc.stderr
