"""Tests of the benchmark itself. Most run on the CPU at a tiny scale, on a
copy of the benchmark whose configurations are cut to `TINY` rows a side;
those marked `card` need a CUDA card and skip without one.

    python -m pytest joinbench/tests -q
"""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY = 1 << 12


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on the CPU")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present; decided when the test runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def copy_bench(dst, rows: int = TINY) -> str:
    """A copy of BENCHMARK.json and the benchmark's folder under `dst`, every
    configuration cut to `rows` a side; returns the copy's root."""
    root = str(dst)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for path in bench["paths"]:
        shutil.copytree(os.path.join(REPO, path), os.path.join(root, path),
                        ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    for conf in bench["configs"]:
        path = os.path.join(root, conf["file"])
        with open(path) as f:
            config = json.load(f)
        config["n_r"] = config["n_s"] = rows
        with open(path, "w") as f:
            json.dump(config, f)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return copy_bench(tmp_path)


@pytest.fixture
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)
