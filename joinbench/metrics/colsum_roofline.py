"""The column sums' share of their memory roofline, in %: each extra int32
column of both sides read once, each row id read once and one int32 row
sum written, n_r * (4 * r_cols + 8) + n_s * (4 * s_cols + 8) bytes, at the
card's data-sheet memory rate, over `span_colsum_ms`. The same work
whatever implements the sums.

The widths come from the configuration, not from the program: the file of
the configuration of the cells that `BENCHMARK.json` lists for this metric
whose n_r and n_s are the run's. None where no such configuration, or two
with other widths, match."""

import json
import os

from joinbench import harness

NAME = os.path.splitext(os.path.basename(__file__))[0]


def widths(bench_dir: str, n_r: int, n_s: int):
    """(r_cols, s_cols) of this metric's configuration at n_r x n_s."""
    root = os.path.dirname(bench_dir)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    metric = next(m for m in bench["per_layer"] if m["name"] == NAME)
    configs = {c["name"]: c["file"] for c in bench["configs"]}
    found = set()
    for w in bench["workloads"]:
        if w["name"] not in metric.get("workloads", [w["name"]]):
            continue
        with open(os.path.join(root, configs[w["config"]])) as f:
            config = json.load(f)
        if int(config["n_r"]) == n_r and int(config["n_s"]) == n_s:
            found.add((int(config["r_cols"]), int(config["s_cols"])))
    return found.pop() if len(found) == 1 else None


def read(view):
    bench_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ms = harness._load(bench_dir, "metrics", "span_colsum_ms").read(view)
    cols = widths(bench_dir, view.n_r, view.n_s)
    if not ms or cols is None:
        return None
    r_cols, s_cols = cols
    bound = view.bytes_ms(view.n_r * (4 * r_cols + 8) + view.n_s * (4 * s_cols + 8))
    return 100.0 * bound / ms if bound else None
