"""One cell: make its inputs from the seed, warm up, run the closed-loop
window, check every answer against the plain reference, and compose the
result's line.

Everything that belongs to one configuration, mix, per-layer metric or span
is a file that `BENCHMARK.json` names or that lies in the benchmark's
folders; nothing here names a cell.

* configuration `configs/<name>.json` (its `file` in `BENCHMARK.json`):
  "n_r", "n_s", "s_keys" ("uniform" or "zipf"), "zipf_z", "engine" (the
  `EngineConfig` keys it sets, none for the defaults);
* mix `mixes/<traffic>.json`: "query" (the query type's file, below),
  "clients" (1: the window is a closed loop with one client), "pairs"
  (input pairs the window alternates between), and any key its query type
  reads;
* query type `queries/<query>.py`, which defines one class:
  `__init__(cell, seed)`; `inputs(pairs, device)`, the program's arguments
  for each input pair, with whatever more it draws from the seed;
  `program(engine)` and `control(payload_bits)`, the call the window times
  and the plain reference in its place at a lower precision; `record(i,
  pair, answer)`; `judge(pairs)`, which sets `failed` and `compared` and
  returns the numbers compared, each with its limit in `limits`. A
  configuration may carry keys that only its query type reads;
* per-layer metric `metrics/<name>.py`, whose `read(view)` takes a
  `trace.LayerView` and returns a number or None;
* span `spans/<name>.json` (`trace.installed`).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from joinbench import datagen, peaks, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "icde2019_gpu_join_tpu")
TRACE_FILE = os.path.join(".cache", "trace.json")


def process_start() -> float:
    """This process's start on the `time.time()` clock, from /proc."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    mix: Dict
    chips: int
    bench: Dict
    bench_dir: str

    @property
    def rows(self) -> int:
        return int(self.config["n_r"]) + int(self.config["n_s"])

    def metrics(self, kind: str) -> List[Dict]:
        """The cell's end-to-end or per-layer metric entries."""
        return [m for m in self.bench[kind]
                if self.name in m.get("workloads", [self.name])]


def load_cell(workload: str, root: str = ROOT) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; "
                         f"have {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bench_dir = os.path.join(root, bench["paths"][0])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "mixes", w["traffic"] + ".json")) as f:
        mix = json.load(f)
    if int(mix.get("clients", 1)) != 1:
        raise ValueError(f"mix {w['traffic']!r}: the window has one client")
    return Cell(workload, config, mix, int(w["chips"]), bench, bench_dir)


# --- the run ---

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def engine_for(cell: Cell, device):
    from icde2019_gpu_join_tpu_torch.config import EngineConfig
    from icde2019_gpu_join_tpu_torch.models.joins import ClusteredJoin
    return ClusteredJoin(EngineConfig(**cell.config.get("engine", {})),
                         device=device)


def window(call: Callable, args, query, seconds: float, device) -> Dict:
    """The closed loop: one client, each query on the next input pair's
    arguments, each latency from the call to its synchronised result, until
    `seconds` have passed and every input pair has been queried. Recording
    an answer (for an output, its sums on the device) stops the window's
    clock."""
    lat: List[float] = []
    paused = 0.0
    t_start = time.perf_counter()
    with torch.profiler.record_function(trace.WINDOW):
        i = 0
        while True:
            pair = i % len(args)
            t0 = time.perf_counter()
            with torch.profiler.record_function(trace.QUERY):
                answer = call(*args[pair])
                _sync(device)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            with torch.profiler.record_function(trace.CHECK):
                query.record(i, pair, answer)
                del answer
                _sync(device)
            t2 = time.perf_counter()
            paused += t2 - t1
            i += 1
            if t2 - t_start - paused >= seconds and i >= len(args):
                break
    return {"latencies": lat, "seconds": t2 - t_start - paused,
            "stopped": paused}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device="cuda", root: str = ROOT, control_bits: Optional[int] = None,
             t_process: Optional[float] = None) -> Dict:
    """One run of a cell; returns the result's line as a dict. With
    `control_bits` the query type's control, its plain reference at that
    payload precision, stands in the program's place."""
    t_process = process_start() if t_process is None else t_process
    cell = load_cell(workload, root)
    device = torch.device(device)
    is_cuda = device.type == "cuda"
    query = query_type(cell)(cell, seed)
    marks = [("start", time.time())]
    torch.zeros(1, device=device)   # the device's context
    _sync(device)
    marks.append(("context", time.time()))
    pairs = datagen.make_pairs(cell.config, int(cell.mix["pairs"]), seed, device)
    args = query.inputs(pairs, device)
    _sync(device)
    marks.append(("inputs", time.time()))
    engine = engine_for(cell, device)
    call = query.program(engine) if control_bits is None else query.control(control_bits)
    marks.append(("program", time.time()))
    if is_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    for a in args:             # warm up every shape the window uses
        call(*a)
    _sync(device)
    marks.append(("warm_up", time.time()))
    setup_s = marks[-1][1] - t_process
    setup_parts = {name: b - a for (_, a), (name, b) in
                   zip([("process", t_process)] + marks[:-1], marks)}

    spans = trace.load_spans(cell.bench_dir) if traced else {}
    trace_path = os.path.join(cell.bench_dir, TRACE_FILE)
    if traced:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if is_cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(os.path.dirname(trace_path), exist_ok=True)
        with trace.installed(spans), torch.profiler.profile(
                activities=activities) as prof:
            win = window(call, args, query, seconds, device)
        prof.export_chrome_trace(trace_path)
        del prof
    else:
        win = window(call, args, query, seconds, device)
    peak = torch.cuda.max_memory_allocated(device) if is_cuda else 0
    del call, engine, args
    checks = query.judge(pairs)

    lat = win["latencies"]
    n = len(lat)
    e2e = {
        "join_throughput": n * cell.rows / win["seconds"] / 1e6,
        "query_p95_ms": statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
        if n > 1 else lat[0] * 1e3,
        "setup_s": setup_s,
    }
    name = torch.cuda.get_device_name(device) if is_cuda else "cpu"
    dev = {"platform": "gpu" if is_cuda else "cpu", "kind": name,
           "count": cell.chips, "memory_peak_bytes": int(peak),
           "card": peaks.card_line() if is_cuda else "cpu"}
    line = {"correct": None, "attempted": n, "failed": 0, "metrics": {},
            "device": dev}
    if traced:
        summary = trace.read(trace_path)
        view = trace.LayerView(summary, n, int(cell.config["n_r"]),
                               int(cell.config["n_s"]),
                               peaks.hbm_gbps(name) if is_cuda else None)
        for m in cell.metrics("per_layer"):
            value = _reader(cell.bench_dir, m["name"])(view)
            if value is not None:
                line["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
        dev["unattributed_ops"] = summary.unattributed
        line["breakdown"] = summary.breakdown()
    else:
        for m in cell.metrics("end_to_end"):
            line["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    line["setup_parts"] = setup_parts
    line["clock_stopped_s"] = win["stopped"]
    line["compared"] = query.compared
    line["failed"] = query.failed
    line["correct"] = bool(n > 0 and query.failed == 0 and all(
        v <= query.limits[k] for k, v in checks.items()))
    line["checks"] = {k: {"value": v, "limit": query.limits[k]}
                      for k, v in checks.items()}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded by the end of the run: {', '.join(found)}")
    return line


def _load(bench_dir: str, folder: str, name: str):
    """The module `<folder>/<name>.py` of the benchmark, loaded by path."""
    path = os.path.join(bench_dir, folder, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{folder}/{name}.py: no such file in {bench_dir}")
    spec = importlib.util.spec_from_file_location(f"joinbench.{folder}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def query_type(cell: Cell) -> type:
    """The one class that the file of the cell's query type defines."""
    module = _load(cell.bench_dir, "queries", cell.mix["query"])
    classes = [v for v in vars(module).values()
               if isinstance(v, type) and v.__module__ == module.__name__]
    if len(classes) != 1:
        raise ValueError(f"queries/{cell.mix['query']}.py defines "
                         f"{len(classes)} classes, not one")
    return classes[0]


def _reader(bench_dir: str, name: str) -> Callable:
    return _load(bench_dir, "metrics", name).read
