"""One cell: make its inputs from the seed, warm up, run the closed-loop
window, check every answer against the plain reference, and compose the
result's line.

Everything that belongs to one configuration, mix, per-layer metric or span
is a file that `BENCHMARK.json` names or that lies in the benchmark's
folders; nothing here names a cell.

* configuration `configs/<name>.json` (its `file` in `BENCHMARK.json`):
  "n_r", "n_s", "s_keys" ("uniform" or "zipf"), "zipf_z", "engine" (the
  `EngineConfig` keys it sets, none for the defaults);
* mix `mixes/<traffic>.json`: "query" ("aggregate" or "materialize"),
  "clients" (1: the window is a closed loop with one client), "pairs"
  (input pairs the window alternates between), "capacity_per_s_row"
  (materialize: ring slots per S row);
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

from joinbench import datagen, peaks, reference, trace

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


# --- query types: the program's call, the reference's answer, the check ---

def _relations(pairs):
    from icde2019_gpu_join_tpu_torch.relation import Relation
    return [(Relation(rk, rp), Relation(sk, sp)) for rk, rp, sk, sp in pairs]


class Aggregate:
    """SUM(Pr * Ps) mod 2^32: every query's answer is compared."""

    def __init__(self, cell: Cell, seed: int):
        self.answers: List[tuple] = []
        self.failed = 0

    def program(self, engine) -> Callable:
        return lambda r, s: engine.aggregate(r, s).aggregate

    def control(self, payload_bits: int) -> Callable:
        return lambda r, s: reference.aggregate(r.keys, r.payload, s.keys,
                                                s.payload, payload_bits)

    def record(self, i: int, pair: int, answer) -> None:
        self.answers.append((pair, answer))

    def judge(self, pairs) -> Dict[str, int]:
        expect = [reference.aggregate(*p) for p in pairs]
        self.failed = sum(a != expect[p] for p, a in self.answers)
        self.compared = f"{len(self.answers)} sums"
        return {"wrong_answers": self.failed}


class Materialize:
    """Matched (Pr, Ps) pairs into a ring of capacity slots. Every query's
    output is compared whole, as a multiset of its slots' pairs, the empty
    slots as (0, 0): its count, its number of slots and its two sums
    (`reference.checksum`), taken on the device as the answer is recorded,
    outside the window's clock."""

    def __init__(self, cell: Cell, seed: int):
        self.capacity = int(cell.mix["capacity_per_s_row"] * cell.config["n_s"])
        self.answers: List[tuple] = []
        self.failed = 0

    def program(self, engine) -> Callable:
        def call(r, s):
            res = engine.materialize(r, s, capacity=self.capacity)
            return res.count, res.pairs
        return call

    def control(self, payload_bits: int) -> Callable:
        def call(r, s):
            n, packed = reference.pairs(r.keys, r.payload, s.keys, s.payload,
                                        payload_bits)
            out = torch.zeros(self.capacity, dtype=torch.int64,
                              device=packed.device)
            out[:n] = packed[:self.capacity]
            return n, ((out >> 32).to(torch.int32), out.to(torch.int32))
        return call

    def record(self, i: int, pair: int, answer) -> None:
        count, (out_r, out_s) = answer
        self.answers.append((pair, int(count), int(out_r.shape[0]),
                             reference.checksum(out_r, out_s)))

    def judge(self, pairs) -> Dict[str, int]:
        expect = []
        for rk, rp, sk, sp in pairs:
            n, packed = reference.pairs(rk, rp, sk, sp)
            if n > self.capacity:
                raise ValueError("the pairs check needs the join's output to "
                                 "fit the ring: a lap overwrites matches")
            want = torch.zeros(self.capacity, dtype=torch.int64,
                               device=packed.device)
            want[:n] = packed
            del packed
            expect.append((n, self.capacity, reference.fold(want)))
            del want
        counts = sum(a[1:3] != expect[a[0]][:2] for a in self.answers)
        sums = sum(a[3] != expect[a[0]][2] for a in self.answers)
        self.failed = sum(a[1:] != expect[a[0]] for a in self.answers)
        self.compared = (f"{len(self.answers)} outputs ({counts} with a wrong "
                         f"count or size, {sums} with wrong pair sums)")
        return {"wrong_answers": self.failed}


QUERIES = {"aggregate": Aggregate, "materialize": Materialize}
# the limit of each number compared: 0, an exact comparison
LIMITS = {"wrong_answers": 0}


# --- the run ---

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def engine_for(cell: Cell, device):
    from icde2019_gpu_join_tpu_torch.config import EngineConfig
    from icde2019_gpu_join_tpu_torch.models.joins import ClusteredJoin
    return ClusteredJoin(EngineConfig(**cell.config.get("engine", {})),
                         device=device)


def window(call: Callable, rels, query, seconds: float, device) -> Dict:
    """The closed loop: one client, each query on the next input pair, each
    latency from the call to its synchronised result, until `seconds` have
    passed and every input pair has been queried. Recording an answer (for
    an output, its sums on the device) stops the window's clock."""
    lat: List[float] = []
    paused = 0.0
    t_start = time.perf_counter()
    with torch.profiler.record_function(trace.WINDOW):
        i = 0
        while True:
            pair = i % len(rels)
            t0 = time.perf_counter()
            with torch.profiler.record_function(trace.QUERY):
                answer = call(*rels[pair])
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
            if t2 - t_start - paused >= seconds and i >= len(rels):
                break
    return {"latencies": lat, "seconds": t2 - t_start - paused,
            "stopped": paused}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device="cuda", root: str = ROOT, control_bits: Optional[int] = None,
             t_process: Optional[float] = None) -> Dict:
    """One run of a cell; returns the result's line as a dict. With
    `control_bits` the reference at that payload precision stands in the
    program's place (the control)."""
    t_process = process_start() if t_process is None else t_process
    cell = load_cell(workload, root)
    device = torch.device(device)
    is_cuda = device.type == "cuda"
    query = QUERIES[cell.mix["query"]](cell, seed)
    marks = [("start", time.time())]
    torch.zeros(1, device=device)   # the device's context
    _sync(device)
    marks.append(("context", time.time()))
    pairs = datagen.make_pairs(cell.config, int(cell.mix["pairs"]), seed, device)
    _sync(device)
    marks.append(("inputs", time.time()))
    rels = _relations(pairs)
    engine = engine_for(cell, device)
    call = query.program(engine) if control_bits is None else query.control(control_bits)
    marks.append(("program", time.time()))
    if is_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    for r, s in rels:          # warm up every shape the window uses
        call(r, s)
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
            win = window(call, rels, query, seconds, device)
        prof.export_chrome_trace(trace_path)
        del prof
    else:
        win = window(call, rels, query, seconds, device)
    peak = torch.cuda.max_memory_allocated(device) if is_cuda else 0
    del call, engine, rels
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
        v <= LIMITS[k] for k, v in checks.items()))
    line["checks"] = {k: {"value": v, "limit": LIMITS[k]} for k, v in checks.items()}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded by the end of the run: {', '.join(found)}")
    return line


def _reader(bench_dir: str, name: str) -> Callable:
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"joinbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
