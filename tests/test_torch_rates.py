"""The card's rates in the port (`utils/timing`: `detect_hbm_gbps`,
`int_ops_per_s`, the timer's roofline keys) and the three rate tools
(`benchmarks/microbench.py`, `radix_proto_bench.py`, `sortgeom_bench.py`)
on the CPU at 2^10-2^12 rows. `sortgeom_bench`'s reductions are held bit
for bit against the repository's `benchmarks/sortgeom_bench.py`, loaded by
path; its sorts are fed permutations, since an unstable sort may order the
payloads of equal keys differently in the two packages."""

import contextlib
import importlib.util
import io
import json
import os
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu.utils import timing as jtiming
from icde2019_gpu_join_tpu_torch.benchmarks import (microbench,
                                                    radix_proto_bench,
                                                    sortgeom_bench)
from icde2019_gpu_join_tpu_torch.utils import timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "icde2019_gpu_join_tpu_torch")


def _load_jax_sortgeom():
    spec = importlib.util.spec_from_file_location(
        "jax_sortgeom_bench", os.path.join(REPO, "benchmarks",
                                           "sortgeom_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jsg():
    return _load_jax_sortgeom()


def _main(tool, argv):
    """(exit code, the JSON lines, the last line) of `tool.main` on the
    CPU."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tool.main(argv + ["--device", "cpu"])
    lines = out.getvalue().splitlines()
    return rc, [json.loads(line) for line in lines[:-1]], lines[-1]


# ---- the tools ------------------------------------------------------------

MICRO_BYTES = {"sort3": 24, "sort2": 16, "take": 8, "scatter_set": 8,
               "hist_bincount_8k": 4, "hist_bincount_32": 4,
               "hist_onehot_256": 4, "searchsorted_8k": 4, "argsort": 8,
               "copy": 8}


@pytest.mark.parametrize("lg", [10, 13])
def test_microbench_lines(lg):
    rc, lines, last = _main(microbench, [str(lg)])
    n = 1 << lg
    assert rc == 0 and last == "cpu"
    assert [line["op"] for line in lines] == list(MICRO_BYTES)[:-1] + [
        "hist_cumsum", "copy"]
    for line in lines:
        assert {"tool", "op", "n", "ms", "bytes", "gbps_effective"} <= set(line)
        assert line["n"] == n and line["ms"] > 0
        want = (n // 8192 * 8192 * 8 if line["op"] == "hist_cumsum"
                else MICRO_BYTES[line["op"]] * n)
        assert line["bytes"] == want        # the JAX script's byte counts
    by_op = {line["op"]: line for line in lines}
    assert "int64" in by_op["sort3"]["uncounted"]
    assert by_op["hist_onehot_256"]["batch_rows"] == microbench.ONEHOT_BATCH
    assert by_op["copy"]["hbm_gbps"] == 50.0
    assert by_op["copy"]["of_hbm"] == pytest.approx(
        by_op["copy"]["gbps_effective"] / 50.0)


@pytest.mark.parametrize("batch", [64, 1000, 1 << 17])
def test_onehot_hist_is_exact_in_batches(rng, batch):
    pid = torch.from_numpy(rng.randint(0, 1 << 13, 5000).astype(np.int32))
    got = microbench.onehot_hist(pid, batch)
    assert torch.equal(got, torch.bincount(pid & 255, minlength=256))


@pytest.mark.parametrize("lg", [10, 12])
def test_radix_proto_bench_lines(lg):
    rc, lines, last = _main(radix_proto_bench, [str(lg)])
    assert rc == 0 and last == "cpu"
    assert [(line["op"], line["bits"], line["chunk"]) for line in lines] == [
        ("flat_sort", None, None), ("radix_group", 3, 4096),
        ("radix_group", 5, 16384), ("radix_sort_via_grouping", 5, 4096),
        ("radix_sort_via_grouping", 5, 16384)]
    for line in lines:
        assert line["ok"] is True and line["n"] == 1 << lg
        assert line["ms"] > 0 and line["mrows_s"] > 0


def test_radix_proto_check_sees_a_changed_row(rng):
    k = torch.from_numpy(rng.randint(0, 1 << 31, 1000).astype(np.int32))
    v = torch.arange(1000, dtype=torch.int32)
    g = radix_proto_bench.radix_group(k, v, bits=3, chunk=256)
    assert radix_proto_bench.same_rows(k, v, g.keys, g.pays)
    real = int(torch.nonzero(g.keys != radix_proto_bench._SENT)[0])
    for column in (g.keys, g.pays):
        changed = column.clone()
        changed[real] += 1
        pair = (changed, g.pays) if column is g.keys else (g.keys, changed)
        assert not radix_proto_bench.same_rows(k, v, *pair)
    assert not radix_proto_bench.same_rows(k, v, g.keys[:999], g.pays[:999])


@pytest.mark.parametrize("mode,ops", [
    ("flat", ["flat sort2 unstable"]), ("seg", ["seg sort2"]),
    ("seg3", ["seg sort3"]), ("gather", ["block gather 2col"]),
    ("hist", ["onehot hist P=32"]),
    ("all", ["flat sort2 unstable", "seg sort2", "seg sort3",
             "block gather 2col", "onehot hist P=32"])])
def test_sortgeom_bench_modes(mode, ops):
    rc, lines, last = _main(sortgeom_bench, [mode, "12"])
    assert rc == 0 and last == "cpu"
    assert [line["op"] for line in lines] == ops
    for line in lines:
        assert line["ms"] > 0 and line["mrows_s"] > 0 and line["n"] == 4096
        assert isinstance(line["check"], int)
    by_op = {line["op"]: line for line in lines}
    if "seg sort2" in by_op:
        assert by_op["seg sort2"]["shape"] == [4, 1024]
    if "block gather 2col" in by_op:
        assert by_op["block gather 2col"]["gbps_moved"] > 0


def test_sortgeom_bench_segments_below_n():
    _, lines, _ = _main(sortgeom_bench, ["seg", "15"])
    assert [line["shape"] for line in lines] == [
        [32, 1024], [8, 4096], [2, 16384]]


@pytest.mark.parametrize("n,lo,hi", [
    (1000, 0, 1 << 30),                  # stride 1
    (3 << 12, 0, 1 << 30),               # stride 3
    (1 << 14, -(2**31), 2**31)])         # 31 k and the sum wrap int32
def test_order_dep_equals_jax(jsg, rng, n, lo, hi):
    k = rng.randint(lo, hi, n, dtype=np.int64).astype(np.int32)
    v = rng.randint(lo, hi, n, dtype=np.int64).astype(np.int32)
    got = sortgeom_bench.order_dep(torch.from_numpy(k), torch.from_numpy(v))
    assert got.dtype == torch.int32
    assert int(got) == int(jsg.order_dep(jnp.asarray(k), jnp.asarray(v)))


@pytest.mark.parametrize("shape", [(1 << 12,), (4, 1 << 10), (16, 256)])
def test_sorts_equal_jax_on_permutations(jsg, rng, shape):
    n = int(np.prod(shape))
    dim = len(shape) - 1
    k = rng.permutation(n).astype(np.int32).reshape(shape)
    i = rng.randint(0, 1 << 30, n).astype(np.int32).reshape(shape)
    v = rng.randint(-(2**31), 2**31, n, dtype=np.int64).astype(
        np.int32).reshape(shape)
    tk, ti, tv = (torch.from_numpy(x) for x in (k, i, v))
    jk, ji, jv = (jnp.asarray(x) for x in (k, i, v))
    assert int(sortgeom_bench.sort2(tk, tv, dim)) == int(jsg.sort2(jk, jv, dim))
    assert int(sortgeom_bench.sort3(tk, ti, tv, dim)) == int(
        jsg.sort3(jk, ji, jv, dim))


def test_gather2_equals_jax(jsg, rng):
    nb = 64
    kb = rng.randint(-(2**31), 2**31, (nb, 128), dtype=np.int64).astype(np.int32)
    vb = rng.randint(0, 1 << 30, (nb, 128)).astype(np.int32)
    bidx = rng.permutation(nb).astype(np.int32)
    got = sortgeom_bench.gather2(*(torch.from_numpy(x) for x in (kb, vb, bidx)))
    assert int(got) == int(jsg.gather2(*(jnp.asarray(x) for x in (kb, vb, bidx))))


@pytest.mark.parametrize("rows", [1, 8, 64])
def test_hist32_equals_jax(jsg, rng, rows):
    pid = (rng.randint(0, 1 << 30, (rows, 1024)) & 31).astype(np.int32)
    got = sortgeom_bench.hist32(torch.from_numpy(pid))
    assert got.dtype == torch.int32
    assert int(got) == int(jsg.hist32(jnp.asarray(pid)))


# ---- the card's rates -------------------------------------------------------

def test_detect_hbm_gbps_on_the_cpu_equals_jax():
    assert timing.detect_hbm_gbps("cpu") == 50.0 == jtiming.detect_hbm_gbps()
    assert timing.detect_hbm_gbps(torch.device("cpu")) == 50.0


@pytest.mark.parametrize("name,gbps", [
    ("NVIDIA H100 80GB HBM3", 3350.0), ("NVIDIA H100 SXM5 80GB", 3350.0),
    ("NVIDIA H100 PCIe", 2000.0), ("NVIDIA H100 NVL", 3900.0)])
@pytest.mark.parametrize("device", [None, "cuda", "cuda:1"])
def test_detect_hbm_gbps_looks_the_card_up_by_name(monkeypatch, name, gbps,
                                                   device):
    asked = []

    def get_name(index):
        asked.append(index)
        return name

    monkeypatch.setattr(torch.cuda, "get_device_name", get_name)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(timing, "_copy_gbps",
                        lambda index: pytest.fail("a copy ran for a known card"))
    assert timing.detect_hbm_gbps(device) == gbps
    assert asked == [1 if device == "cuda:1" else 0]
    assert timing.datasheet_hbm_gbps(name) == gbps


def test_detect_hbm_gbps_measures_an_unknown_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda index: "NVIDIA A100-SXM4-80GB")
    monkeypatch.setattr(timing, "_copy_gbps", lambda index: 1000.0 + index)
    assert timing.detect_hbm_gbps("cuda:0") == 1000.0
    assert timing.detect_hbm_gbps("cuda:2") == 1002.0
    assert timing.datasheet_hbm_gbps("NVIDIA A100-SXM4-80GB") is None


def test_int_ops_per_s(monkeypatch):
    ran = []

    def smi(cmd, **kw):
        ran.append(cmd)
        return types.SimpleNamespace(stdout="1980\n1755\n")

    monkeypatch.setattr(timing.subprocess, "run", smi)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: types.SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert timing.int_ops_per_s("cuda") == 132 * 128 * 1980e6
    assert timing.int_ops_per_s("cuda:1") == 132 * 128 * 1755e6
    assert ran[0][:2] == ["nvidia-smi", "--query-gpu=clocks.max.sm"]
    with pytest.raises(ValueError, match="needs a card"):
        timing.int_ops_per_s("cpu")


def _two_phases(timer):
    timer.phases += [timing.Phase("partition", 0.5, 10**9, 10**6),
                     timing.Phase("join", 0.25, 2 * 10**9, 10**6),
                     timing.Phase("join", 0.25, 0, 10**6)]
    return timer


def test_timer_report_keys_equal_jax():
    got = _two_phases(timing.PhaseTimer()).report({"result": 3})
    want = _two_phases(jtiming.PhaseTimer()).report({"result": 3})
    assert got == want          # the CPU: 50.0 GB/s in both
    assert got["hbm_gbps"] == 50.0
    assert got["phases"]["join"]["roofline_frac"] == pytest.approx(4.0 / 50.0)


def test_timer_report_reads_the_card_it_synchronised(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda index: "NVIDIA H100 80GB HBM3")
    timer = _two_phases(timing.PhaseTimer())
    timer.device = torch.device("cuda", 0)
    rep = timer.report()
    assert rep["hbm_gbps"] == 3350.0
    assert rep["phases"]["partition"]["roofline_frac"] == pytest.approx(
        2.0 / 3350.0)


TPU_FIGURES = re.compile(r"\bVPU_OPS\b|\bMEASURED_SORT_ROWS_S\b"
                         r"|(?<![\d.])(3e12|356\.8e6|819\.0)\b")


def test_no_tpu_rate_in_the_port():
    """The TPU's figures (`bench.py`'s VPU rate and sort rate, the JAX
    timer's 819 GB/s fallback) never reach the port or `chip_smoke.py`."""
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert TPU_FIGURES.search("VPU_OPS = 3e12") and not TPU_FIGURES.search(
        "1.673e12 8192.0")
    for path in sources:
        with open(path) as f:
            assert not TPU_FIGURES.search(f.read()), path
