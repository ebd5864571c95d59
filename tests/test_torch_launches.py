"""The seam between Python and the hand kernels, on the CPU: the binder
(`ops/_build.entry`), the checked launch and the counter registry
(`ops/_launches.py`)."""

import ctypes
import importlib
import os
import re

import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu_torch.models.joins import ClusteredJoin
from icde2019_gpu_join_tpu_torch.ops import _build, _launches
from icde2019_gpu_join_tpu_torch.relation import Relation

PKG = os.path.dirname(os.path.dirname(os.path.abspath(_build.__file__)))
SEAM = os.path.join(PKG, "ops", "_build.py")


def _sources():
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _module(path: str) -> str:
    rel = os.path.relpath(path, os.path.dirname(PKG))[:-len(".py")]
    return rel.replace(os.sep, ".").removesuffix(".__init__")


# every module of the port that keeps a table of kernel launches
WRAPPERS = sorted(_module(p) for p in _sources()
                  if re.search(r"^LAUNCHES\b", open(p).read(), re.M))


def test_the_wrappers_are_found():
    assert {"icde2019_gpu_join_tpu_torch.ops.band_compare",
            "icde2019_gpu_join_tpu_torch.ops.radix_pairs",
            "icde2019_gpu_join_tpu_torch.ops.row_colsums",
            "icde2019_gpu_join_tpu_torch.ops.probe_ranges",
            "icde2019_gpu_join_tpu_torch.ops.merge",
            "icde2019_gpu_join_tpu_torch.benchmarks.experimental_sort",
            "icde2019_gpu_join_tpu_torch.benchmarks.merge_sort_bench",
            "icde2019_gpu_join_tpu_torch.benchmarks.construct_probes",
            } <= set(WRAPPERS)


@pytest.mark.parametrize("name", WRAPPERS)
def test_every_wrapper_table_is_registered(name):
    module = importlib.import_module(name)
    registered = [t for m, t in _launches.tables() if m == name]
    assert any(t is module.LAUNCHES for t in registered)
    assert _launches.snapshot().keys() >= module.LAUNCHES.keys()


def test_a_name_is_counted_in_one_table_only():
    with pytest.raises(ValueError, match="queries"):
        _launches.table("elsewhere", ("queries",))


def test_reset_and_snapshot_cover_every_registered_table():
    for name in WRAPPERS:
        importlib.import_module(name)
    saved = _launches.snapshot()
    try:
        for _, t in _launches.tables():
            for name in t:
                _launches.count(t, name, 3)
        assert _launches.snapshot() == {k: saved[k] + 3 for k in saved}
        _launches.reset()
        assert set(_launches.snapshot().values()) == {0}
    finally:
        _launches.reset()
        for _, t in _launches.tables():
            for name in t:
                _launches.count(t, name, saved[name])


def test_join_counts_hold_the_radix_pair_sort():
    """`JoinResult.counts` covers the whole registry: the radix pair sort's
    launches among them, none on the CPU, where the plain sort runs."""
    rng = np.random.default_rng(3)
    rk = torch.from_numpy(rng.permutation(1024).astype(np.int32))
    sk = torch.from_numpy(rng.integers(0, 1024, 4096).astype(np.int32))
    res = ClusteredJoin(device="cpu").aggregate(
        Relation(rk, torch.ones_like(rk)), Relation(sk, torch.ones_like(sk)))
    assert res.counts["radix_histogram"] == 0 and res.counts["radix_pass"] == 0
    assert res.counts["queries"] == 1
    assert res.counts.keys() == _launches.snapshot().keys()


class _Entry:
    """A stand-in for a bound C entry point: records its arguments and
    returns `code`."""

    def __init__(self, code: int):
        self.code, self.calls = code, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.code


@pytest.fixture
def entry(monkeypatch):
    bound = []

    def fake(code):
        fn = _Entry(code)
        monkeypatch.setattr(_build, "entry",
                            lambda *sig: bound.append(sig) or fn)
        return fn, bound
    return fake


def test_launch_binds_the_call_form_and_counts(entry):
    fn, bound = entry(0)
    counts = {"fake_kernel": 0}
    x = torch.zeros(4, dtype=torch.int32)
    _launches.launch(counts, "fake", (x, _launches.Address(4096)), 7, 8,
                     counter="fake_kernel", stream=5)
    assert bound == [("fake", 2, 2)]
    assert fn.calls == [(x.data_ptr(), 4096, 7, 8, 5)]
    assert counts == {"fake_kernel": 1}
    _launches.launch(None, "fake", (x,), 1, stream=0)
    assert counts == {"fake_kernel": 1} and fn.calls[-1] == (x.data_ptr(), 1, 0)


@pytest.mark.parametrize("context", ["", "at Launch(kind='chunks')"])
def test_launch_raises_on_a_cuda_error(entry, context):
    entry(700)
    counts = {"fake": 0}
    with pytest.raises(RuntimeError) as err:
        _launches.launch(counts, "fake", (torch.zeros(1),), 3, stream=0,
                         context=context)
    assert str(err.value) == ("tj_fake launch failed: CUDA error 700"
                              + (f" {context}" if context else ""))
    assert counts == {"fake": 0}


class _Lib:
    """A stand-in for a loaded library: every `tj_*` attribute a fresh
    object that takes argument types."""

    def __getattr__(self, name):
        fn = type("Fn", (), {})()
        setattr(self, name, fn)
        return fn


def test_binder_takes_the_common_form_or_a_spelled_out_list():
    lib = _Lib()
    fn = _build.entry("fake_common", 2, 3, lib=lib)
    assert fn is lib.tj_fake_common
    assert fn.argtypes == [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
    assert _build.entry("fake_common", 2, 3, lib=lib) is fn     # bound once
    odd = _build.entry("fake_odd", args=(ctypes.c_char_p,), returns=None,
                       lib=lib)
    assert odd.argtypes == [ctypes.c_char_p] and odd.restype is None


def test_only_the_seam_sets_argument_types():
    found = [os.path.relpath(p, PKG) for p in _sources() if p != SEAM
             and re.search(r"\b(argtypes|restype)\b", open(p).read())]
    assert found == []


# `extern "C" int tj_<name>(...)` in the kernel sources
_DECL = re.compile(r'extern "C" int tj_(\w+)\(([^)]*)\)')


def _declared():
    """Each C entry point of the common form: name -> (pointers, int64
    values); the others -> None."""
    out = {}
    for src in _build.kernel_sources():
        with open(src) as f:
            for name, params in _DECL.findall(f.read()):
                kinds = ["p" if re.fullmatch(r"(const )?void\*\s*\w+", p)
                         else "i" if re.fullmatch(r"int64_t\s+\w+", p) else "?"
                         for p in (q.strip() for q in params.split(","))]
                form = "".join(kinds)
                m = re.fullmatch(r"(p*)(i*)p", form)
                common = m and params.rstrip().endswith("stream")
                out[name] = (len(m.group(1)), len(m.group(2))) if common \
                    else None
    return out


def test_registered_entries_match_the_kernel_sources():
    """Every entry point a wrapper registers is declared in `csrc/` in the
    form it names, and every entry point of the common form is registered:
    the pre-binding on the card binds what the launches bind."""
    for name in WRAPPERS:
        importlib.import_module(name)
    declared = _declared()
    registered = _launches.entries()
    assert {n: declared.get(n) for n in registered} == registered
    assert {n for n, form in declared.items() if form} == set(registered)
    assert {n for n, form in declared.items() if not form} == {
        "radix_configure", "probe_form"}


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU route")
    return torch.device("cuda")


@pytest.mark.card
def test_a_refused_launch_raises_on_the_card(card):
    """A real entry point that refuses its arguments (`tj_probe_min_dma` of
    0 rows returns cudaErrorInvalidValue before it launches) raises through
    the checked launch, on the current stream of its tensors' card, and
    counts nothing."""
    o = torch.zeros(128, dtype=torch.int32, device=card)
    counts = {"probe": 0}
    with pytest.raises(RuntimeError, match=r"^tj_probe_min_dma launch failed: "
                       r"CUDA error 1$"):
        _launches.launch(counts, "probe_min_dma", (o, o, o, o), 0)
    assert counts == {"probe": 0}
