"""The port's debug validators (utils/debug.py), the TPUJOIN_DEBUG hook of
its Relation, and its profiler hooks (utils/profiling.py).

The validators pass on the port's own radix_partition, sort_by_key and
block_windows output and raise on broken layouts, with the same verdict
(pass, or the same exception and message) as the JAX package's validators
on the same numpy arrays (mirrors tests/test_ops.py test_debug_validators
and test_key_domain_validator)."""

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu.relation import Relation as JaxRelation
from icde2019_gpu_join_tpu.utils import debug as jdebug
from icde2019_gpu_join_tpu_torch.ops.band_join import block_windows, sort_by_key
from icde2019_gpu_join_tpu_torch.ops.partition import radix_partition
from icde2019_gpu_join_tpu_torch.relation import Relation
from icde2019_gpu_join_tpu_torch.utils import debug as tdebug
from icde2019_gpu_join_tpu_torch.utils import profiling
from tests.conftest import make_tables


def _verdict(fn, *args):
    try:
        fn(*args)
    except (AssertionError, ValueError) as e:
        return type(e).__name__, str(e)
    return None


def _same_verdict(name, *args):
    """Port and JAX agree; returns the verdict."""
    host = [a.cpu().numpy() if isinstance(a, torch.Tensor) else a for a in args]
    got = _verdict(getattr(tdebug, name), *args)
    assert got == _verdict(getattr(jdebug, name), *host)
    return got


def _as_host(rel):
    return types.SimpleNamespace(
        keys=rel.keys.numpy().copy(), payload=rel.payload.numpy().copy(),
        counts=rel.counts.numpy().copy(), offsets=rel.offsets.numpy().copy(),
        total_bits=rel.total_bits, first_bit=rel.first_bit)


@pytest.fixture
def partitioned(rng):
    rk, rp, _, _ = make_tables(rng, n_r=2000, n_s=10, dup_build=True)
    rel = radix_partition(torch.from_numpy(rk), torch.from_numpy(rp), 5, 0)
    return rel, rk, rp


def test_partition_of_the_port_passes(partitioned):
    rel, rk, rp = partitioned
    tdebug.validate_partition(rel, rk, rp)
    assert _same_verdict("validate_partition", _as_host(rel), rk, rp) is None


def _break_counts(h):
    h.counts[0] += 1


def _break_offsets(h):
    h.offsets[1:] = h.offsets[1:][::-1].copy()


def _break_payload(h):
    h.payload[0] ^= 1


def _break_partition(h):
    first, last = h.offsets[0], h.offsets[-1] - 1   # partitions 0 and 31
    h.keys[[first, last]] = h.keys[[last, first]]


def _break_order(h):
    lo, hi = next((a, b) for a, b in zip(h.offsets[:-1], h.offsets[1:])
                  if b - a >= 2 and h.keys[a] != h.keys[b - 1])
    h.keys[[lo, hi - 1]] = h.keys[[hi - 1, lo]]


@pytest.mark.parametrize("breaker", [_break_counts, _break_offsets,
                                     _break_payload, _break_partition,
                                     _break_order],
                         ids=lambda f: f.__name__[len("_break_"):])
def test_broken_partition_raises_as_in_jax(partitioned, breaker):
    rel, rk, rp = partitioned
    h = _as_host(rel)
    breaker(h)
    verdict = _same_verdict("validate_partition", h, rk, rp)
    assert verdict is not None and verdict[0] == "AssertionError"


def test_sorted_and_windows_of_the_port_pass(rng):
    rk, rp, sk, sp = make_tables(rng, n_r=1000, n_s=3000, dup_build=True)
    r_sv, _ = sort_by_key(torch.from_numpy(rk), torch.from_numpy(rp))
    s_sv, _ = sort_by_key(torch.from_numpy(sk), torch.from_numpy(sp))
    assert _same_verdict("validate_sorted", r_sv) is None
    lo, hi = block_windows(r_sv, s_sv)
    assert _same_verdict("validate_windows", r_sv, s_sv, lo, hi) is None


def test_unsorted_and_short_windows_raise_as_in_jax(rng):
    rk, rp, sk, sp = make_tables(rng, n_r=1000, n_s=3000, dup_build=True)
    r_sv, _ = sort_by_key(torch.from_numpy(rk), torch.from_numpy(rp))
    s_sv, _ = sort_by_key(torch.from_numpy(sk), torch.from_numpy(sp))
    broken = r_sv.clone()
    broken[[3, 700]] = broken[[700, 3]]
    assert _same_verdict("validate_sorted", broken)[0] == "AssertionError"
    lo, hi = block_windows(r_sv, s_sv)
    b = int(torch.argmax(hi - lo))          # the widest window, cut by one
    short = hi.clone()
    short[b] -= 1
    verdict = _same_verdict("validate_windows", r_sv, s_sv, lo, short)
    assert verdict[0] == "AssertionError" and "window misses match" in verdict[1]


@pytest.mark.parametrize("keys,ok", [
    (np.arange(10, dtype=np.int32), True),
    (np.zeros(0, np.int32), True),
    (np.array([3, -1, 5], np.int32), False),
    (np.array([-2**31], np.int32), False)])
def test_key_domain_verdict_as_in_jax(keys, ok):
    verdict = _same_verdict("validate_key_domain", torch.from_numpy(keys))
    assert (verdict is None) == ok
    if not ok:
        assert verdict[0] == "ValueError"


def test_debug_env_makes_relation_check_keys(monkeypatch):
    bad = np.array([-5], np.int32)
    Relation(torch.from_numpy(bad))          # unchecked without the variable
    monkeypatch.setenv("TPUJOIN_DEBUG", "1")
    with pytest.raises(ValueError, match="key-domain"):
        Relation(torch.from_numpy(bad))
    with pytest.raises(ValueError, match="key-domain"):
        Relation.from_numpy(bad, device="cpu")
    with pytest.raises(ValueError, match="key-domain"):
        JaxRelation(jnp.asarray(bad))        # the JAX package reads it too
    Relation(torch.from_numpy(np.array([5], np.int32)))


def _traces(path):
    return sorted(p for p in path.rglob("*.json"))


def test_maybe_trace_writes_a_trace_into_the_tag_dir(tmp_path, monkeypatch):
    monkeypatch.delenv(profiling.ENV_VAR, raising=False)
    with profiling.maybe_trace("join", str(tmp_path), device="cpu") as prof:
        with profiling.annotate("tpujoin.test_span", device="cpu"):
            torch.ones(64).sum()
    assert prof is not None
    files = _traces(tmp_path)
    assert len(files) == 1 and files[0].parent == tmp_path / "join"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "tpujoin.test_span" for e in events)


def test_maybe_trace_reads_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv(profiling.ENV_VAR, str(tmp_path))
    with profiling.maybe_trace("env", device="cpu"):
        torch.ones(8).sum()
    assert [p.parent.name for p in _traces(tmp_path)] == ["env"]


def test_maybe_trace_without_a_directory_does_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv(profiling.ENV_VAR, raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.maybe_trace("none", device="cpu") as prof:
        torch.ones(8).sum()
    assert prof is None
    assert list(tmp_path.iterdir()) == []


def test_trace_writes_into_logdir(tmp_path):
    with profiling.trace(str(tmp_path / "t"), device="cpu"):
        torch.arange(100).cumsum(0)
    assert len(_traces(tmp_path / "t")) == 1
