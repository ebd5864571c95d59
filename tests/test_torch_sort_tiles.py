"""The port's tile sort (benchmarks/experimental_sort.py) against the JAX
tile sort (benchmarks/experimental_sort_pallas.py), whose Pallas kernel
runs here in interpret mode. Integers throughout: keys and payloads are
compared element for element, no tolerance. On CPU tensors the port runs its
plain version."""

import importlib.util
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu_torch.benchmarks import experimental_sort as es

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_reference():
    # the repository's benchmarks/ is a directory of scripts, not a package
    spec = importlib.util.spec_from_file_location(
        "experimental_sort_pallas",
        os.path.join(_REPO, "benchmarks", "experimental_sort_pallas.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _load_reference()


def _keys(kind: str, n: int, rng) -> np.ndarray:
    if kind == "distinct":
        return (rng.permutation(n) - n // 2).astype(np.int32)
    if kind == "dup16":
        return rng.randint(0, 16, n).astype(np.int32)
    assert kind == "full"
    k = rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    k[rng.randint(0, n)] = np.iinfo(np.int32).min
    k[rng.randint(0, n)] = np.iinfo(np.int32).max
    return k


def _inputs(kind, n, seed):
    rng = np.random.RandomState(seed)
    return _keys(kind, n, rng), rng.permutation(n).astype(np.int32)


def _jax(sv, pay, tile, unroll=False):
    out = REF.sort_tiles(jnp.asarray(sv), jnp.asarray(pay), tile_elems=tile,
                         interpret=True, unroll=unroll)
    return tuple(np.asarray(x) for x in out)


def _port(sv, pay, tile, **kw):
    out = es.sort_tiles(torch.from_numpy(sv), torch.from_numpy(pay),
                        tile_elems=tile, **kw)
    return tuple(x.numpy() for x in out)


@pytest.mark.parametrize("kind", ["distinct", "dup16", "full"])
@pytest.mark.parametrize("tile,tiles", [(1024, 1), (1024, 3), (2048, 2),
                                        (4096, 1)])
def test_sort_tiles_matches_jax(kind, tile, tiles):
    sv, pay = _inputs(kind, tile * tiles, seed=tile + tiles)
    got, want = _port(sv, pay, tile), _jax(sv, pay, tile)
    np.testing.assert_array_equal(got[0], want[0], err_msg="keys")
    np.testing.assert_array_equal(got[1], want[1], err_msg="payloads")
    np.testing.assert_array_equal(
        got[0], np.sort(sv.reshape(tiles, tile), axis=1).reshape(-1))


def test_distinct_keys_keep_every_payload():
    sv, pay = _inputs("distinct", 2048, seed=3)
    ksv, kpay = _port(sv, pay, 1024)
    order = np.argsort(sv.reshape(2, 1024), axis=1)
    np.testing.assert_array_equal(
        kpay, np.take_along_axis(pay.reshape(2, 1024), order, 1).reshape(-1))


def test_equal_keys_lose_payloads_as_the_reference_does():
    """The element-wise exchange: on equal keys one payload is written twice
    and one is lost. The port repeats the reference's arrays exactly."""
    sv, pay = _inputs("dup16", 2048, seed=0)
    got, want = _port(sv, pay, 1024), _jax(sv, pay, 1024)
    np.testing.assert_array_equal(got[1], want[1])
    assert np.unique(got[1]).size < np.unique(pay).size
    # each surviving payload is one of a row with that key
    key_of = dict(zip(pay.tolist(), sv.tolist()))
    assert all(key_of[p] == k for k, p in zip(got[0].tolist(), got[1].tolist()))


def test_unroll_selects_nothing():
    sv, pay = _inputs("dup16", 2048, seed=5)
    a, b = _port(sv, pay, 1024, unroll=True), _port(sv, pay, 1024, unroll=False)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    j = _jax(sv, pay, 1024, unroll=True)
    np.testing.assert_array_equal(a[1], j[1])


def test_wrapper_on_cpu_is_the_plain_version():
    sv, pay = (torch.from_numpy(a) for a in _inputs("full", 4096, seed=9))
    for got, want in zip(es.sort_tiles(sv, pay, 2048),
                         es.sort_tiles_ref(sv, pay, 2048)):
        assert torch.equal(got, want)
    assert es.LAUNCHES == {"sort_tiles": 0}
    assert inspect.signature(es.sort_tiles).parameters[
        "tile_elems"].default == 1 << 20


@pytest.mark.parametrize("n,tile", [(3000, 1024), (4096, 3072), (1024, 512),
                                    (0, 1024), (1024, 2048)])
def test_contract_errors(n, tile):
    sv = torch.zeros(n, dtype=torch.int32)
    with pytest.raises(ValueError):
        es.sort_tiles(sv, sv, tile_elems=tile)


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "length"])
def test_rejects_bad_tensors(bad):
    sv = torch.zeros(2048, dtype=torch.int32)
    pay = torch.zeros(2048, dtype=torch.int32)
    if bad == "dtype":
        sv = sv.long()
    elif bad == "shape":
        sv, pay = sv.view(2, 1024), pay.view(2, 1024)
    elif bad == "strided":
        sv = torch.zeros(4096, dtype=torch.int32)[::2]
    else:
        pay = pay[:1024]
    with pytest.raises(ValueError):
        es.sort_tiles(sv, pay, tile_elems=1024)
