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


# ---- the launch schedule of the card's kernel, as data ----------------------

def _network(log_tile):
    return [(k, j) for k in range(1, log_tile + 1) for j in reversed(range(k))]


@pytest.mark.parametrize("log_tile", range(10, 31))
def test_launch_schedule_covers_the_network_once_in_order(log_tile):
    launches = es.launch_schedule(log_tile)
    stages = [stage for launch in launches for stage in launch.stages()]
    assert stages == _network(log_tile)
    log_chunk = min(log_tile, es.LOG_BLOCK)
    assert launches[0] == es.Launch("chunks", 1, log_chunk, log_chunk - 1, 0,
                                    log_chunk)
    for launch in launches:
        assert launch.stages(), launch
        assert launch.log_block <= es.LOG_BLOCK
        if launch.kind == "chunks":
            assert (launch.bit_hi, launch.bit_lo) == (launch.log_block - 1, 0)
        else:
            assert launch.kind == "strided" and launch.k_lo == launch.k_hi
            bits = launch.bit_hi - launch.bit_lo + 1
            assert launch.bit_lo >= es.LOG_PASS
            assert 1 <= bits <= es.MAX_STRIDED_BITS
            assert launch.log_block == es.LOG_BLOCK
            # a segment: the neighbours a block reads of one array
            assert 1 << (launch.log_block - bits) >= 128
    # one trip through device memory a launch: 13 at the default tile
    if log_tile == 20:
        assert len(launches) == 13
        assert sum(launch.kind == "strided" for launch in launches) == 6


@pytest.mark.parametrize("log_tile", [15, 16, 19, 20, 21, 22, 27, 30])
def test_strided_blocks_partition_a_tile_and_hold_their_partners(log_tile):
    """Every strided launch of the schedule: its blocks are disjoint and
    cover the tile, each is closed under the partners of its stages, and it
    reads segments of 128 neighbours or more."""
    rng = np.random.RandomState(log_tile)
    strided = [launch for launch in es.launch_schedule(log_tile)
               if launch.kind == "strided" and launch.k_lo >= log_tile - 1]
    assert strided
    for launch in strided:
        bit_hi, bit_lo, log_block = launch[3:]
        blocks = 1 << (log_tile - log_block)
        whole = blocks <= 64
        picked = (range(blocks) if whole
                  else sorted({0, blocks - 1, *rng.randint(0, blocks, 20)}))
        seen = np.zeros(1 << log_tile, np.int8) if whole else None
        for block in picked:
            idx = es.strided_block_elements(block, bit_hi, bit_lo)
            assert idx.shape == (1 << log_block,) and idx.max() < 1 << log_tile
            assert np.unique(idx).size == idx.size
            members = set(idx.tolist())
            for j in range(bit_lo, bit_hi + 1):    # closed under every partner
                assert {i ^ (1 << j) for i in members} == members
            # segments of neighbours, 128 pairs or more, aligned
            seg = 1 << (log_block - (bit_hi - bit_lo + 1))
            runs = idx.reshape(-1, seg)
            assert seg >= 128 and (runs[:, 0] % seg == 0).all()
            np.testing.assert_array_equal(
                runs - runs[:, :1], np.broadcast_to(np.arange(seg), runs.shape))
            # local index: the segment number spells the stage bits
            np.testing.assert_array_equal((idx >> bit_lo) & (len(runs) - 1),
                                          np.arange(idx.size) // seg)
            if whole:
                seen[idx] += 1
        if whole:
            assert (seen == 1).all()


def _run_schedule(sv, pay, tile):
    """`_stage` in the schedule's grouping, each launch block by block the
    way the card runs it."""
    sv, pay = torch.from_numpy(sv).clone(), torch.from_numpy(pay).clone()
    n = sv.shape[0]
    for launch in es.launch_schedule(tile.bit_length() - 1):
        if launch.kind == "chunks":
            chunk = 1 << launch.log_block
            for base in range(0, n, chunk):
                ks, kp = sv[base:base + chunk], pay[base:base + chunk]
                for k, j in launch.stages():
                    # the direction bit of a chunk's elements: the tile's
                    flat = torch.arange(base, base + chunk) & (tile - 1)
                    ks, kp = _stage_at(ks, kp, j, k, flat)
                sv[base:base + chunk], pay[base:base + chunk] = ks, kp
        else:
            log_block = launch.log_block
            for block in range(n >> log_block):
                idx = torch.from_numpy(es.strided_block_elements(
                    block, launch.bit_hi, launch.bit_lo))
                ks, kp = sv[idx], pay[idx]
                seg_log = log_block - (launch.bit_hi - launch.bit_lo + 1)
                for k, j in launch.stages():
                    ks, kp = _stage_at(ks, kp, j - launch.bit_lo + seg_log, k,
                                       idx & (tile - 1))
                sv[idx], pay[idx] = ks, kp
    return sv.numpy(), pay.numpy()


def _stage_at(ks, kp, local_j, k, flat):
    """One stage at local distance 2^local_j over a block's elements whose
    flat indices within the tile are `flat`: the exchange of `es._stage`,
    with the direction read from bit k of the flat index."""
    d = 1 << local_j
    a, p, f = ks.view(-1, 2, d), kp.view(-1, 2, d), flat.view(-1, 2, d)
    lo, hi, plo, phi = a[:, 0], a[:, 1], p[:, 0], p[:, 1]
    ascending = ((f[:, 0] >> k) & 1) == 0
    take_lo = (hi < lo) == ascending
    take_hi = (lo < hi) != ascending
    return (torch.stack([torch.where(take_lo, hi, lo),
                         torch.where(take_hi, lo, hi)], 1).view(-1),
            torch.stack([torch.where(take_lo, phi, plo),
                         torch.where(take_hi, plo, phi)], 1).view(-1))


@pytest.mark.parametrize("tile,tiles", [(1 << 10, 3), (1 << 16, 2)])
def test_schedule_grouping_equals_the_network(tile, tiles):
    """Running the stages launch by launch and block by block, as the card
    does, is the plain version and the JAX kernel, lost payloads on equal
    keys included."""
    sv, pay = _inputs("dup16", tile * tiles, 41)
    got = _run_schedule(sv, pay, tile)
    want = es.sort_tiles_ref(torch.from_numpy(sv), torch.from_numpy(pay), tile)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    jax_out = _jax(sv, pay, tile)
    np.testing.assert_array_equal(got[0], jax_out[0])
    np.testing.assert_array_equal(got[1], jax_out[1])
