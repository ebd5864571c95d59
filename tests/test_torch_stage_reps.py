"""The port's stage microbenchmark kernel (benchmarks/merge_sort_bench.py of
the port, `stage_reps`) against the JAX one (benchmarks/merge_sort_bench.py),
whose Pallas kernel runs here under `pltpu.force_tpu_interpret_mode()`.
Integers throughout: keys and payloads element for element, no tolerance.
On CPU tensors the port runs its plain version."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from icde2019_gpu_join_tpu_torch.benchmarks import merge_sort_bench as msb

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_reference():
    # the repository's benchmarks/ is a directory of scripts, not a package
    spec = importlib.util.spec_from_file_location(
        "reference_merge_sort_bench",
        os.path.join(_REPO, "benchmarks", "merge_sort_bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _load_reference()


def _inputs(n, seed, lo=-2**31, hi=2**31):
    rng = np.random.RandomState(seed)
    return (rng.randint(lo, hi, n, dtype=np.int64).astype(np.int32),
            rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32))


def _jax(sv, pv, d, reps, tile):
    with pltpu.force_tpu_interpret_mode():
        out = REF.stage_reps(jnp.asarray(sv), jnp.asarray(pv), d, reps, tile)
    return tuple(np.asarray(x) for x in out)


def _port(sv, pv, d, reps, tile):
    out = msb.stage_reps(torch.from_numpy(sv), torch.from_numpy(pv), d, reps,
                         tile)
    return tuple(x.numpy() for x in out)


@pytest.mark.parametrize("reps", [1, 3])
@pytest.mark.parametrize("d", [1, 16, 64, 128, 1024])
def test_stage_reps_matches_jax(d, reps):
    sv, pv = _inputs(4096, seed=d + reps)
    got, want = _port(sv, pv, d, reps, 2048), _jax(sv, pv, d, reps, 2048)
    assert got[0].shape == want[0].shape == (4096 // 128, 128)
    np.testing.assert_array_equal(got[0], want[0], err_msg="keys")
    np.testing.assert_array_equal(got[1], want[1], err_msg="payloads")


@pytest.mark.parametrize("d,tile,tiles", [(8, 1024, 4), (512, 1024, 3),
                                          (128, 256, 8)])
def test_duplicate_keys_and_several_tiles(d, tile, tiles):
    """Strict <: equal keys stay put, so their payloads do too."""
    sv, pv = _inputs(tile * tiles, seed=d, lo=0, hi=4)
    got, want = _port(sv, pv, d, 2, tile), _jax(sv, pv, d, 2, tile)
    np.testing.assert_array_equal(got[0], want[0], err_msg="keys")
    np.testing.assert_array_equal(got[1], want[1], err_msg="payloads")
    flat = sv.reshape(-1, 2, d)
    same = np.broadcast_to((flat[:, 0] == flat[:, 1])[:, None], flat.shape)
    np.testing.assert_array_equal(got[1].reshape(-1)[same.reshape(-1)],
                                  pv[same.reshape(-1)])


def test_a_stage_is_idempotent():
    sv, pv = _inputs(8192, seed=2)
    one, many = _port(sv, pv, 256, 1, 4096), _port(sv, pv, 256, 24, 4096)
    np.testing.assert_array_equal(one[0], many[0])
    np.testing.assert_array_equal(one[1], many[1])
    # min below, max above, in every group
    k = one[0].reshape(-1, 2, 256)
    assert (k[:, 0] <= k[:, 1]).all()


def test_wrapper_on_cpu_is_the_plain_version():
    sv, pv = (torch.from_numpy(a) for a in _inputs(4096, seed=4))
    for got, want in zip(msb.stage_reps(sv, pv, 32, 2, 1024),
                         msb.stage_reps_ref(sv, pv, 32, 2, 1024)):
        assert torch.equal(got, want)
    assert msb.LAUNCHES == {"stage_reps": 0}


@pytest.mark.parametrize("d,reps,tile,n", [
    (3, 1, 1024, 4096),      # d not a power of two
    (1024, 1, 1024, 4096),   # 2 * d > tile
    (16, 0, 1024, 4096),     # no reps
    (16, 1, 1000, 4000),     # tile not a power of two
    (16, 1, 64, 4096),       # tile below a row of 128
    (16, 1, 1024, 1536),     # n not a multiple of the tile
])
def test_contract_errors(d, reps, tile, n):
    sv = torch.zeros(n, dtype=torch.int32)
    with pytest.raises(ValueError):
        msb.stage_reps(sv, sv, d, reps, tile)


def test_stage_cases_are_the_references_and_the_shared_memory_ladder():
    cases = msb.stage_cases(1 << 24)
    assert cases[:4] == [("sublane_big", 1 << 17, 1 << 18),
                         ("sublane_128", 128, 1 << 18),
                         ("lane_16", 16, 1 << 18), ("lane_1", 1, 1 << 18)]
    assert cases[4:] == [("smem_sublane_big", 1 << 13, 1 << 14),
                         ("smem_sublane_128", 128, 1 << 14),
                         ("smem_lane_16", 16, 1 << 14),
                         ("smem_lane_1", 1, 1 << 14)]
    assert [msb.stage_memory(t) for _, _, t in cases] == (
        ["global"] * 4 + ["shared"] * 4)
    # a small n keeps only the stages that fit it
    assert all(2 * d <= tile <= 4096 for _, d, tile in msb.stage_cases(4096))
