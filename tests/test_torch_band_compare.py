"""The port's ops/band_compare.py against the JAX Pallas kernels, which run
here in interpret mode as tests/test_band_join.py runs them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from icde2019_gpu_join_tpu.ops import band_compare_pallas as P
from icde2019_gpu_join_tpu.ops.band_compare_pallas import banded_compare_sum as jax_sum
from icde2019_gpu_join_tpu_torch.ops import _launches, band_compare


def _inputs(rng, ch, wb, key_range, pay_lo, pay_hi):
    sk = rng.randint(0, key_range, (ch, 128)).astype(np.int32)
    rk = rng.randint(0, key_range, (ch, wb)).astype(np.int32)
    sp = rng.randint(pay_lo, pay_hi, (ch, 128), dtype=np.int64).astype(np.int32)
    rp = rng.randint(pay_lo, pay_hi, (ch, wb), dtype=np.int64).astype(np.int32)
    return sk, sp, rk, rp


@pytest.mark.parametrize("ch,wb,key_range,pay", [
    (16, 128, 50, 5),
    (16, 256, 50, 5),
    (16, 256, 8, 2**31),   # dense matches, full-range payloads: sums wrap
])
def test_ref_matches_jax_kernel(ch, wb, key_range, pay):
    arrs = _inputs(np.random.RandomState(ch + wb + key_range), ch, wb,
                   key_range, -pay, pay)
    arrs[3][3] = 0  # one row whose window payloads are all zero
    want = int(jax_sum(*map(jnp.asarray, arrs), interpret=True))
    got = band_compare.banded_compare_sum_ref(*map(torch.from_numpy, arrs))
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == want


def test_cpu_tensors_take_plain_version():
    arrs = [torch.from_numpy(a) for a in
            _inputs(np.random.RandomState(3), 8, 384, 20, -2**31, 2**31)]
    before = dict(band_compare.LAUNCHES)
    got = band_compare.banded_compare_sum(*arrs)
    assert band_compare.LAUNCHES == before
    assert int(got) == int(band_compare.banded_compare_sum_ref(*arrs))


def test_empty_chunk_is_zero():
    z = torch.zeros((0, 128), dtype=torch.int32)
    assert int(band_compare.banded_compare_sum(z, z, z, z)) == 0


@pytest.mark.parametrize("bad", ["dtype", "width", "rows", "rp_shape", "strided"])
def test_wrapper_rejects_bad_inputs(bad):
    sk, sp, rk, rp = [torch.from_numpy(a) for a in
                      _inputs(np.random.RandomState(1), 4, 128, 10, -5, 5)]
    if bad == "dtype":
        sk = sk.long()
    elif bad == "width":
        sk, sp = sk[:, :64].contiguous(), sp[:, :64].contiguous()
    elif bad == "rows":
        rk, rp = rk[:3], rp[:3]
    elif bad == "rp_shape":
        rp = torch.zeros((4, 256), dtype=torch.int32)
    else:
        rk = torch.zeros((4, 256), dtype=torch.int32)[:, ::2]
    with pytest.raises(ValueError):
        band_compare.banded_compare_sum(sk, sp, rk, rp)


def _full(rng, shape):
    return rng.randint(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


def _per_s_inputs(rng, ch=8, wb=256, key_range=12):
    """Dense matches, full-range payloads, and one row whose window holds
    only the R-pad sentinel (an empty window)."""
    sk = rng.randint(0, key_range, (ch, 128)).astype(np.int32)
    rk = rng.randint(0, key_range, (ch, wb)).astype(np.int32)
    rk[2] = 0x7FFFFFFF
    return sk, rk, _full(rng, (ch, wb))


def _first_inputs(rng, ch=8, wb=256, key_range=12):
    sk, rk, _ = _per_s_inputs(rng, ch, wb, key_range)
    gidx = rng.permutation(ch * wb).reshape(ch, wb).astype(np.int32)
    return sk, rk, gidx


def _interval_inputs(rng, ch=4, wb=256):
    """Disjoint [lo, hi) intervals per row (some empty, one row all empty),
    full-range payloads, and slots on both sides of every interval."""
    widths = rng.randint(0, 5, (ch, wb)).astype(np.int32)
    widths[1] = 0
    lo = (np.cumsum(widths, axis=1) - widths).astype(np.int32)
    hi = (lo + widths).astype(np.int32)
    pos = rng.randint(-2, int(hi.max()) + 3, (ch, 128)).astype(np.int32)
    return (pos, lo, hi, _full(rng, (ch, wb)), _full(rng, (ch, wb)),
            np.ones((ch, wb), np.int32))


def _interval_overlap_inputs(rng, ch=4, wb=256):
    """Intervals that overlap: a slot lies in several and gets their sum."""
    lo = rng.randint(-8, 40, (ch, wb)).astype(np.int32)
    hi = (lo + rng.randint(0, 12, (ch, wb))).astype(np.int32)
    pos = rng.randint(-10, 52, (ch, 128)).astype(np.int32)
    inb = (lo[:, None, :] <= pos[:, :, None]) & (pos[:, :, None] < hi[:, None, :])
    assert inb.sum(2).max() > 1
    return pos, lo, hi, _full(rng, (ch, wb)), _full(rng, (ch, wb)), _full(rng, (ch, wb))


def _interval_inverted_inputs(rng, ch=4, wb=256):
    """Half the intervals inverted (hi < lo): they hold nothing, though a
    slot may lie between hi and lo."""
    lo = rng.randint(-8, 40, (ch, wb)).astype(np.int32)
    width = rng.randint(1, 10, (ch, wb))
    hi = np.where(rng.rand(ch, wb) < 0.5, lo - width, lo + width).astype(np.int32)
    pos = rng.randint(-20, 52, (ch, 128)).astype(np.int32)
    return pos, lo, hi, _full(rng, (ch, wb)), _full(rng, (ch, wb)), _full(rng, (ch, wb))


EXTREMES = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1], np.int32)


def _interval_extreme_inputs(rng, ch=4, wb=256):
    """pos, lo and hi drawn from INT32_MIN, INT32_MAX and their neighbours:
    intervals as long as 2^32 - 1, inverted ones as far apart."""
    pick = lambda shape: EXTREMES[rng.randint(0, EXTREMES.size, shape)]
    return (pick((ch, 128)), pick((ch, wb)), pick((ch, wb)),
            _full(rng, (ch, wb)), _full(rng, (ch, wb)), _full(rng, (ch, wb)))


def _interval(make):
    return (band_compare.banded_interval_select,
            band_compare.banded_interval_select_ref,
            P.banded_interval_select, make)


KERNELS = {
    # name: (port wrapper, its plain version, JAX Pallas kernel, inputs)
    "per_s": (band_compare.banded_compare_per_s,
              band_compare.banded_compare_per_s_ref,
              P.banded_compare_per_s, _per_s_inputs),
    "first": (band_compare.banded_compare_first,
              band_compare.banded_compare_first_ref,
              P.banded_compare_first, _first_inputs),
    "interval": _interval(_interval_inputs),
    "interval_overlap": _interval(_interval_overlap_inputs),
    "interval_inverted": _interval(_interval_inverted_inputs),
    "interval_extremes": _interval(_interval_extreme_inputs),
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_plain_version_matches_jax_kernel(name):
    _, ref, pallas, make = KERNELS[name]
    arrs = make(np.random.RandomState(len(name)))
    want = pallas(*map(jnp.asarray, arrs), interpret=True)
    got = ref(*map(torch.from_numpy, arrs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_plain_version_row_steps(name, monkeypatch):
    """The plain versions walk a chunk in row steps; the step does not
    change the result."""
    _, ref, _, make = KERNELS[name]
    arrs = [torch.from_numpy(a) for a in make(np.random.RandomState(5))]
    whole = ref(*arrs)
    monkeypatch.setattr(band_compare, "_REF_ELEMS", 1)
    for g, w in zip(ref(*arrs), whole):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_cpu_tensors_take_plain_version_per_kernel(name):
    wrapper, ref, _, make = KERNELS[name]
    arrs = [torch.from_numpy(a) for a in make(np.random.RandomState(9))]
    before = dict(band_compare.LAUNCHES)
    got = wrapper(*arrs)
    assert band_compare.LAUNCHES == before
    for g, w in zip(got, ref(*arrs)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("bad", ["dtype", "lane_width", "rows", "window_shape",
                                 "strided", "device"])
def test_new_wrappers_reject_bad_inputs(name, bad):
    wrapper, _, _, make = KERNELS[name]
    arrs = [torch.from_numpy(a) for a in make(np.random.RandomState(2))]
    if bad == "dtype":
        arrs[0] = arrs[0].long()
    elif bad == "lane_width":
        arrs[0] = arrs[0][:, :64].contiguous()
    elif bad == "rows":
        arrs[1] = arrs[1][:3]
    elif bad == "window_shape":
        arrs[-1] = torch.zeros((arrs[-1].shape[0], 384), dtype=torch.int32)
    elif bad == "strided":
        arrs[1] = torch.zeros((arrs[1].shape[0], 2 * arrs[1].shape[1]),
                              dtype=torch.int32)[:, ::2]
    else:
        arrs[-1] = arrs[-1].to("meta")
    with pytest.raises(ValueError):
        wrapper(*arrs)


def test_reset_launches_zeroes_every_kernel():
    assert set(band_compare.LAUNCHES) == {
        "banded_compare_sum", "banded_compare_per_s", "banded_compare_first",
        "banded_interval_select", "banded_window_sum", "banded_window_per_s",
        "banded_window_first"}
    band_compare.LAUNCHES["banded_compare_first"] += 3
    _launches.reset()
    assert set(band_compare.LAUNCHES.values()) == {0}


# ---- the interval kernel's test on the card, modelled in numpy ---------------

def _unsigned_interval_test(pos, lo, hi):
    """`tj_banded_interval_select`'s test (csrc/band_compare.cu): one
    subtraction and one unsigned compare, (uint32)(pos - lo) < len, with
    len = hi > lo ? hi - lo : 0 computed when the row is staged."""
    pos, lo, hi = (np.asarray(x, np.int32) for x in (pos, lo, hi))
    length = np.where(hi > lo, hi.view(np.uint32) - lo.view(np.uint32),
                      np.uint32(0))
    return (pos.view(np.uint32) - lo.view(np.uint32)) < length


_I32 = st.one_of(st.sampled_from([int(x) for x in EXTREMES]),
                 st.integers(-2**31, 2**31 - 1), st.integers(-6, 6))


@settings(max_examples=400, deadline=None, database=None, derandomize=True)
@given(st.lists(st.tuples(_I32, _I32, _I32), min_size=1, max_size=64))
def test_unsigned_interval_test_is_the_signed_one(triples):
    pos, lo, hi = (np.array(x, np.int64).astype(np.int32) for x in zip(*triples))
    with np.errstate(over="ignore"):
        got = _unsigned_interval_test(pos, lo, hi)
    np.testing.assert_array_equal(got, (lo <= pos) & (pos < hi))


@pytest.mark.parametrize("make", [_interval_inputs, _interval_overlap_inputs,
                                  _interval_inverted_inputs,
                                  _interval_extreme_inputs])
def test_unsigned_interval_model_gives_the_plain_sums(make):
    """The kernel's arithmetic end to end, in numpy: the unsigned test, then
    every hit adds, mod 2^32; equal to the plain version on every input."""
    pos, lo, hi, *pays = make(np.random.RandomState(11))
    with np.errstate(over="ignore"):
        hit = _unsigned_interval_test(pos[:, :, None], lo[:, None, :],
                                      hi[:, None, :])
    want = band_compare.banded_interval_select_ref(
        *map(torch.from_numpy, (pos, lo, hi, *pays)))
    for p, w in zip(pays, want):
        got = (hit * p[:, None, :].astype(np.int64)).sum(2).astype(np.int32)
        np.testing.assert_array_equal(got, w.numpy())
