"""The port's ops/band_compare.py against the JAX Pallas kernel, which runs
here in interpret mode as tests/test_band_join.py runs it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu.ops.band_compare_pallas import banded_compare_sum as jax_sum
from icde2019_gpu_join_tpu_torch.ops import band_compare


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
    before = band_compare.LAUNCHES
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
