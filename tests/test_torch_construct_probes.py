"""The plain versions of the port's construct probes
(benchmarks/construct_probes.py of the port) against the jnp functions the
reference's probes (benchmarks/mosaic_bisect.py) are made of. The reference's
probe bodies are closures inside kernels that were only ever compiled, so each
plain version is held against `merge_pallas._cx`, `_cx_rows`,
`_bitonic_merge_pairs` and `_mask_windows`, called directly on the CPU and
composed as the probe composes them, key + payload outputs included, on
seeded random blocks of the probes' shapes. Integers: no tolerance. On CPU
tensors the port's constructs run their plain versions."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu.ops import merge_pallas as mp
from icde2019_gpu_join_tpu_torch.benchmarks import construct_probes as cp
from icde2019_gpu_join_tpu_torch.ops import merge

S = 2 * cp.WROW   # rows of a full block, as in the reference's probes


def _blocks(rows, count, seed):
    return [b.numpy() for b in cp._blocks(rows, count, "cpu", seed)]


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _equal(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_blocks_hold_duplicates_and_both_extremes_of_sign():
    a, = _blocks(S, 1, seed=0)
    assert a.dtype == np.int32 and a.shape == (S, 128)
    assert np.unique(a).size < a.size and a.min() < -2**30 and a.max() > 2**30


@pytest.mark.parametrize("d", [64, 16, 1, 128, 2048])
def test_stage(d):
    a, b = _blocks(S, 2, seed=d)
    sv, pv = mp._cx(jnp.asarray(a), jnp.asarray(b), d)
    _equal(cp.stage(*_t(a, b), d), sv + pv)


def test_concat_only():
    a, b = _blocks(cp.WROW, 2, seed=1)
    _equal(cp.concat_only(*_t(a, b)),
           jnp.concatenate([jnp.asarray(a), jnp.asarray(b)], axis=0))


def test_concat_merge():
    """The reference's grid of 2: block t takes rows [64 t, 64 t + 64) of
    both operands and writes rows [128 t, 128 t + 128)."""
    a, b = _blocks(S, 2, seed=2)
    want = []
    for t in range(2):
        at, bt = (jnp.asarray(x[t * cp.WROW:(t + 1) * cp.WROW]) for x in (a, b))
        sv = jnp.concatenate([at, bt], axis=0)
        pv = jnp.concatenate([bt, at], axis=0)
        sv, pv = mp._bitonic_merge_pairs(sv, pv, S * 128 // 2)
        want.append(sv + pv)
    _equal(cp.concat_merge(*_t(a, b)), jnp.concatenate(want, axis=0))


def test_sublane_ladder():
    a, b = _blocks(S, 2, seed=3)
    sv, pv = jnp.asarray(a), jnp.asarray(b)
    d = S * 128 // 2
    while d >= 128:
        sv, pv = mp._cx(sv, pv, d)
        d //= 2
    _equal(cp.sublane_ladder(*_t(a, b)), sv + pv)


def test_dirmask_stage():
    a, b = _blocks(S, 2, seed=4)
    dm = jnp.arange(S, dtype=jnp.int32)[:, None] & 1
    sv, pv = mp._cx(jnp.asarray(a), jnp.asarray(b), 128, dm)
    _equal(cp.dirmask_stage(*_t(a, b)), sv + pv)
    # at distance 128 the lower element's row is always even, so the row
    # parity flips nothing there; below and above it does
    assert torch.equal(cp.dirmask_stage(*_t(a, b)), cp.stage(*_t(a, b), 128))
    assert not torch.equal(cp.merge_T_dm(*_t(a, b)), cp.full_merge_T(*_t(a, b)))


def test_transpose_only():
    a, = _blocks(S, 1, seed=5)
    a[0, 0] = np.iinfo(np.int32).max     # + 1 wraps
    _equal(cp.transpose_only(*_t(a)), jnp.asarray(a).T.T + 1)


def test_lane_ladder_T():
    a, b = _blocks(S, 2, seed=6)
    svT, pvT = jnp.asarray(a).T, jnp.asarray(b).T
    d = 64
    while d >= 1:
        svT, pvT = mp._cx_rows(svT, pvT, d)
        d //= 2
    _equal(cp.lane_ladder_T(*_t(a, b)), svT.T + pvT.T)


@pytest.mark.parametrize("lane_transpose", [True, False])
@pytest.mark.parametrize("dm", [False, True])
def test_full_merge_T_and_merge_T_dm(dm, lane_transpose):
    """Both formulations of the small stages give the same arrays; the
    plain version stands for both."""
    a, b = _blocks(S, 2, seed=7 + dm)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    mask = jnp.arange(2 * S, dtype=jnp.int32)[:, None] & 1 if dm else None
    sv = jnp.concatenate([ja, jb], axis=0)
    pv = jnp.concatenate([jb, ja], axis=0)
    sv, pv = mp._bitonic_merge_pairs(sv, pv, S * 128, dm=mask,
                                     lane_transpose=lane_transpose)
    fn = cp.merge_T_dm if dm else cp.full_merge_T
    _equal(fn(*_t(a, b)), sv[:S] + pv[S:])


class _Meta:
    """Stands for the kernel's `meta_ref`: indexed as [row, tile]."""

    def __init__(self, table):
        self.table = table

    def __getitem__(self, at):
        return int(self.table[at])


def _merge_path_inputs(seed):
    sv, _ = cp._encoded_runs(4 * cp.WINDOW, cp.WINDOW, "cpu", seed)
    x = sv.view(4 * cp.WROW, 128)
    meta = np.array([[0, 3 * cp.WROW], [cp.WROW, 2 * cp.WROW], [0, 1000],
                     [cp.WINDOW, 7000], [128, 0], [cp.WINDOW, 5000],
                     [0, 2 * cp.WROW]], np.int32)
    return torch.from_numpy(meta), x


def test_min_dma_compute():
    meta, x = _merge_path_inputs(seed=8)
    xj = jnp.asarray(x.numpy())
    want = np.zeros(x.shape, np.int32)
    for t in range(2):
        a_row, b_row, out_row = (int(meta[k, t]) for k in (0, 1, 6))
        abuf, bbuf = xj[a_row:a_row + cp.WROW], xj[b_row:b_row + cp.WROW]
        a, b = mp._mask_windows(abuf, bbuf, _Meta(meta.numpy()), t, cp.WINDOW)
        sv = jnp.concatenate([a, b], axis=0)
        pv = jnp.concatenate([abuf, bbuf], axis=0)
        sv, pv = mp._bitonic_merge_pairs(sv, pv, cp.WINDOW)
        want[out_row:out_row + cp.WROW] = np.asarray(sv + pv)[:cp.WROW]
    _equal(cp.min_dma_compute(meta, x), want)
    # only the two tiles' output rows are written
    got = cp.min_dma_compute(meta, x).numpy()
    assert (got[cp.WROW:2 * cp.WROW] == 0).all()


def test_min_dma():
    x, = _t(*_blocks(4 * cp.WROW, 1, seed=9))
    meta = torch.tensor([[8, 0], [136, 0]], dtype=torch.int32)
    got = cp.min_dma(meta, x).numpy()
    want = np.zeros_like(got)
    for r0 in (8, 136):
        want[r0:r0 + cp.WROW] = x.numpy()[r0:r0 + cp.WROW]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["dtype", "rows", "strided", "meta", "d"])
def test_constructs_reject_bad_inputs(case):
    a, b = _t(*_blocks(S, 2, seed=10))
    with pytest.raises(ValueError):
        if case == "dtype":
            cp.sublane_ladder(a.long(), b.long())
        elif case == "rows":
            cp.sublane_ladder(a[:64], b[:64])
        elif case == "strided":
            cp.transpose_only(a.t())
        elif case == "meta":
            cp.min_dma_compute(torch.zeros((2, 7), dtype=torch.int32), a)
        else:
            cp.stage(a, b, 3)


def test_ladder_is_the_references_in_order():
    assert [name for name, _ in cp.PROBES] == [
        "transpose_only", "merge_T_dm", "vmem_lt_1", "vmem_lt_param",
        "lane_ladder_T", "full_merge_T", "concat_only", "lane_64", "lane_16",
        "lane_1", "sublane_ladder", "dirmask_stage", "concat_merge",
        "vmem_one_level", "vmem", "vmem_lt", "min_dma", "min_dma_compute",
        "hbm", "hbm_db"]
    assert set(cp.CONSTRUCTS) < {name for name, _ in cp.PROBES}


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_main_runs_the_whole_ladder(capsys):
    assert cp.main(["--device", "cpu"]) == 0
    lines = _lines(capsys)
    assert [line["probe"] for line in lines] == [name for name, _ in cp.PROBES]
    assert all(line["ok"] and line["ms"] > 0 for line in lines)
    assert cp.LAUNCHES == {"construct_probes": 0}
    assert merge.LAUNCHES == {"merge_levels_vmem": 0, "merge_level_plan": 0,
                              "merge_level_hbm": 0}


def test_main_takes_probe_names_and_a_geometry(capsys):
    assert cp.main(["--device", "cpu", "vmem_lt_param", "lane_1", "--run", "10",
                    "--levels", "2", "--tile", "13"]) == 0
    param, lane = _lines(capsys)
    assert (param["probe"], param["run"], param["levels"], param["tile"]) == (
        "vmem_lt_param", 1024, 2, 8192)
    assert lane["probe"] == "lane_1"
    with pytest.raises(SystemExit):
        cp.main(["--device", "cpu", "no_such_probe"])


def test_a_failing_probe_is_reported_and_fails_main(capsys, monkeypatch):
    def broken(*_, **__):
        raise AssertionError("the construct differs from its plain version")
    monkeypatch.setattr(cp, "stage_ref", broken)
    assert cp.main(["--device", "cpu", "lane_16", "lane_1", "concat_only"]) == 1
    lines = _lines(capsys)
    assert [line["ok"] for line in lines] == [True, False, False]
    assert "differs" in lines[1]["error"]


def test_a_geometry_that_does_not_fit_is_reported_not_failed(capsys):
    """Tile below the output run: the wrapper's ValueError is in the line;
    past a block's 2^14 pairs it was not expected to fit."""
    assert cp.main(["--device", "cpu", "vmem_lt_param", "--run", "14",
                    "--levels", "1", "--tile", "14"]) == 0
    line, = _lines(capsys)
    assert not line["ok"] and not line["expected_to_fit"]
    assert "run_len << levels" in line["error"]
    assert cp.main(["--device", "cpu", "vmem_lt_param", "--run", "12",
                    "--levels", "1", "--tile", "12"]) == 1
    line, = _lines(capsys)
    assert not line["ok"] and line["expected_to_fit"]
