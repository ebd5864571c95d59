"""The port's sort tools on the CPU: `_merge_sort_cascade` under the
reference's geometry arguments against the JAX cascade (its Pallas kernels in
interpret mode) with the same arguments, and the benches and the validation
through their entry points with `device="cpu"`. Integers: no tolerance. With
distinct keys a sort has one answer, so the cascades are compared element for
element; with duplicate keys the two frameworks' unstable base sorts may order
equal keys' payloads differently, so the (key, payload) multisets are."""

import inspect
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu.ops import merge_pallas as mp
from icde2019_gpu_join_tpu_torch.benchmarks import (merge_fix_validate,
                                                     merge_sort_bench)
from icde2019_gpu_join_tpu_torch.ops import merge


def _pairs(n, seed, distinct=True):
    rng = np.random.RandomState(seed)
    if distinct:
        sv = (rng.permutation(n).astype(np.int64) * 4097 - 2**30).astype(np.int32)
    else:
        sv = rng.randint(-40, 40, n).astype(np.int32)
    return sv, rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _words(sv, pv):
    return np.sort((np.asarray(sv).astype(np.int64) << 32)
                   | (np.asarray(pv).astype(np.int64) & 0xFFFFFFFF))


GEOMETRIES = [
    (1 << 14, dict(vmem_tile=1 << 13, hbm_window=1024)),
    (1 << 15, dict(hbm_window=2048)),
    (1 << 15, dict(vmem_levels_per_call=1)),
    (1 << 16, dict(vmem_tile=1 << 13, vmem_levels_per_call=1,
                   hbm_window=2048)),
    (1 << 14, dict(vmem_tile=1 << 13, lane_transpose=False,
                   hbm_double_buffer=False)),
]


@pytest.mark.parametrize("n,geometry", GEOMETRIES,
                         ids=[f"{n}-{'-'.join(g)}" for n, g in GEOMETRIES])
def test_cascade_under_a_geometry_equals_jax(n, geometry):
    sv, pv = _pairs(n, seed=n)
    want = mp._merge_sort_cascade(jnp.asarray(sv), jnp.asarray(pv),
                                  interpret=True, **geometry)
    got = merge._merge_sort_cascade(*_t(sv, pv), **geometry)
    default = merge._merge_sort_cascade(*_t(sv, pv))
    for g, d, w, what in zip(got, default, want, ("keys", "payloads")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=what)
        np.testing.assert_array_equal(d.numpy(), g.numpy(), err_msg=what)
    np.testing.assert_array_equal(got[0].numpy(), np.sort(sv))


def test_cascade_with_duplicate_keys_under_a_geometry():
    sv, pv = _pairs(1 << 15, seed=3, distinct=False)
    geometry = dict(vmem_tile=1 << 13, hbm_window=1024)
    want = mp._merge_sort_cascade(jnp.asarray(sv), jnp.asarray(pv),
                                  interpret=True, **geometry)
    got = merge._merge_sort_cascade(*_t(sv, pv), **geometry)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(_words(*(g.numpy() for g in got)),
                                  _words(*want))


def test_geometry_defaults_are_the_references():
    ours = inspect.signature(merge._merge_sort_cascade).parameters
    theirs = inspect.signature(mp._merge_sort_cascade).parameters
    for name in ("vmem_tile", "vmem_levels_per_call", "hbm_window",
                 "lane_transpose", "hbm_double_buffer"):
        assert ours[name].default == theirs[name].default, name


def test_cascade_passes_its_geometry_down(monkeypatch):
    """The result does not show the geometry, so the calls are recorded."""
    calls = []
    levels_vmem, level_hbm = merge.merge_levels_vmem, merge.merge_level_hbm

    def rec_vmem(sv, pv, run, levels, tile_elems):
        calls.append(("vmem", run, levels, tile_elems))
        return levels_vmem(sv, pv, run, levels, tile_elems=tile_elems)

    def rec_hbm(sv, pv, run, window):
        calls.append(("hbm", run, window))
        return level_hbm(sv, pv, run, window=window)

    monkeypatch.setattr(merge, "merge_levels_vmem", rec_vmem)
    monkeypatch.setattr(merge, "merge_level_hbm", rec_hbm)
    sv, pv = _pairs(1 << 16, seed=4)
    merge._merge_sort_cascade(*_t(sv, pv), vmem_tile=1 << 13,
                              vmem_levels_per_call=1, hbm_window=2048)
    assert calls == [("vmem", 4096, 1, 1 << 13), ("hbm", 1 << 13, 2048),
                     ("hbm", 1 << 14, 2048), ("hbm", 1 << 15, 2048)]
    calls.clear()
    merge._merge_sort_cascade(*_t(sv, pv))
    assert calls == [("vmem", 4096, 2, 1 << 14), ("hbm", 1 << 14, 8192),
                     ("hbm", 1 << 15, 8192)]


def test_the_plain_versions_take_a_geometry_no_block_holds():
    """On CPU tensors any size goes: runs of 2^15 inside a "block" and
    windows of 2^15, both past MAX_BLOCK_ELEMS. (On the card the same call
    raises the wrappers' ValueError.)"""
    sv, pv = _pairs(1 << 16, seed=5)
    assert 1 << 15 > merge.MAX_BLOCK_ELEMS
    got = merge._merge_sort_cascade(*_t(sv, pv), vmem_tile=1 << 15,
                                    hbm_window=1 << 15)
    np.testing.assert_array_equal(got[0].numpy(), np.sort(sv))
    np.testing.assert_array_equal(got[1].numpy(), pv[np.argsort(sv)])


def test_a_window_longer_than_the_runs_raises():
    sv, pv = _pairs(1 << 16, seed=6)
    with pytest.raises(ValueError, match="run_len >= window"):
        merge._merge_sort_cascade(*_t(sv, pv), hbm_window=32768)


# ---- the benches and the validation, through their entry points ------------

def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_bench_packed(capsys):
    res = merge_sort_bench.bench_packed(13, device="cpu")
    assert _lines(capsys) == [res]
    assert set(res) == {"bench", "n", "two_op_ms", "two_op_Mrows_s",
                        "packed_ms", "packed_Mrows_s", "packed_correct",
                        "speedup"}
    assert res["bench"] == "packed" and res["n"] == 1 << 13
    assert res["packed_correct"] is True


@pytest.mark.parametrize("lg", [14, 15])
def test_bench_full(capsys, lg):
    res = merge_sort_bench.bench_full(lg, device="cpu")
    assert _lines(capsys) == [res]
    assert res["bench"] == "full" and res["n"] == 1 << lg
    assert {"lax_ms", "lax_Mrows_s"} <= set(res)
    for name in ("merge", "merge_w4k", "merge_w2k"):
        for key in ("ms", "Mrows_s", "speedup"):
            assert res[f"{name}_{key}"] > 0
        assert res[f"{name}_keys_exact"] is True
    # the reference's variants that are this card's `merge` launches
    assert res["same_launches_as_merge"] == ["merge_nodb", "merge_lt"]
    assert not any(k.startswith(("merge_nodb", "merge_lt")) for k in res)
    # window 32768: at 2^14 no merge-path level runs; at 2^15 the level's
    # runs of 2^14 are shorter than the window, and the line carries that
    if lg == 14:
        assert res["merge_w32k_keys_exact"] is True
    else:
        assert "run_len >= window" in res["merge_w32k_error"]
        assert "merge_w32k_ms" not in res


def test_bench_stages(capsys):
    res = merge_sort_bench.bench_stages(14, device="cpu")
    lines = _lines(capsys)
    assert lines[-1] == res
    cases = merge_sort_bench.stage_cases(1 << 14)
    assert [(ln["stage"], ln["d"], ln["tile"]) for ln in lines[:-1]] == cases
    assert {ln["memory"] for ln in lines[:-1]} == {"shared"}
    assert all(ln["ms"] > 0 and ln["Gelem_stage_s"] > 0 for ln in lines[:-1])
    assert res["bench"] == "stages" and res["reps"] == 24
    for name, _, _ in cases:
        assert res[f"{name}_Gelem_stage_s"] > 0
    assert res["stages_correct"] is True
    assert res["vmem_level_tile"] == 1 << 14 and res["vmem_level_ms"] > 0


@pytest.mark.parametrize("argv,benches", [
    (["packed", "13"], ["packed"]),
    (["full", "14"], ["full"]),
    (["all", "13"], ["stages", "packed", "full"]),
])
def test_merge_sort_bench_main(capsys, argv, benches):
    assert merge_sort_bench.main(argv + ["--device", "cpu"]) == 0
    got = [ln["bench"] for ln in _lines(capsys) if "bench" in ln]
    assert got == benches


def test_merge_sort_bench_main_fails_on_a_wrong_result(capsys, monkeypatch):
    monkeypatch.setattr(merge, "packed_sort_pairs",
                        lambda sv, pv: (sv, pv))          # sorts nothing
    assert merge_sort_bench.main(["packed", "13", "--device", "cpu"]) == 1
    assert _lines(capsys)[0]["packed_correct"] is False


def test_merge_fix_validate(capsys):
    assert merge_fix_validate.main(["14", "--device", "cpu"]) == 0
    check, speed = _lines(capsys)
    assert check["check"] == "merge_fix_correct" and check["n"] == 1 << 14
    assert check["keys_ok"] is True and check["pairs_ok"] is True
    assert check["cascade"] is True
    assert speed["check"] == "merge_fix_speed"
    assert {"merge_ms", "lax_ms", "merge_Mrows_s", "lax_Mrows_s",
            "speedup_vs_lax"} <= set(speed)


def test_merge_fix_validate_default_is_2_to_the_18_on_the_card(monkeypatch):
    seen = []
    monkeypatch.setattr(
        merge_fix_validate, "validate", lambda lg, device: (
            seen.append((lg, device)),
            ({"keys_ok": True, "pairs_ok": True}, None))[1])
    assert merge_fix_validate.main([]) == 0
    assert seen == [(18, "cuda")]


def test_merge_fix_validate_exits_1_when_the_sort_is_wrong(capsys, monkeypatch):
    def lossy(sv, pv):
        sv, pv = merge.torch_sort_pairs(sv, pv)
        pv = pv.clone()
        pv[0] = pv[1]
        return sv, pv
    monkeypatch.setattr(merge, "merge_sort_pairs", lossy)
    assert merge_fix_validate.main(["13", "--device", "cpu"]) == 1
    (check,) = _lines(capsys)
    assert check["keys_ok"] is True and check["pairs_ok"] is False
