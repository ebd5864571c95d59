"""The plain versions of the port's construct probes
(benchmarks/construct_probes.py of the port) against the jnp functions the
reference's probes (benchmarks/mosaic_bisect.py) are made of. The reference's
probe bodies are closures inside kernels that were only ever compiled, so each
plain version is held against `merge_pallas._cx`, `_cx_rows`,
`_bitonic_merge_pairs` and `_mask_windows`, called directly on the CPU and
composed as the probe composes them, key + payload outputs included, on
seeded random blocks of the probes' shapes. Integers: no tolerance. On CPU
tensors the port's constructs run their plain versions."""

import functools
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu.ops import merge_pallas as mp
from icde2019_gpu_join_tpu_torch.benchmarks import construct_probes as cp
from icde2019_gpu_join_tpu_torch.ops import _build, merge

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


def test_empty_launch_is_no_probe():
    """The launch-floor meter: an output block as a construct allocates it,
    no probe kernel counted, a time by the probes' own clock; it takes the
    blocks the constructs take and nothing else."""
    (a,) = cp._blocks(cp.BLOCK_ROWS, 1, "cpu", 0)
    cp.reset_launches()
    o = cp.empty_launch(a)
    assert o.shape == a.shape and o.dtype == a.dtype
    assert cp.LAUNCHES == {"construct_probes": 0}
    assert "empty" in cp.ENTRY_POINTS
    assert "empty" not in {name for name, _ in cp.PROBES}
    assert cp.launch_floor_ms("cpu") >= 0.0
    with pytest.raises(ValueError):
        cp.empty_launch(a[:64])


# ---------------------------------------------------------------------------
# A numpy model of csrc/construct_probes.cu, index for index: which thread and
# slot of which CTA holds each element, which stage runs on the way in,
# across CTAs, in registers, in shuffles or after a trip through shared
# memory, each stage's direction as the kernel reads it, and where each
# thread writes. There is no compiler here: change the model with the
# kernels, and run it before their first build.
# ---------------------------------------------------------------------------

SHUFFLES = 5                        # kShuffles
INT_MIN, INT_MAX = np.int32(-2**31), np.int32(2**31 - 1)

# ladder_spec: log2 pairs, first and last stage bit, row mask, keys a over b
# (payloads b over a), output the keys' first half + the payloads' second,
# problems a launch, pairs a thread, CTAs a problem
LADDERS = {"sublane_ladder": (14, 13, 7, False, False, False, 1, 16, 8),
           "lane_ladder_T": (14, 6, 0, False, False, False, 1, 4, 16),
           "concat_merge": (14, 13, 0, False, True, False, 2, 4, 8),
           "full_merge_T": (15, 14, 0, False, True, True, 1, 16, 8),
           "merge_T_dm": (15, 14, 0, True, True, True, 1, 16, 8),
           # min_dma_compute: the lower half of the masked windows' merge
           "masked": (13, 12, 0, False, False, False, 2, 4, 8)}


class _Layout:
    """A layout of E = 2^B pairs a thread."""

    def __init__(self, tpart, s0, s1, B):
        self.tpart, self.s0, self.s1, self.B = tpart, s0, s1, B

    def is_group(self, g):
        return self.s0 == g and self.s1 == g + 2

    def index(self):
        """[threads, E]: the element each slot of each thread holds."""
        e = np.arange(1 << self.B)
        return (self.tpart[:, None] | ((e & 3) << self.s0)
                | ((e >> 2) << self.s1))


def _group(t, g, B):
    """tj_layout_group: register bits g .. g + B - 1."""
    return _Layout((t & ((1 << g) - 1)) | ((t >> g) << (g + B)), g, g + 2, B)


def _take(mine, other, is_hi, desc):
    """TjSwapLess::take: the lower side takes a smaller key, the upper a
    larger one, the other way round where the group descends."""
    return np.where(is_hi, mine < other, other < mine) != desc


def _probe_stage(key, pay, l, j, lanes, row_mask, routes):
    """probe_stage: stage j in shuffles (a lane bit of the contiguous layout)
    or in registers (a register bit of the layout), directed as
    tj_stages_directed reads bit 7 of the index (a slot bit or the thread's
    part), ascending at j = 7 or without the row mask."""
    threads, E = key.shape
    B = l.B
    t = np.arange(threads)
    if not row_mask or j == 7:
        dirs = lambda e: np.zeros(threads, bool)
    elif l.s0 <= 7 < l.s0 + 2:
        dirs = lambda e: np.full(threads, bool((e >> (7 - l.s0)) & 1))
    elif l.s1 <= 7 < l.s1 + B - 2:
        dirs = lambda e: np.full(threads, bool((e >> (7 - l.s1 + 2)) & 1))
    else:
        desc = ((l.tpart >> 7) & 1).astype(bool)
        dirs = lambda e: desc
    idx = l.index()
    if lanes and j >= B:
        assert j <= B + 4, "a shuffle reaches only the warp's lanes"
        x = 1 << (j - B)
        assert (idx[t ^ x] == idx ^ (1 << j)).all()
        is_hi = ((t >> (j - B)) & 1).astype(bool)
        ok, op = key[t ^ x], pay[t ^ x]                # __shfl_xor_sync
        for e in range(E):
            take = _take(key[:, e], ok[:, e], is_hi, dirs(e))
            key[:, e] = np.where(take, ok[:, e], key[:, e])
            pay[:, e] = np.where(take, op[:, e], pay[:, e])
        routes.append((j, "shuffle"))
        return
    regs = [R for R in range(B) if (l.s0 + R if R < 2 else l.s1 + R - 2) == j]
    assert len(regs) == 1, f"stage {j} is no register bit of the layout"
    R = regs[0]
    for e in range(E):
        if e & (1 << R) == 0:
            f = e | (1 << R)
            assert (idx[:, f] == idx[:, e] ^ (1 << j)).all()
            swap = (key[:, f] < key[:, e]) != dirs(e)
            ke, kf, pe, pf = (key[:, e].copy(), key[:, f].copy(),
                              pay[:, e].copy(), pay[:, f].copy())
            key[:, e], key[:, f] = np.where(swap, kf, ke), np.where(swap, ke, kf)
            pay[:, e], pay[:, f] = np.where(swap, pf, pe), np.where(swap, pe, pf)
    routes.append((j, "register"))


def _relayout(key, pay, frm, to):
    """tj_relayout: through the exchange buffer, by element index (the
    swizzle is a bijection of the buffer and cancels)."""
    bk, bp = np.empty(key.size, key.dtype), np.empty(pay.size, pay.dtype)
    bk[frm.index()], bp[frm.index()] = key, pay
    key[...], pay[...] = bk[to.index()], bp[to.index()]


def _local_stages(key, pay, l, hi, lo, row_mask, routes):
    """local_stages: as tj_block_stages schedules them, stage by stage.
    Returns the layout left."""
    t = np.arange(key.shape[0])
    B = l.B
    while hi >= lo and hi > B - 1 + SHUFFLES:
        g = hi - B + 1
        if not l.is_group(g):
            to = _group(t, g, B)
            _relayout(key, pay, l, to)
            routes.append((g, "shared"))
            l = to
        for j in range(hi, max(g, lo) - 1, -1):
            _probe_stage(key, pay, l, j, False, row_mask, routes)
        hi = g - 1
    if hi < lo:
        return l
    if not l.is_group(0):
        to = _group(t, 0, B)
        _relayout(key, pay, l, to)
        routes.append((0, "shared"))
        l = to
    for j in range(hi, lo - 1, -1):
        _probe_stage(key, pay, l, j, True, row_mask, routes)
    return l


def _pairs(name, held, pairs=None):
    """Geometry::kPairs: the ladder's pairs a thread (or `pairs`), or more
    where a CTA's pairs would need more than 1024 threads."""
    return max(pairs or LADDERS[name][7], held // 1024)


def _first_layout(threads, hi, E):
    B = E.bit_length() - 1
    return _group(np.arange(threads),
                  hi - B + 1 if hi > B - 1 + SHUFFLES else 0, B)


def _staged(x, at, held):
    """A slice the CTA stages by one bulk copy: whole, 16-byte aligned."""
    assert at % 4 == 0 and (4 * held) % 16 == 0
    return x[at:at + held]


def _ladder_model(name, ctas, a, b, meta=None, pairs=None):
    """ladder_kernel<P, ctas> over the flat operands a, b (min_dma_compute,
    "masked": a = x, its rows flat, and meta [7, 2]): problem by problem,
    pass by pass, its CTAs side by side, each reading only the slices it
    staged. Returns (o, the routes of CTA 0's first pass of the first
    problem)."""
    log_n, hi, lo, row_mask, halves_in, halves_out, problems = \
        LADDERS[name][:7]
    windows = name == "masked"
    n, h = 1 << log_n, 1 << (log_n - 1)
    size = n // ctas
    held = min(size, 1 << 14)
    E = _pairs(name, held, pairs)
    threads = held // E
    assert 64 <= threads <= 1024
    log_size = size.bit_length() - 1
    top = hi == log_n - 1 and not windows
    staged = 4 if top and not halves_in and ctas > 1 else 2
    length = h if halves_in and held > h else held     # kStagedLen
    after = hi - 1 if top else hi
    local_hi = min(after, log_size - 1)
    a, b = a.reshape(-1), (None if b is None else b.reshape(-1))
    o = (np.full(problems * (h if halves_out else n), 0x55555555, np.int32)
         if not windows else np.full(a.size, 0x55555555, np.int32))
    first_routes = None
    for problem in range(problems):
        in_a = in_b = problem * (h if halves_in else n)
        out = problem * (h if halves_out else n)
        if windows:
            a_row, b_row, a_lo, a_hi, b_wlo, b_whi, out_row = meta[:, problem]
            in_a, in_b, out = a_row * 128, b_row * 128, out_row * 128
            b = a
        for step in range(size // held):
            routes = [(hi, "load")] if top else []
            cta = []
            for rank in range(ctas):
                first = rank * size + step * held
                at = (first & (h - 1)) if halves_in else first
                sa = _staged(a, in_a + at, length)
                sb = _staged(b, in_b + at, length)
                if staged == 4:
                    oa = _staged(a, in_a + (first ^ h), length)
                    ob = _staged(b, in_b + (first ^ h), length)
                l = _first_layout(threads, local_hi, E)
                li = l.index()
                g = first + li
                if windows:
                    x = np.where(g < a_lo, INT_MIN, sa[li])
                    x = np.where(g >= a_hi, INT_MAX, x)
                    y = np.where(g < b_wlo, INT_MAX, ~sb[li])
                    y = np.where(g >= b_whi, INT_MIN, y)
                    swap = y < x
                    key, pay = np.where(swap, y, x), np.where(swap, sb[li], sa[li])
                elif top:
                    upper = (g & h) != 0
                    desc = row_mask & (((g >> 7) & 1) == 1)
                    if halves_in:
                        x, y = sa[li & (length - 1)], sb[li & (length - 1)]
                        keeps_x = ((y < x) != desc) == upper
                        key, pay = np.where(keeps_x, x, y), np.where(keeps_x, y, x)
                    else:
                        k0, p0 = sa[li], sb[li]
                        k1, p1 = ((oa[li], ob[li]) if staged == 4
                                  else (sa[li ^ h], sb[li ^ h]))
                        swap = (np.where(upper, k0, k1)
                                < np.where(upper, k1, k0)) != desc
                        key, pay = np.where(swap, k1, k0), np.where(swap, p1, p0)
                else:
                    key, pay = sa[li], sb[li]
                cta.append([key.astype(np.int32), pay.astype(np.int32), l, g])
            # the stages between slices: CTA r against r ^ mask, place for
            # place (both hold the same layout), one push a stage
            for j in range(after, max(log_size, lo) - 1, -1):
                mask = 1 << (j - log_size)
                new = []
                for rank in range(ctas):
                    key, pay, l, g = cta[rank]
                    ok, op, _, og = cta[rank ^ mask]
                    assert (og == g ^ (1 << j)).all()
                    desc = row_mask & (((l.index() >> 7) & 1) == 1)
                    take = _take(key, ok, bool(rank & mask), desc)
                    new.append([np.where(take, ok, key), np.where(take, op, pay),
                                l, g])
                cta = new
                routes.append((j, "cluster"))
            for rank in range(ctas):
                key, pay, l, _ = cta[rank]
                cta[rank][2] = _local_stages(key, pay, l, local_hi, lo,
                                             row_mask, routes if rank == 0
                                             else [])
            if first_routes is None:
                first_routes = routes
            for rank in range(ctas):
                key, pay, l, _ = cta[rank]
                idx = l.index()
                first = rank * size + step * held
                if not halves_out:
                    o[out + first + idx] = key + pay
                elif ctas == 1:
                    o[out + idx] = key if step == 0 else o[out + idx] + pay
                elif rank >= ctas // 2:
                    lower = cta[rank - ctas // 2]
                    assert (lower[2].index() == idx).all()
                    o[out + (rank - ctas // 2) * size + idx] = lower[0] + pay
    return o, first_routes


_LADDER_PLAIN = {"sublane_ladder": cp.sublane_ladder_ref,
                 "lane_ladder_T": cp.lane_ladder_T_ref,
                 "concat_merge": cp.concat_merge_ref,
                 "full_merge_T": cp.full_merge_T_ref,
                 "merge_T_dm": cp.merge_T_dm_ref}


# The CTAs a problem the ladders' kernel was measured at: each ladder's own
# (ladder_spec) and the others, built on copies with it changed.
_CTAS = {name: (1, 2, 4, 8, 16) if name == "lane_ladder_T" else (1, 2, 4, 8)
         for name in _LADDER_PLAIN}


def _kind_blocks(kind, seed):
    return [x.numpy() for x in cp._keys(kind, S, 2, "cpu", seed)]


def test_ladder_model_is_the_kernels_spec():
    """The model's LADDERS are ladder_spec's entries in the CUDA source, in
    the order of its Ladder enum."""
    with open(os.path.join(_build.CSRC_DIR, "construct_probes.cu")) as f:
        src = f.read()
    specs = re.findall(r"LadderSpec\{([^}]*)\}", src.split(
        "constexpr LadderSpec ladder_spec")[1])
    parse = lambda v: {"true": True, "false": False}.get(v, None)
    got = [tuple(int(v) if parse(v) is None else parse(v)
                 for v in (x.strip() for x in spec.split(",")))
           for spec in specs]
    # the source's fields: log_n, hi, lo, row_mask, halves_in, halves_out,
    # windows, problems, pairs, ctas; the model's windows is "masked"
    want = [(*m[:6], name == "masked", *m[6:]) for name, m in LADDERS.items()]
    assert got == want
    assert all(n in _CTAS[name] for name, (*_, n) in LADDERS.items()
               if name in _CTAS)


@pytest.mark.parametrize("kind", ["random", "equal", "extreme"])
@pytest.mark.parametrize("name,ctas", [(name, ctas) for name in _LADDER_PLAIN
                                       for ctas in _CTAS[name]])
def test_ladder_kernel_model_equals_plain(name, ctas, kind):
    """Every ladder on every count of CTAs it was measured at, as the card
    runs it, gives the plain version's block: ties, INT32_MIN and INT32_MAX
    included."""
    a, b = _kind_blocks(kind, seed=ctas)
    got, _ = _ladder_model(name, ctas, a, b)
    want = _LADDER_PLAIN[name](*_t(a, b))
    np.testing.assert_array_equal(got.reshape(want.shape), want.numpy())


@pytest.mark.parametrize("pairs", [4, 8, 16])
@pytest.mark.parametrize("name,ctas", [(name, form) for name in _LADDER_PLAIN
                                       for form in (1, 8)])
def test_ladder_kernel_model_at_other_pairs_a_thread(name, ctas, pairs):
    """The pairs a thread that were measured beside each ladder's own give
    the plain version's block too."""
    a, b = _kind_blocks("extreme", seed=pairs)
    got, _ = _ladder_model(name, ctas, a, b, pairs=pairs)
    want = _LADDER_PLAIN[name](*_t(a, b))
    np.testing.assert_array_equal(got.reshape(want.shape), want.numpy())


@pytest.mark.parametrize("name,ctas,routes", [
    # one CTA of 1024 threads: loaded in group 9's layout, four stages in
    # registers, one trip, then the contiguous layout's five shuffle stages
    # and four register stages
    ("concat_merge", 1,
     [(13, "load"), *[(j, "register") for j in range(12, 8, -1)],
      (0, "shared"), *[(j, "shuffle") for j in range(8, 3, -1)],
      *[(j, "register") for j in range(3, -1, -1)]]),
    # a cluster of 8: two stages across CTAs, then 12 inside one
    ("full_merge_T", 8,
     [(14, "load"), (13, "cluster"), (12, "cluster"),
      *[(j, "register") for j in range(11, 7, -1)], (0, "shared"),
      *[(j, "shuffle") for j in range(7, 3, -1)],
      *[(j, "register") for j in range(3, -1, -1)]]),
    # the rows' stages: no trip at all
    ("lane_ladder_T", 1,
     [*[(j, "shuffle") for j in (6, 5, 4)],
      *[(j, "register") for j in range(3, -1, -1)]]),
    ("sublane_ladder", 4,
     [(13, "load"), (12, "cluster"),
      *[(j, "register") for j in range(11, 7, -1)], (0, "shared"),
      (7, "shuffle")]),
    # each ladder's own CTAs at 4 pairs a thread: two register bits a
    # layout, so a trip every two stages above the warp's five lane bits
    ("concat_merge", 8,
     [(13, "load"), (12, "cluster"), (11, "cluster"), (10, "register"),
      (9, "register"), (7, "shared"), (8, "register"), (7, "register"),
      (0, "shared"), *[(j, "shuffle") for j in range(6, 1, -1)],
      (1, "register"), (0, "register")]),
    ("lane_ladder_T", 16,
     [*[(j, "shuffle") for j in range(6, 1, -1)], (1, "register"),
      (0, "register")]),
])
def test_ladder_stage_schedule(name, ctas, routes):
    """Which stage runs on the way in, across CTAs, in registers or in
    shuffles, and the trips through shared memory between them."""
    a, b = _blocks(S, 2, seed=11)
    assert _ladder_model(name, ctas, a, b)[1] == routes


@functools.lru_cache(maxsize=None)
def _jax_full_merge(kind, dm, lane_transpose):
    a, b = _kind_blocks(kind, seed=21)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    mask = jnp.arange(2 * S, dtype=jnp.int32)[:, None] & 1 if dm else None
    sv, pv = mp._bitonic_merge_pairs(
        jnp.concatenate([ja, jb], axis=0), jnp.concatenate([jb, ja], axis=0),
        S * 128, dm=mask, lane_transpose=lane_transpose)
    return a, b, np.asarray(sv[:S] + pv[S:])


@pytest.mark.parametrize("kind", ["random", "equal", "extreme"])
@pytest.mark.parametrize("lane_transpose", [False, True])
@pytest.mark.parametrize("dm", [False, True])
@pytest.mark.parametrize("ctas", [1, 2, 4, 8])
def test_cluster_decomposition_equals_the_references_merge(ctas, dm,
                                                           lane_transpose,
                                                           kind):
    """The merge of 2^15 pairs cut over 1-8 CTAs (the first stage on the
    way in, the stages between slices across CTAs, each slice's own ladder,
    the lower CTAs' keys + the upper CTAs' payloads) is the reference's
    `_bitonic_merge_pairs`, with and without its row mask and lane
    transpose."""
    a, b, want = _jax_full_merge(kind, dm, lane_transpose)
    got, _ = _ladder_model("merge_T_dm" if dm else "full_merge_T", ctas, a, b)
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def _stage_model(a, b, d, row_mask):
    """stage_kernel: the threads' 16-byte vectors and exchanges."""
    a, b = a.reshape(-1), b.reshape(-1)
    o = np.full_like(a, 0x55555555)
    written = np.zeros(a.size, int)
    for q in range(cp.BLOCK // 8 if d >= 4 else cp.BLOCK // 4):
        if d >= 4:
            i = 4 * q
            lo = ((i & ~(d - 1)) << 1) | (i & (d - 1))
            assert lo % 4 == 0 and (lo >> 7) == ((lo + 3) >> 7)
            pairs = [(lo + c, lo + d + c) for c in range(4)]
            desc = row_mask and ((lo >> 7) & 1)
        else:
            pairs = ([(4 * q, 4 * q + 1), (4 * q + 2, 4 * q + 3)] if d == 1
                     else [(4 * q, 4 * q + 2), (4 * q + 1, 4 * q + 3)])
            desc = row_mask and (((4 * q) >> 7) & 1)
        for x, y in pairs:
            swap = (a[y] < a[x]) != bool(desc)
            kx, ky = (a[y], a[x]) if swap else (a[x], a[y])
            px, py = (b[y], b[x]) if swap else (b[x], b[y])
            o[x], o[y] = kx + px, ky + py
            written[[x, y]] += 1
    assert (written == 1).all()
    return o.reshape(cp.BLOCK_ROWS, cp.LANES)


@pytest.mark.parametrize("d,row_mask", [(64, False), (16, False), (1, False),
                                        (2, False), (4, False), (8192, False),
                                        (128, True)])
def test_stage_kernel_model_equals_plain(d, row_mask):
    a, b = _blocks(S, 2, seed=d)
    with np.errstate(over="ignore"):
        got = _stage_model(a, b, d, row_mask)
    want = (cp.dirmask_stage_ref if row_mask
            else functools.partial(cp.stage_ref, d=d))(*_t(a, b))
    np.testing.assert_array_equal(got, want.numpy())


def test_transpose_kernel_model_equals_plain():
    """transpose_only_kernel: 16 blocks of 256 threads, a [32, 32] sub-tile
    each through two padded tiles; every element read and written once."""
    a, = _blocks(S, 1, seed=12)
    a[5, 7] = np.iinfo(np.int32).max
    o = np.full_like(a, 0x55555555)
    for s in range(16):
        t = np.arange(256)
        r, c = t // 8, (t % 8) * 4
        rows, cols = (s // 4) * 32 + r, (s % 4) * 32 + c
        x = np.zeros((32, 33), np.int64)
        for k in range(4):
            x[r, c + k] = a[rows, cols + k]
        xt = np.zeros_like(x)
        for k in range(4):
            i = t + 256 * k
            xt[i // 32, i % 32] = x[i % 32, i // 32]
        for k in range(4):
            i = t + 256 * k
            x[i // 32, i % 32] = xt[i % 32, i // 32]
        for k in range(4):
            o[rows, cols + k] = (x[r, c + k] + 1).astype(np.int64).astype(np.int32)
    np.testing.assert_array_equal(o, cp.transpose_only_ref(*_t(a)).numpy())


def test_concat_registers_kernel_model_equals_plain():
    """concat_registers_kernel: thread i's 16-byte vector of o from a or b."""
    a, b = _blocks(cp.WROW, 2, seed=13)
    fa, fb = a.reshape(-1), b.reshape(-1)
    o = np.full(2 * fa.size, 0x55555555, np.int32)
    for t in range(cp.BLOCK // 4):
        i = 4 * t
        o[i:i + 4] = fa[i:i + 4] if i < cp.WINDOW else fb[i - cp.WINDOW:i - cp.WINDOW + 4]
    np.testing.assert_array_equal(o.reshape(cp.BLOCK_ROWS, 128),
                                  cp.concat_only_ref(*_t(a, b)).numpy())


def _zero_outside(o, starts):
    """zero_outside: each 16-byte vector of a row in no window zeroed,
    nothing else touched (which thread of the grid takes it is immaterial)."""
    flat = o.reshape(-1, 4)
    for i in range(o.shape[0] * 32):
        if not any(first <= i // 32 < first + cp.WROW for first in starts):
            flat[i] = 0


DMA_PARTS = 8        # kDmaParts


@pytest.mark.parametrize("windows", [(8, 136), (0, 192), (8, 40), (100, 100)])
def test_min_dma_kernel_model_equals_plain(windows):
    """min_dma_kernel: block b < 2 * kDmaParts copies part b % kDmaParts of
    window b / kDmaParts, every other row zeroed by the grid, overlapping
    windows writing the same values."""
    x, = _blocks(4 * cp.WROW, 1, seed=14)
    o = np.full_like(x, 0x55555555).reshape(-1)
    _zero_outside(o.reshape(x.shape), windows)
    part = cp.WINDOW // DMA_PARTS
    for b in range(2 * DMA_PARTS):
        at = windows[b // DMA_PARTS] * 128 + (b % DMA_PARTS) * part
        assert (4 * at) % 16 == 0 and (4 * part) % 16 == 0
        o[at:at + part] = x.reshape(-1)[at:at + part]
    o = o.reshape(x.shape)
    meta = torch.tensor([[windows[0], 0], [windows[1], 0]], dtype=torch.int32)
    np.testing.assert_array_equal(o, cp.min_dma_ref(meta, *_t(x)).numpy())


def _min_dma_compute_model(meta, x, ctas=LADDERS["masked"][8]):
    """min_dma_compute on the ladders' kernel: the rows no tile writes
    zeroed over the grid, each tile's 64 output rows from its CTAs."""
    o = x.copy()
    _zero_outside(o, [meta[6, t] for t in range(2)])
    got, _ = _ladder_model("masked", ctas, x, None, meta)
    for t in range(2):
        r = meta[6, t]
        o[r:r + cp.WROW] = got.reshape(o.shape)[r:r + cp.WROW]
    return o


@pytest.mark.parametrize("ctas", [1, 2, 4, 8])
@pytest.mark.parametrize("table", ["default", "edges"])
def test_min_dma_compute_kernel_model_equals_plain(table, ctas):
    if table == "default":
        meta = np.array(cp.MERGE_META, np.int32)
    else:   # as `edge_cases`: one tile fully masked, one unmasked
        last = 3 * cp.WROW
        meta = np.array([[last, 0], [0, last], [0, 0], [0, cp.WINDOW],
                         [cp.WINDOW, 0], [cp.WINDOW, cp.WINDOW], [last, 0]],
                        np.int32)
    sv, _ = cp._encoded_runs(4 * cp.WINDOW, cp.WINDOW, "cpu", 15)
    x = sv.view(4 * cp.WROW, 128).numpy()
    with np.errstate(over="ignore"):
        got = _min_dma_compute_model(meta, x, ctas)
    want = cp.min_dma_compute_ref(torch.from_numpy(meta), torch.from_numpy(x))
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("windows", [(0, 192), (8, 40), (100, 100)])
def test_min_dma_windows_at_the_edges(windows):
    """The plain version with windows at row 0, at the last 64 rows, and
    overlapping: each window's rows are x's, every other row 0."""
    x, = _t(*_blocks(4 * cp.WROW, 1, seed=16))
    meta = torch.tensor([[windows[0], 0], [windows[1], 0]], dtype=torch.int32)
    got = cp.min_dma(meta, x).numpy()
    inside = np.zeros(4 * cp.WROW, bool)
    for r0 in windows:
        inside[r0:r0 + cp.WROW] = True
    np.testing.assert_array_equal(got[inside], x.numpy()[inside])
    assert (got[~inside] == 0).all()


def test_every_probe_line_has_a_device_time_null_on_the_cpu(capsys):
    assert cp.main(["--device", "cpu"]) == 0
    lines = _lines(capsys)
    assert all("device_ms" in line and line["device_ms"] is None
               for line in lines)
    for line in lines:
        if line["probe"] in cp.CONSTRUCTS:
            assert line["floor_ms"] is None and line["bound_ms"] is None
    assert cp.empty_device_ms("cpu") is None


@pytest.mark.parametrize("name", cp.CONSTRUCTS)
def test_probe_counts_match_the_plain_versions_shapes(name):
    """PROBE_ELEMENTS: what the plain version reads, each element once (of
    a meta-indexed x only the rows its windows cover, and the table), and
    its output; PROBE_EXCHANGES: its stages times the exchanges of a
    stage."""
    case = cp.construct_case(name, "cpu", 0)
    meta = case.operands.get("meta")
    if meta is None:
        read = sum(case.operands[k].numel() for k in "ab"
                   if case.operands.get(k) is not None)
    else:
        starts = meta[:, 0] if name == "min_dma" else meta[:2].reshape(-1)
        rows = set()
        for r0 in starts.tolist():
            rows.update(range(r0, r0 + cp.WROW))
        read = len(rows) * cp.LANES + meta.numel()
    assert cp.PROBE_ELEMENTS[name] == read + case.plain().numel()
    stages = {"lane_64": 1, "lane_16": 1, "lane_1": 1, "dirmask_stage": 1,
              "sublane_ladder": 7, "lane_ladder_T": 7, "concat_merge": 14,
              "min_dma_compute": 14, "full_merge_T": 15,
              "merge_T_dm": 15}.get(name, 0)
    pairs = {"concat_merge": 2 * cp.BLOCK, "min_dma_compute": 4 * cp.WINDOW,
             "full_merge_T": 2 * cp.BLOCK,
             "merge_T_dm": 2 * cp.BLOCK}.get(name, cp.BLOCK)
    assert cp.PROBE_EXCHANGES[name] == ((stages, pairs // 2) if stages
                                        else (0, 0))


def test_edges_on_the_cpu():
    """The edge cases chip_smoke.py holds are all built and held (on the
    CPU the plain version against itself); a ladder's form is asked of its
    kernel's build, so a probe off the ladders' kernel has none."""
    with pytest.raises(ValueError):
        cp.form("concat_only")
    assert set(cp.LADDERS) == set(_LADDER_PLAIN) | {"min_dma_compute"}
    held = cp.hold_edges("cpu")
    assert len(held) == 4 + 2 * len(cp._BLOCK_PROBES)
    with pytest.raises(SystemExit):          # the device times need a card
        cp.main(["--device", "cpu", "--kernels"])
