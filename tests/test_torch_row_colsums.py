"""The late aggregate's column sums (`ops/row_colsums.py`,
`csrc/row_colsums.cu`).

* the plain version (`torch_row_colsums`, the CPU route) against JAX's
  `jnp.sum(cols.astype(uint32), 1)[ids].astype(int32)` over a grid of
  widths, table sizes and id vectors: in order, shuffled, negative, past the
  end, empty; column values near +-2^31, so that sums wrap;
* `_kernel_model`, a plain PyTorch model of the kernel's index arithmetic:
  blocks of kThreads x kItems outputs, thread t on outputs t, t + kThreads,
  ..., JAX's index rule, each row read in vectors of the width the source's
  `vector_width` picks, at the tensors' own strides; its constants are read
  from the CUDA source. Change the model with the kernel;
* the wrapper's checks and its CPU route, and that every caller of the
  column sums (both `late_aggregate` paths through `_colsums`, and
  `probe_bench.late_steps`) reaches the wrapper and no other column-sum
  code;
* card-only cases (marker `card`), which skip without a card.

This file imports no JAX at module level: its card cases run where JAX is
not installed. The JAX comparison imports it inside the test.
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu_torch.benchmarks import probe_bench
from icde2019_gpu_join_tpu_torch.config import EngineConfig
from icde2019_gpu_join_tpu_torch.models.joins import ClusteredJoin
from icde2019_gpu_join_tpu_torch.ops import row_colsums
from icde2019_gpu_join_tpu_torch.relation import Relation
from icde2019_gpu_join_tpu_torch.utils import oracle

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "icde2019_gpu_join_tpu_torch")
SOURCE = os.path.join(PKG, "csrc", "row_colsums.cu")
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1


def _constant(name: str) -> int:
    with open(SOURCE) as f:
        text = f.read()
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, f"{name} not found in {SOURCE}"
    expr = m.group(1)
    for other in ("kThreads", "kItems"):
        if other in expr:
            expr = expr.replace(other, str(_constant(other)))
    return int(eval(expr, {}))


THREADS, ITEMS = _constant("kThreads"), _constant("kItems")
assert _constant("kRows") == THREADS * ITEMS

# ---- the grid ---------------------------------------------------------------

WIDTHS = (0, 1, 2, 3, 4, 5)
SIZES = (1, 1000, 4097)
ID_KINDS = ("in_order", "shuffled", "negative", "past_n")
GRID = ([(c, n, kind) for c in WIDTHS for n in SIZES for kind in ID_KINDS]
        + [(c, 1000, "empty") for c in WIDTHS])


def _case(c: int, n: int, kind: str):
    """(cols [n, c], ids) as int32 numpy arrays; every column value lies
    within 1000 of INT32_MIN or INT32_MAX."""
    rs = np.random.RandomState(GRID.index((c, n, kind)))
    near = rs.randint(0, 1000, (n, c))
    cols = np.where(rs.rand(n, c) < 0.5, INT32_MIN + near, INT32_MAX - near)
    if kind == "in_order":
        ids = np.arange(n)
    elif kind == "shuffled":
        ids = rs.permutation(n)
    elif kind == "negative":        # from the end, and before the start
        ids = rs.randint(-2 * n - 3, 0, n)
        ids[rs.rand(n) < 0.05] = INT32_MIN
    elif kind == "past_n":
        ids = rs.randint(n, 2 * n + 3, n)
        ids[rs.rand(n) < 0.05] = INT32_MAX
    else:
        ids = np.zeros(0, np.int64)
    return cols.astype(np.int32), ids.astype(np.int32)


def _tensors(c, n, kind, device="cpu"):
    cols, ids = _case(c, n, kind)
    return torch.from_numpy(cols).to(device), torch.from_numpy(ids).to(device)


def _jax_sums(cols: np.ndarray, ids: np.ndarray) -> np.ndarray:
    import jax.numpy as jnp
    got = jnp.sum(jnp.asarray(cols).astype(jnp.uint32), axis=1)[jnp.asarray(ids)]
    return np.asarray(got.astype(jnp.int32))


@pytest.mark.parametrize("c,n,kind", GRID)
def test_plain_version_is_jaxs_sums(c, n, kind):
    cols, ids = _case(c, n, kind)
    got = row_colsums.torch_row_colsums(torch.from_numpy(cols),
                                        torch.from_numpy(ids))
    assert got.dtype == torch.int32 and got.shape == ids.shape
    np.testing.assert_array_equal(got.numpy(), _jax_sums(cols, ids))


def test_the_grid_wraps_and_reaches_every_index_rule():
    cols, _ = _case(4, 4097, "in_order")
    wide = cols.astype(np.int64).sum(1)
    assert (wide > INT32_MAX).any() and (wide < INT32_MIN).any()
    _, neg = _case(2, 4097, "negative")
    assert (neg < -4097).any() and ((neg < 0) & (neg >= -4097)).any()
    _, past = _case(2, 4097, "past_n")
    assert (past >= 4097).all() and (past == INT32_MAX).any()


# ---- the kernel's model ----------------------------------------------------

def _vector_width(cols: torch.Tensor, base: int) -> int:
    """`vector_width` of the source: base is the first element's byte
    address."""
    (n, c), (row_stride, col_stride) = cols.shape, cols.stride()
    if col_stride != 1 and c > 1:
        return 1
    for v in (4, 2):
        if c % v == 0 and base % (4 * v) == 0 and (n == 1 or row_stride % v == 0):
            return v
    return 1


def _kernel_model(cols: torch.Tensor, rowid: torch.Tensor):
    """`tj_row_colsums` over blocks, threads and items, in int64 holding
    uint32; cols and rowid read through their strides from flat storage,
    whose start the model takes as 16-byte aligned, as the card's are."""
    (n, c), m = cols.shape, rowid.shape[0]
    if n == 0 or c == 0:
        return torch.zeros(m, dtype=torch.int32)
    v = _vector_width(cols, 4 * cols.storage_offset())
    row_stride, col_stride = cols.stride()
    col_stride = col_stride if v == 1 else 1
    flat = cols.as_strided((cols.untyped_storage().nbytes() // 4,), (1,),
                           0).long() % 2**32
    id_flat = rowid.as_strided((rowid.untyped_storage().nbytes() // 4,),
                               (1,), 0).long()
    off0, id_off0 = cols.storage_offset(), rowid.storage_offset()
    blocks = -(-m // (THREADS * ITEMS))
    b = torch.arange(blocks)[:, None, None]
    t = torch.arange(THREADS)[None, :, None]
    k = torch.arange(ITEMS)[None, None, :]
    i = b * THREADS * ITEMS + t + k * THREADS            # [block, thread, item]
    live = i < m
    ids = torch.where(live, id_flat[id_off0 + i.clamp(max=m - 1) * rowid.stride(0)],
                      torch.zeros_like(i))
    ids = torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)
    at = off0 + ids * row_stride
    total = torch.zeros_like(i)
    for j in range(0, c, v):
        for lane in range(v):
            word = flat[at + j * col_stride + lane]
            total += torch.where(live, word, torch.zeros_like(word))
    out = torch.full((m,), -1, dtype=torch.int64)
    out[i[live]] = total[live] % 2**32
    assert int((out < 0).sum()) == 0, "an output was not written"
    assert int(live.sum()) == m, "an output was written twice"
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


@pytest.mark.parametrize("c,n,kind", GRID)
def test_model_is_the_plain_version(c, n, kind):
    cols, ids = _tensors(c, n, kind)
    assert torch.equal(_kernel_model(cols, ids),
                       row_colsums.torch_row_colsums(cols, ids))


def _layouts():
    """Strided inputs the wrapper passes as they are: (cols, ids)."""
    g = torch.Generator().manual_seed(5)
    big = torch.randint(INT32_MIN, INT32_MAX, (3001, 10), generator=g,
                        dtype=torch.int64).to(torch.int32)
    ids = torch.randint(-4000, 4000, (2500,), generator=g, dtype=torch.int32)
    return {
        "column slice": (big[:, 1:5], ids),
        "even columns": (big[:, ::2], ids),
        "transposed": (big.t().contiguous().t()[:, :4], ids),
        "strided ids": (big[:, :4], ids[::3]),
        "one row repeated": (big[7:8, :2].expand(3001, 2), ids),
        "pairs at a stride": (big[:, 4:6], ids),
        "quads at a stride": (big[:, :8].contiguous()[:, 4:], ids),
    }


@pytest.mark.parametrize("layout", sorted(_layouts()))
def test_model_takes_strides_as_they_are(layout):
    cols, ids = _layouts()[layout]
    assert torch.equal(_kernel_model(cols, ids),
                       row_colsums.torch_row_colsums(cols, ids))


def test_vector_widths():
    layouts = _layouts()
    assert [_vector_width(layouts[k][0], 4 * layouts[k][0].storage_offset())
            for k in ("column slice", "pairs at a stride", "quads at a stride")
            ] == [1, 2, 4]
    x = torch.zeros((16, 8), dtype=torch.int32)
    assert _vector_width(x[:, :4], 0) == 4
    assert _vector_width(x[:, :4], 8) == 2
    assert _vector_width(x[:, :2], 0) == 2
    assert _vector_width(x[:, :3], 0) == 1
    assert _vector_width(x[:, ::2], 0) == 1
    assert _vector_width(torch.zeros((16, 6), dtype=torch.int32)[:, :4], 0) == 2


# ---- the wrapper -----------------------------------------------------------

def _bad_inputs():
    cols = torch.zeros((16, 4), dtype=torch.int32)
    ids = torch.arange(16, dtype=torch.int32)
    return {
        "int64 columns": (cols.long(), ids),
        "int16 columns": (cols.short(), ids),
        "float32 columns": (cols.float(), ids),
        "1-D columns": (cols[:, 0], ids),
        "3-D columns": (cols.view(4, 4, 4), ids),
        "int64 ids": (cols, ids.long()),
        "2-D ids": (cols, ids.view(4, 4)),
        "devices differ": (cols, ids.to("meta")),
        "meta tensors": (cols.to("meta"), ids.to("meta")),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_refuses(case):
    cols, ids = _bad_inputs()[case]
    with pytest.raises(ValueError):
        row_colsums.row_colsums(cols, ids)


@pytest.mark.parametrize("c,n,kind", [(4, 4097, "shuffled"), (2, 1, "negative"),
                                      (0, 1000, "past_n"), (3, 1000, "empty")])
def test_cpu_route_is_the_plain_version(c, n, kind):
    cols, ids = _tensors(c, n, kind)
    before = dict(row_colsums.LAUNCHES)
    got = row_colsums.row_colsums(cols, ids)
    assert torch.equal(got, row_colsums.torch_row_colsums(cols, ids))
    assert row_colsums.LAUNCHES == before


def test_no_rows_sum_to_zeros():
    ids = torch.tensor([0, -1, 5], dtype=torch.int32)
    got = row_colsums.row_colsums(torch.zeros((0, 3), dtype=torch.int32), ids)
    assert got.tolist() == [0, 0, 0]


# ---- the callers -----------------------------------------------------------

def _recorder(monkeypatch, twist=None):
    """Replace the wrapper with one that records (rows, columns, ids) a
    call; `twist` changes the columns it sums."""
    calls = []
    real = row_colsums.row_colsums

    def record(cols, rowid):
        calls.append((cols.shape[0], cols.shape[1], rowid.shape[0]))
        return real(twist(cols) if twist else cols, rowid)

    monkeypatch.setattr(row_colsums, "row_colsums", record)
    return calls


def _late_inputs(n_r=600, n_s=1500, c_r=4, c_s=2, seed=3):
    rs = np.random.RandomState(seed)
    rk = rs.permutation(n_r).astype(np.int32)
    sk = rk[rs.randint(0, n_r, n_s)]
    r_cols = rs.randint(INT32_MIN, INT32_MAX, (n_r, c_r), dtype=np.int64).astype(np.int32)
    s_cols = rs.randint(INT32_MIN, INT32_MAX, (n_s, c_s), dtype=np.int64).astype(np.int32)
    s_ids = rs.permutation(n_s).astype(np.int32)
    return rk, sk, r_cols, s_cols, s_ids


ENGINES = {
    "banded": EngineConfig(),
    "blocked": EngineConfig(probe_mode="blocked", probe_tile_r=64, probe_tile_s=64),
    "sort_merge": EngineConfig(probe_mode="sort_merge", probe_tile_r=64,
                               probe_tile_s=64),
}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_late_aggregate_sums_only_through_the_wrapper(engine, monkeypatch):
    """With the wrapper made to sum the columns doubled, the answer is the
    one of doubled columns: no other code fed the probe its row sums."""
    rk, sk, r_cols, s_cols, s_ids = _late_inputs()
    twice = lambda c: c * 2
    calls = _recorder(monkeypatch, twist=twice)
    res = ClusteredJoin(ENGINES[engine], device="cpu").late_aggregate(
        Relation.from_numpy(rk, device="cpu"),
        Relation.from_numpy(sk, s_ids, device="cpu"),
        torch.from_numpy(r_cols), torch.from_numpy(s_cols))
    assert calls == [(600, 4, 600), (1500, 2, 1500)]
    r_ids = np.arange(rk.size, dtype=np.int32)
    want = oracle.join_late_materialize_sum(rk, r_ids, sk, s_ids, r_cols * 2,
                                            s_cols * 2)
    assert res.aggregate == want != oracle.join_late_materialize_sum(
        rk, r_ids, sk, s_ids, r_cols, s_cols)
    assert res.counts["row_colsums"] == 0       # the CPU: the plain version


def test_probe_bench_late_steps_sum_through_the_wrapper(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_JOIN_DATA_DIR", str(tmp_path))
    calls = _recorder(monkeypatch)
    (line,) = probe_bench.late_steps(10, 1, "cpu")
    n = 1 << 10
    # the engine's warm-up and timed call, then the steps' own sums
    assert calls == [(n, 4, n), (n, 2, n)] * 3
    assert line["colsums_ms"] > 0


def test_no_other_module_sums_columns_by_the_plain_route():
    """Outside `ops/row_colsums.py`, the port reaches `torch_row_colsums`
    only through `row_colsums`."""
    found = []
    for root, _, files in os.walk(PKG):
        for f in files:
            path = os.path.join(root, f)
            if f.endswith(".py") and f != "row_colsums.py":
                with open(path) as fh:
                    if "torch_row_colsums(" in fh.read():
                        found.append(os.path.relpath(path, PKG))
    assert found == []


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU route")
    return torch.device("cuda")


def _launched(fn):
    before = row_colsums.LAUNCHES["row_colsums"]
    out = fn()
    torch.cuda.synchronize()
    return out, row_colsums.LAUNCHES["row_colsums"] - before


@pytest.mark.card
@pytest.mark.parametrize("c,n,kind", GRID)
def test_kernel_is_the_plain_version_on_the_card(card, c, n, kind):
    cols, ids = _tensors(c, n, kind)
    got, launches = _launched(
        lambda: row_colsums.row_colsums(cols.to(card), ids.to(card)))
    assert torch.equal(got.cpu(), row_colsums.torch_row_colsums(cols, ids))
    assert launches == (1 if c and kind != "empty" else 0)


@pytest.mark.card
@pytest.mark.parametrize("c", [4, 2])
@pytest.mark.parametrize("ids", ["in_order", "shuffled"])
def test_kernel_at_the_cells_size(card, c, ids):
    n = (1 << 27) + 3
    g = torch.Generator(device=card).manual_seed(c)
    cols = torch.randint(INT32_MIN, INT32_MAX, (n, c), generator=g, device=card,
                         dtype=torch.int32)
    rowid = (torch.arange(n, device=card, dtype=torch.int32) if ids == "in_order"
             else torch.randperm(n, generator=g, device=card).to(torch.int32))
    got, launches = _launched(lambda: row_colsums.row_colsums(cols, rowid))
    assert launches == 1
    assert torch.equal(got, row_colsums.torch_row_colsums(cols, rowid))


@pytest.mark.card
@pytest.mark.parametrize("layout", sorted(_layouts()))
def test_kernel_takes_strides_as_they_are_on_the_card(card, layout):
    cols, ids = _layouts()[layout]
    want = row_colsums.torch_row_colsums(cols, ids)
    dev_cols = cols.to(card) if cols.is_contiguous() else _same_view(cols, card)
    dev_ids = ids.to(card) if ids.is_contiguous() else _same_view(ids, card)
    got, launches = _launched(lambda: row_colsums.row_colsums(dev_cols, dev_ids))
    assert launches == 1
    assert torch.equal(got.cpu(), want)


def _same_view(x: torch.Tensor, device) -> torch.Tensor:
    """x's view, with its strides and offset, over its storage copied."""
    base = torch.empty(0, dtype=x.dtype).set_(x.untyped_storage())
    return base.to(device).as_strided(x.shape, x.stride(), x.storage_offset())


@pytest.mark.card
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_late_aggregate_launches_one_a_side(card, engine):
    rk, sk, r_cols, s_cols, s_ids = _late_inputs()
    res = ClusteredJoin(ENGINES[engine], device=card).late_aggregate(
        Relation.from_numpy(rk, device=card),
        Relation.from_numpy(sk, s_ids, device=card),
        torch.from_numpy(r_cols).to(card), torch.from_numpy(s_cols).to(card))
    assert res.counts["row_colsums"] == 2
    r_ids = np.arange(rk.size, dtype=np.int32)
    assert res.aggregate == oracle.join_late_materialize_sum(
        rk, r_ids, sk, s_ids, r_cols, s_cols)


@pytest.mark.card
def test_no_launch_without_columns_or_ids(card):
    ids = torch.arange(10, dtype=torch.int32, device=card)
    for cols, rowid in ((torch.ones((10, 0), dtype=torch.int32, device=card), ids),
                        (torch.ones((0, 3), dtype=torch.int32, device=card), ids),
                        (torch.ones((10, 3), dtype=torch.int32, device=card), ids[:0])):
        got, launches = _launched(lambda: row_colsums.row_colsums(cols, rowid))
        assert launches == 0
        assert got.tolist() == [0] * rowid.shape[0]
