"""The port's communicators and thread meshes (parallel/comm.py,
parallel/mesh.py): the collectives against numpy, the 2-D groups, failure and
timeout behaviour, and the launch counters under threads."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu_torch.ops import (_launches, band_compare, merge,
                                             probe_ranges)
from icde2019_gpu_join_tpu_torch.parallel.comm import ThreadWorld
from icde2019_gpu_join_tpu_torch.parallel.mesh import Mesh, make_mesh, make_mesh_2d


def test_collectives_match_numpy(rng):
    nd, k = 8, 3
    xs = rng.randint(-2**31, 2**31, (nd, nd * k, 2)).astype(np.int64).astype(np.int32)

    def rank_fn(comms, x):
        c = comms["x"]
        assert c.size == nd and x.shape == (1, nd * k, 2)
        return c.rank, c.all_to_all(x[0]), c.all_gather(x[0]), c.psum_u32(x[0])

    outs = make_mesh(nd, device="cpu").run(rank_fn, torch.from_numpy(xs))
    total = (xs.astype(np.int64).sum(0) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    for d, (rank, a2a, gathered, psum) in enumerate(outs):
        assert rank == d
        want = np.concatenate([xs[j, d * k:(d + 1) * k] for j in range(nd)])
        np.testing.assert_array_equal(a2a.numpy(), want)
        np.testing.assert_array_equal(gathered.numpy(), xs.reshape(-1, 2))
        np.testing.assert_array_equal(psum.numpy(), total)


@pytest.mark.parametrize("nh,nc", [(2, 4), (4, 2)])
def test_grid_groups_are_host_major(nh, nc):
    def rank_fn(comms, r):
        h, c = comms["host"], comms["chip"]
        row = c.all_gather(r)             # the chips of my host
        grid = h.all_gather(row)          # then the hosts
        return h.rank, c.rank, row.tolist(), grid.tolist()

    ranks = torch.arange(nh * nc, dtype=torch.int32)
    outs = make_mesh_2d(nh, nc, device="cpu").run(rank_fn, ranks)
    for r, (hr, cr, row, grid) in enumerate(outs):
        assert (hr, cr) == divmod(r, nc)
        assert row == list(range(hr * nc, (hr + 1) * nc))
        assert grid == list(range(nh * nc))


def test_a_failing_rank_raises_its_error_without_hanging():
    mesh = make_mesh(8, device="cpu", timeout=60.0)

    def rank_fn(comms, x):
        if comms["x"].rank == 5:
            raise KeyError("rank five")
        return comms["x"].all_gather(x)   # the others wait for rank 5

    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="rank five"):
        mesh.run(rank_fn, torch.zeros(8, dtype=torch.int32))
    assert time.perf_counter() - t0 < 30
    # the mesh runs again after a failed run
    outs = mesh.run(lambda c, x: c["x"].psum_u32(x), torch.ones(8, dtype=torch.int32))
    assert [int(o[0]) for o in outs] == [8] * 8


def test_a_missing_collective_times_out():
    mesh = make_mesh(4, device="cpu", timeout=0.5)

    def rank_fn(comms, x):
        if comms["x"].rank:
            comms["x"].all_gather(x)
        return x

    with pytest.raises(TimeoutError, match="0.5 s"):
        mesh.run(rank_fn, torch.zeros(4, dtype=torch.int32))


def test_uneven_shards_and_bad_meshes_raise():
    with pytest.raises(ValueError, match="shard evenly"):
        make_mesh(8, device="cpu").run(lambda c, x: x, torch.zeros(12))
    with pytest.raises(ValueError, match="equal blocks"):
        make_mesh(4, device="cpu").run(lambda c, x: c["x"].all_to_all(x),
                                       torch.zeros(8))
    with pytest.raises(ValueError):
        Mesh((2, 2, 2), ("a", "b", "c"), device="cpu")
    with pytest.raises(ValueError):
        ThreadWorld(0)


@pytest.mark.parametrize("module,counts,name", [
    (band_compare, band_compare.LAUNCHES, "banded_compare_sum"),
    (merge, merge.LAUNCHES, "merge_level_hbm"),
    (merge, merge.ROUTES, "cascade"),
    (probe_ranges, probe_ranges.LAUNCHES, "probe_aggregate_ranges")])
def test_launch_counts_are_exact_from_eight_threads(module, counts, name):
    """Counting is a read-modify-write: eight threads counting at once with
    a tiny switch interval lose no count; the registry's `reset` zeroes the
    module's table."""
    assert any(m == module.__name__ and t is counts
               for m, t in _launches.tables())
    _launches.reset()
    per, threads = 20_000, 8
    count = lambda: _launches.count(counts, name)   # what each wrapper calls
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [count() for _ in range(per)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert counts[name] == per * threads
    _launches.reset()
    assert counts[name] == 0
