"""The port's distributed join in real process worlds: 2 and 4 processes of
a `torch.distributed` gloo world on the CPU, over a `file://` store, each
rank running a `_local` entry point over its shard, against the JAX package
on the same global inputs (8 virtual CPU devices sliced to the world's
size). Each world is joined with a timeout and its processes are killed on
failure, so a hung collective fails its test instead of the run."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from icde2019_gpu_join_tpu.parallel import dist_join as jdj
from icde2019_gpu_join_tpu.parallel.mesh import make_mesh, make_mesh_2d
from icde2019_gpu_join_tpu_torch.utils import oracle
from tests.conftest import make_tables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 120

# One rank: argv = rank, world, store file, inputs (.npz), output (.json),
# case. Imports torch, numpy and the port only.
RANK = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from icde2019_gpu_join_tpu_torch.parallel import dist_join, mesh

rank, world, store, inputs, out, case = sys.argv[1:]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
try:
    data = np.load(inputs)
    rk, rp, sk, sp = (torch.from_numpy(data[k].reshape(world, -1)[rank].copy())
                      for k in ("rk", "rp", "sk", "sp"))
    if case == "2level":
        gm = mesh.group_mesh_2d(2, world // 2)
        agg, ov, loads = dist_join.distributed_join_aggregate_2level_local(
            rk, rp, sk, sp, gm.comm("host"), gm.comm("chip"),
            return_loads=True)
    else:
        gm = mesh.group_mesh()
        agg, ov, loads = dist_join.distributed_join_segmented_local(
            rk, rp, sk, sp, gm.comm("x"), num_segments=4, return_loads=True)
    with open(out, "w") as f:
        json.dump({"agg": int(agg), "overflow": int(ov),
                   "loads": loads.tolist()}, f)
finally:
    dist.destroy_process_group()
"""


def run_world(tmp_path, world: int, case: str, arrays):
    np.savez(tmp_path / "inputs.npz", **dict(zip(("rk", "rp", "sk", "sp"), arrays)))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(world), str(tmp_path / "store"),
         str(tmp_path / "inputs.npz"), str(tmp_path / f"rank{r}.json"), case],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    try:
        errs = [p.communicate(timeout=WORLD_TIMEOUT)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {world}: {errs[r][-3000:]}"
    outs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(world)]
    assert all(o == outs[0] for o in outs), outs
    return outs[0]


def heavy_inputs(rng, n_r=2048, n_s=16384):
    rk = rng.permutation(n_r).astype(np.int32)
    rp = rng.randint(1, 1000, n_r).astype(np.int32)
    sk = np.where(rng.rand(n_s) < 0.5, rk[13],
                  rk[rng.randint(0, n_r, n_s)]).astype(np.int32)
    sp = rng.randint(1, 1000, n_s).astype(np.int32)
    return rk, rp, sk, sp


@pytest.mark.parametrize("world,case", [(2, "segmented"), (4, "heavy"),
                                        (4, "2level")])
def test_process_world_matches_jax(tmp_path, rng, world, case):
    if case == "segmented":
        arrays = make_tables(rng, n_r=4096, n_s=16384, dup_build=True)
    else:
        arrays = heavy_inputs(rng)
    got = run_world(tmp_path, world, case, arrays)
    jargs = [jnp.asarray(a) for a in arrays]
    if case == "2level":
        agg, ov, loads = jdj.distributed_join_aggregate_2level(
            *jargs, make_mesh_2d(2, world // 2), return_loads=True)
    else:
        agg, ov, loads = jdj.distributed_join_segmented(
            *jargs, make_mesh(world), num_segments=4, return_loads=True)
    assert got == {"agg": int(agg), "overflow": int(ov),
                   "loads": np.asarray(loads).tolist()}
    assert got["overflow"] == 0
    assert got["agg"] == oracle.join_aggregate(*arrays)
    if case != "segmented":   # the heavy split ran: balanced within 2x
        assert max(got["loads"]) <= 2.0 * arrays[2].size / world
