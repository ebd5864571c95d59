"""One step of every distributed pipeline on a mesh of virtual ranks, each
against its numpy oracle.

The counterpart of `__graft_entry__.dryrun_multichip` (which builds a JAX
mesh of n devices): here the n ranks are threads on one device
(`mesh.make_mesh(n, device=...)`). At tiny shapes it runs the segmented
pipeline (the default), the 2-level exchange (n >= 4, even), the
materializing join (as a multiset) and, for n > 1, the PRPD heavy split on
a probe side with one key at half the rows, in 1-D and (n >= 4) 2-level
form, with its executed per-rank loads held to 2x the uniform share.

    python -m icde2019_gpu_join_tpu_torch.parallel.dryrun [n] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from icde2019_gpu_join_tpu_torch.parallel.dist_join import (
    distributed_join_aggregate_2level,
    distributed_join_materialize,
    distributed_join_segmented,
)
from icde2019_gpu_join_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
from icde2019_gpu_join_tpu_torch.utils import oracle


def _check(what: str, got: torch.Tensor, ov: torch.Tensor, want: int):
    if int(ov) != 0:
        raise AssertionError(f"{what}: exchange overflow {int(ov)}")
    if int(got) != want:
        raise AssertionError(f"{what}: aggregate {int(got)} != oracle {want}")


def _check_spread(what: str, loads: np.ndarray, n_s: int, n_devices: int):
    if loads.sum() != n_s:
        raise AssertionError(f"{what}: {loads.sum()} probe rows processed, "
                             f"not {n_s}")
    if loads.max() > 2.0 * n_s / n_devices:
        raise AssertionError(f"{what}: executed load spread "
                             f"{loads.max() * n_devices / n_s:.2f}x uniform "
                             f"(loads {loads.tolist()})")


def dryrun_multichip(n_devices: int, device="cuda") -> str:
    """Run the pipelines on an n-rank mesh on `device`; raises on any
    mismatch. Returns a line naming what ran."""
    n_r = 256 * n_devices
    n_s = 1024 * n_devices
    rng = np.random.RandomState(0)
    r_keys = rng.permutation(4 * n_r)[:n_r].astype(np.int32)
    s_keys = r_keys[rng.randint(0, n_r, n_s)].astype(np.int32)
    r_pay = rng.randint(1, 100, n_r).astype(np.int32)
    s_pay = rng.randint(1, 100, n_s).astype(np.int32)
    expect = oracle.join_aggregate(r_keys, r_pay, s_keys, s_pay)
    args = tuple(torch.from_numpy(a) for a in (r_keys, r_pay, s_keys, s_pay))

    # the default distributed pipeline, segmented 1-D, always
    mesh = make_mesh(n_devices, device=device)
    agg, ov = distributed_join_segmented(*args, mesh=mesh, num_segments=4)
    _check("segmented", agg, ov, expect)
    ran = [f"segmented(mesh {mesh.shape})"]

    mesh2 = None
    if n_devices >= 4 and n_devices % 2 == 0:
        # hosts first, then the chips of a host; exact caps from the joint
        # histogram pre-pass
        mesh2 = make_mesh_2d(n_devices // 2, 2, device=device)
        agg2, ov2 = distributed_join_aggregate_2level(*args, mesh=mesh2)
        _check("2-level", agg2, ov2, expect)
        ran.append(f"2level(mesh {mesh2.shape})")

    # materialization: the per-rank outputs together are the oracle's
    # (Pr, Ps) multiset
    expect_pairs = oracle.join_materialize(r_keys, r_pay, s_keys, s_pay)
    cap = max(128, -(-2 * max(expect_pairs.shape[0], 1) // 128) * 128)
    out_r, out_s, totals, ov_m = distributed_join_materialize(
        *args, mesh=mesh, capacity_per_chip=cap)
    if int(ov_m) != 0:
        raise AssertionError(f"materialize: exchange overflow {int(ov_m)}")
    out_r, out_s, totals = (t.cpu().numpy() for t in (out_r, out_s, totals))
    got = np.concatenate([
        np.stack([out_r[d * cap:d * cap + totals[d]],
                  out_s[d * cap:d * cap + totals[d]]], axis=1)
        for d in range(n_devices)])
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    if not np.array_equal(got, expect_pairs):
        raise AssertionError("materialize: multiset mismatch")
    ran.append(f"materialize({got.shape[0]} rows)")

    if n_devices > 1:
        # PRPD heavy split on a skewed probe side (one key = 50% of S), its
        # executed per-rank loads from the exchange metadata
        sk_skew = np.where(rng.rand(n_s) < 0.5, r_keys[0], s_keys).astype(
            np.int32)
        expect_skew = oracle.join_aggregate(r_keys, r_pay, sk_skew, s_pay)
        skew = (args[0], args[1], torch.from_numpy(sk_skew), args[3])
        agg3, ov3, loads = distributed_join_segmented(
            *skew, mesh=mesh, num_segments=4, return_loads=True)
        _check("heavy split", agg3, ov3, expect_skew)
        _check_spread("heavy split", loads, n_s, n_devices)
        ran.append(f"heavy-split(50%-one-key S, executed spread "
                   f"{loads.max() * n_devices / n_s:.2f}x)")
        if mesh2 is not None:
            agg4, ov4, loads4 = distributed_join_aggregate_2level(
                *skew, mesh=mesh2, return_loads=True)
            _check("2-level heavy split", agg4, ov4, expect_skew)
            _check_spread("2-level heavy split", loads4, n_s, n_devices)
            ran.append("heavy-split-2level")

    return (f"dryrun_multichip({n_devices}) on {torch.device(device)}: "
            f"aggregate={int(agg)} matches oracle; exchange overflow=0; "
            f"pipelines: {', '.join(ran)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(dryrun_multichip(args.n, args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
