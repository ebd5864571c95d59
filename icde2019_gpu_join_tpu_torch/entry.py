"""Entry points (the counterpart of the repository's
`__graft_entry__.py`).

entry(device)   -> (forward, example_args): the single-device forward step
                   of the flagship pipeline (sort both sides by rotated key,
                   banded block-windowed probe, aggregate) on 2^18 x 2^20
                   rows.
`python -m icde2019_gpu_join_tpu_torch.entry` runs that forward on the card,
then `parallel.dryrun.dryrun_multichip(8)`: one step of every distributed
pipeline on 8 ranks, threads on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from icde2019_gpu_join_tpu_torch.ops.band_join import banded_join_aggregate
from icde2019_gpu_join_tpu_torch.parallel.dryrun import dryrun_multichip


def entry(device="cuda"):
    """(forward, example_args) with the args on `device`; forward returns
    the int32 SUM(Pr * Ps) as a 0-d tensor."""
    n_r, n_s = 1 << 18, 1 << 20
    rng = np.random.RandomState(0)
    r_keys = rng.permutation(n_r).astype(np.int32)
    s_keys = r_keys[rng.randint(0, n_r, n_s)].astype(np.int32)
    r_pay = np.ones(n_r, np.int32)
    s_pay = np.ones(n_s, np.int32)

    def forward(r_keys, r_pay, s_keys, s_pay):
        return banded_join_aggregate(r_keys, r_pay, s_keys, s_pay)

    example_args = tuple(torch.from_numpy(a).to(device)
                         for a in (r_keys, r_pay, s_keys, s_pay))
    return forward, example_args


def main() -> int:
    fn, args = entry()
    print("entry forward:", int(fn(*args)))
    print(dryrun_multichip(8))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
