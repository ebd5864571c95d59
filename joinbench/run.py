"""The port's benchmark: one cell, one process, one result line.

    python3 -m joinbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port. It needs as many CUDA
cards as the cell names, and exits 1 with no result without them. The last
line of standard output is the result (`harness.run_cell`); the numbers
that decide `correct` are also the last lines of standard error, each
beside its limit. The port's native libraries build into its own `_build/`
inside the checkout; every other compile cache, and the one trace file of a
traced run, lie under `joinbench/.cache/`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache")


def _fix_caches() -> None:
    """Compile caches at fixed paths inside the checkout, set before torch
    is imported."""
    for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(_CACHE, sub)


def report(workload: str, seed: int, seconds: float, traced: bool,
           device="cuda", root=None) -> None:
    """Run the cell, then print the numbers compared beside their limits to
    standard error and the result's line to standard output."""
    from joinbench import harness

    line = harness.run_cell(workload, seed, seconds, traced, device=device,
                            root=root or harness.ROOT)
    print(f"compared {line['compared']}", file=sys.stderr)
    for name, check in line["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fix_caches()

    import torch

    from joinbench import harness

    cell = harness.load_cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"needs {cell.chips} CUDA card(s); found {found}", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    report(args.workload, args.seed, args.seconds, bool(args.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
