"""The readings that the limits of `correct` are set from, in one process.

    python3 -m joinbench.control --workload <name> --seeds 11,12,.. \
        --control-seeds 21,22,.. --seconds <s>

For each seed of `--seeds` it runs the cell as a run does, a short window
of the program at the cell's own size and load, and prints the numbers
compared; for each of `--control-seeds` the same with the control in the
program's place: the `control` of the cell's query type
(`queries/<query>.py`), its plain reference with every payload narrowed to
16 bits, the next lower integer precision than the configuration's int32.
The last line gives, for each number, the largest reading of the program
(the lower reading) and the smallest of the control (the upper one). The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

CONTROL_BITS = 16


def readings(workload: str, seeds, control_seeds, seconds: float,
             device="cuda", root=None):
    """(program lines, control lines), one per seed."""
    from joinbench import harness

    root = root or harness.ROOT
    out = {"program": [], "control": []}
    for kind, seed_list, bits in (("program", seeds, None),
                                  ("control", control_seeds, CONTROL_BITS)):
        for seed in seed_list:
            line = harness.run_cell(workload, seed, seconds, False,
                                    device=device, root=root,
                                    control_bits=bits, t_process=time.time())
            row = {"kind": kind, "seed": seed, "correct": line["correct"],
                   "attempted": line["attempted"], "failed": line["failed"],
                   "checks": {k: v["value"] for k, v in line["checks"].items()}}
            print(json.dumps(row), flush=True)
            out[kind].append(row)
    return out["program"], out["control"]


def summary(program, control) -> dict:
    names = (program or control)[0]["checks"]
    return {name: {"lower": max((r["checks"][name] for r in program), default=None),
                   "upper": min((r["checks"][name] for r in control), default=None)}
            for name in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    from joinbench import run
    run._fix_caches()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    program, control = readings(
        args.workload, [int(x) for x in args.seeds.split(",")],
        [int(x) for x in args.control_seeds.split(",")], args.seconds)
    print(json.dumps({"workload": args.workload, "readings": summary(program, control)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
