"""The control of `correct`: the plain reference put in the program's place,
computed in bfloat16 (the nearest precision below the configurations'
float32), judged by the same numbers against the float64 reference and by
the run's own verdict (`harness.verdict`). The benchmark's own runs never
run it; its readings set the limits' upper ends (`PERF.md`).

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        [--count <requests>] [--device cuda]

For each seed it takes the requests a window of that seed would send first,
`--count` of them (the count a run checks, the mix's sample where it samples),
and prints one JSON line: the numbers, their limits and `correct`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import harness  # noqa: E402


def window_bodies(cell: harness.Cell, seed: int, count: int) -> list:
    """The first `count` requests of the seed's traffic."""
    return cell.generator.generate(cell.config, cell.mix, seed)[:count]


def control_checks(cell: harness.Cell, bodies: list, device) -> dict:
    """{name: (value, limit)}: the bfloat16 reference's answers in the
    program's place, compared as a run compares the program's."""
    import torch

    engine = cell.config["engine"]
    ref = cell.oracle.reference(engine, bodies, device)
    low = cell.oracle.reference(engine, bodies, device, torch.bfloat16)
    return harness.held_to_limits(cell, cell.oracle.compare(low, ref))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--count", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cell = harness.Cell(args.workload)
    check = cell.mix.get("check", "all")
    count = args.count or (check["sample"] if check != "all" else 60)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        bodies = window_bodies(cell, seed, count)
        checks = control_checks(cell, bodies, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "requests": count,
                          "numbers": {k: v for k, (v, _) in checks.items()},
                          "limits": cell.mix["limits"],
                          "correct": harness.verdict(checks, 0, bodies),
                          "seconds": time.monotonic() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
