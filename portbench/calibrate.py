#!/usr/bin/env python3
"""The readings a cell's correctness limit is set from, on the card.

    python3 portbench/calibrate.py --workload <name> --seconds <s>
        --seeds <n> ... [--control-seeds <n> ...]

In one process (one set-up of the card): for each of ``--seeds`` a whole
run of the cell with a window of ``--seconds`` (the benchmark's own check
of its sampled frames), and for each of ``--control-seeds`` a whole run
of the cell's control (``portbench/control.py``) at the cell's own size,
checked by the same code on the frames its window drew.  Prints one JSON
line per reading (a run's ``[window]`` and ``[check]`` lines before it).
The benchmark's runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import control, harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.resolve(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        res, checks = harness.run_cell(cell, seed, args.seconds, False,
                                       "cuda")
        print(json.dumps(dict(
            kind="program", workload=cell.name, seed=seed,
            correct=res["correct"], frames=res["attempted"],
            checks={n: v for n, v, _ in checks},
            metrics={k: m["value"] for k, m in res["metrics"].items()},
            seconds=time.perf_counter() - t0)), flush=True)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        with control.control(cell) as low:
            res, checks = harness.run_cell(low, seed, args.seconds, False,
                                           "cuda")
        print(json.dumps(dict(
            kind="control", workload=cell.name, seed=seed,
            control=cell.limits["control"], correct=res["correct"],
            frames=res["attempted"], checks={n: v for n, v, _ in checks},
            seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
