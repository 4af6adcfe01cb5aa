#!/usr/bin/env python3
"""Run a cell with its control in the program's place and print whether
the comparison that decides `correct` catches it: it must not.

    python3 perfbench/control.py --workload NAME --seeds N [N ...] [--seconds S]

The control (perfbench/reference/control.py) is the reference computed in
wrapping 64-bit arithmetic: its verdict stands in for the program's
check, and in a step cell the reference's witness for the program's
evaluator. The cell runs at its own size on the card, after set-up and
warm-up with the program as usual; each seed prints its result line, and
the script exits 0 only if every seed came out not correct."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def put_in_place(traffic, reference_circuit) -> None:
    """Swap the program's check (and evaluator) for the control's."""
    from perfbench.reference.circuit import WitnessProgram
    from perfbench.reference.control import Int64Check

    cs = reference_circuit()
    control = Int64Check(cs, traffic.device)
    traffic.check = control
    if not hasattr(traffic, "evaluator"):
        return
    witness = WitnessProgram(cs, traffic.device)

    class Evaluator:
        @staticmethod
        def slot_major(free):
            return witness(free.t().contiguous()), None

    # the step's shape: the evaluator's words handed to the check, looked up at each call
    traffic.evaluator = Evaluator()
    traffic.run = lambda chunks: traffic.check.verdict_slot_major(*traffic.evaluator.slot_major(chunks[0]))


def run(workload: str, seed: int, seconds: float, device: str, instances=None) -> dict:
    from perfbench.lib import bench
    from perfbench.lib.harness import run_cell

    cell = bench.Cell(bench.load(ROOT), workload, ROOT)
    return run_cell(cell, seed, seconds, False, device, time.monotonic(), instances=instances,
                    hook=put_in_place)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("the control runs on the CUDA card", file=sys.stderr)
        return 2
    caught = True
    for seed in args.seeds:
        r = run(args.workload, seed, args.seconds, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"], "checks": r["checks"]}),
              flush=True)
        caught &= not r["correct"]
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
