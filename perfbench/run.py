#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json on the CUDA card and print its result as
the last line of standard output.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Set-up (the program's build, the inputs made on the card from the seed,
one warm-up step per pooled input) counts from this process's start to the
first timed step; the window then runs steps for S seconds. --trace 1
then reads the per-layer metrics (spans, aten-op counts, a profiler trace
of a few steady steps). Once the window has closed and the program's state
is freed, the plain reference under perfbench/reference decides `correct`,
each number compared printed beside its limit as the last lines of
standard error and under the result's last key, `checks`. Without a card,
or with JAX or the JAX package loaded, it exits non-zero and prints no
result."""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench.lib import bench, guard

    cell = bench.Cell(bench.load(ROOT), args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    card = torch.cuda.get_device_name(0)
    from perfbench.lib.harness import run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START, card=card)
    # read after the window, so that set-up holds no call of nvidia-smi
    print(f"card: {card}; {torch.cuda.device_count()} device(s); nvidia-smi name, power.limit: {power_limit()}",
          flush=True)
    found = guard.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
