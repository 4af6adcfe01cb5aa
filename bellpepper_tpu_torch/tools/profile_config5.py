#!/usr/bin/env python3
"""Where config 5's time goes on one CUDA card: the row-chunked check and
the witness completion at 2^24 rows (benchmarks/config5_synthetic_r1cs.py's
system, through ``tools/config5.py``), each run 5 times under
torch.profiler: the wall a call, the device's busy time a call (the
kernels' summed device time) and its share of the wall, the device
kernels a call, and the profiler's table of the kernels that take the
most of it. From the repository root:

    python3 -m bellpepper_tpu_torch.tools.profile_config5 [--log2-rows 24]

Prints a ``[card]`` line, a ``[profile]`` line a phase and the tables."""

import argparse
import subprocess
import sys
import time

import torch

from bellpepper_tpu_torch import build_row_chunked_check, build_row_chunked_product
from bellpepper_tpu_torch.tools import config5 as c5


def device_busy(prof, n_calls: int):
    """(device ms a call, device kernels a call): the events with device
    time and no host time of their own (kernels, copies, memsets)."""
    ms, n = 0.0, 0
    for e in prof.events():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0 and e.self_cpu_time_total == 0:
            ms += dev_us / 1e3
            n += 1
    return ms / n_calls, n / n_calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2-rows", type=int, default=c5.LOG2_R)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print("[card]", card)
    dev = torch.device("cuda")
    r1cs, zfree, N0, _ = c5.config5_r1cs(args.log2_rows)
    R = r1cs.num_constraints
    check, prep = build_row_chunked_check(r1cs, R >> c5.LOG2_RPC_CHECK, device=dev)
    prod, pprep = build_row_chunked_product(r1cs, R >> c5.LOG2_RPC_WIT, reuse=(check._layout_meta, prep),
                                            device=dev)
    z = c5.config5_z(zfree, R, dev)
    z[N0 + 1 :] = prod(z, pprep)
    assert tuple(int(x) for x in check(z, prep)) == (0, 0xFFFFFFFF)
    for label, fn in (("check", lambda: check(z, prep)), ("completion", lambda: prod(z, pprep))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) / 5 * 1e3
        busy_ms, kernels = device_busy(prof, 5)
        print(f"[profile] R={R} {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
              f"({100 * busy_ms / wall_ms:.1f}%), {kernels:.0f} device kernels a call")
        print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=14))
    return 0


if __name__ == "__main__":
    sys.exit(main())
