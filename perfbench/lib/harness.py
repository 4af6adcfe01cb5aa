"""One run of one cell: set-up, warm-up, the measured window, the per-layer
readings of a traced run, and the comparison with the reference that
decides `correct`. What belongs to one configuration, traffic mix or
metric is loaded from its own file by name (``bench.Cell``)."""

from __future__ import annotations

import math
import sys
import time

import torch

from perfbench.lib import bench, stats
from perfbench.lib.opcount import count_ops


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _spans(fn, device, min_s: float = 1.0, min_reps: int = 3, max_reps: int = 20):
    """Host-clock seconds of repeated calls, each ending in a synchronize."""
    out = []
    while len(out) < min_reps or (sum(out) < min_s and len(out) < max_reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        out.append(time.perf_counter() - t0)
    return out


def _alloc_stats(device) -> dict:
    """The caching allocator's counts of device allocations, frees and
    retries (a retry frees cached blocks and synchronizes)."""
    if device.type != "cuda":
        return {}
    s = torch.cuda.memory_stats(device)
    return {k: s.get(k, 0) for k in ("num_alloc_retries", "num_device_alloc", "num_device_free")}


def run_cell(cell: bench.Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             card: str = "cpu", instances: int | None = None, capture=None, hook=None) -> dict:
    """The result line of one run, as a dict. `instances` overrides the
    traffic's batch (the CPU tests' toy size), `capture` the profiler, and
    `hook(traffic, reference_circuit)`, called after set-up, swaps what
    the window drives (the control)."""
    device = torch.device(device)
    instances = instances or cell.traffic["instances"]
    builder = bench.load_module(cell.builder, "perfbench_config")
    reference = bench.load_module(cell.reference, "perfbench_reference")
    kind = bench.load_module(cell.kind, "perfbench_kind")
    field = cell.config["field"]
    held = {}

    def reference_circuit():
        if "cs" not in held:
            held["cs"] = reference.synthesize(int(field["p"], 16), int(field["capacity"]))
        return held["cs"]

    traffic = kind.Traffic(cell, seed, device, instances, builder)
    traffic.setup(reference_circuit)
    if hook is not None:
        hook(traffic, reference_circuit)
    _sync(device)

    verdicts, times = [], []
    alloc0 = _alloc_stats(device)
    t0 = time.monotonic()
    setup_s = t0 - t_start - getattr(traffic, "reference_s", 0.0)  # less the reference's own work
    while True:
        ts = time.monotonic()
        verdicts.append(traffic.step(len(verdicts)))
        te = time.monotonic()
        times.append(te - ts)
        if te - t0 >= seconds and len(verdicts) >= cell.traffic.get("pool", 1):
            break  # every pooled input at least once
    window_s = te - t0
    alloc = {k: v - alloc0.get(k, 0) for k, v in _alloc_stats(device).items()}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    layers = None
    if trace:
        calls = traffic.layer_calls()
        layers = {"spans": {name: _spans(fn, device) for name, fn in calls.items()}}
        layers["ops"] = {name: count_ops(fn) for name, fn in calls.items()}
        n_steps = max(2, min(10, math.ceil(1.0 / (window_s / len(times)))))
        layers["trace"] = (capture or _capture)(traffic.step, n_steps, calls)
        del calls  # and what the layer calls hold

    t_layers = time.monotonic()
    if hasattr(traffic, "collect"):  # outputs of the timed object, before it is freed
        traffic.collect()
    t_collect = time.monotonic()
    traffic.free_program()
    cs = reference_circuit()
    checks = traffic.judge(verdicts, cs)
    print(f"[perfbench] {cell.name}: set-up {setup_s:.3f} s, window {window_s:.3f} s ({len(times)} steps), "
          f"layers {t_layers - t0 - window_s:.3f} s, outputs {t_collect - t_layers:.3f} s, "
          f"reference {time.monotonic() - t_collect:.3f} s, "
          f"peak {peak / 2**30:.2f} GiB; step s min {min(times):.4f} quartiles "
          f"{' '.join(f'{q:.4f}' for q in stats.quartiles(times))} max {max(times):.4f}; "
          f"allocator in the window {alloc}; set-up stages "
          f"{getattr(traffic, 'setup_split', {})}", file=sys.stderr, flush=True)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    if not trace:
        values = {"instances_per_s": stats.rate(len(verdicts) * instances, window_s),
                  "step_ms_p90": 1e3 * stats.p90(times), "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = dict(layers, least_bytes=traffic.least_bytes(cs), card=card, peak_bytes=peak)
        for m in cell.per_layer:
            reader = bench.load_module(cell.readers[m["name"]], "perfbench_metric")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": card,
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(verdicts),
              "failed": checks["verdicts_wrong"]["value"], "metrics": metrics, "device": dev}
    if trace:
        tr = layers["trace"]
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    result["checks"] = checks
    return result


def _capture(step, n_steps, calls):
    from perfbench.lib.trace import capture

    return capture(step, n_steps, calls)
