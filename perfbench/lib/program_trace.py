"""The program's own spans (``bellpepper_tpu_torch.utils.profiling``) read
for the benchmark: two passes over a cell's step, the readings of three
per-layer metrics, and the span table.

Pass (a), ``program_pass``: N steps with the program's tracer on and no
profiler (a profiler session slows later launches 1.2-2.0×), so the host
times are the program's own; each step ends in its verdict's read. Its
records give ``witness_enqueue_ms`` (the mean host duration of the
``witness`` span: the evaluator's enqueue, with no synchronize) and
``check_fold_ms`` (per verdict, the summed CUDA-event device durations of
the ``check.fold`` spans).

Pass (b), ``gaps_pass``: N steps with the tracer on under
``torch.profiler``, each step inside ``perfbench.step``. Every idle gap
between the merged device intervals of the work launched inside the
steps goes to the innermost ``bp.`` span (the program's annotation) open
at the launch of the work that ended the gap, else to "outside the
program" (``attribute_gaps``); ``witness_idle_ms`` is the part that went
to ``witness`` and its children, per step.

A program without the tracer (an older tree) gives no pass: both return
None, and so does every reading.

    python3 -m perfbench.lib.program_trace --workload W --seed N --seconds S

runs one cell as ``perfbench/run.py --trace 1`` does, with pass (a) before
and pass (b) after its profiled stretch, and prints the span table and the
on-cost (pass (a)'s median step beside the window's) on stderr and the
result line with the three readings as its last line."""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys
import tempfile
import time

from perfbench.lib.trace import DEVICE_CATS, PREFIX, _innermost, merged, union_seconds

SPAN_PREFIX = "bp."  # the program's profiling.ANNOTATION_PREFIX, named here so that no tree's import is needed
OUTSIDE = "outside the program"


def _tracer():
    """The program's profiling module, or None where it has no tracer."""
    from bellpepper_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "tracing") else None


def program_pass(step, n_steps: int):
    """Pass (a): {"roots": [[span records of one step]], "report":
    trace_report, "step_s": [host seconds a step]}, or None."""
    profiling = _tracer()
    if profiling is None:
        return None
    profiling.trace_report(reset=True)
    times = []
    with profiling.tracing():
        for k in range(n_steps):
            t0 = time.perf_counter()
            step(k)
            times.append(time.perf_counter() - t0)
    roots = list(profiling.trace_spans().values())
    return {"roots": roots, "report": profiling.trace_report(reset=True), "step_s": times}


def gaps_pass(step, n_steps: int):
    """Pass (b): ``attribute_gaps`` of a profiled stretch of n_steps with
    the tracer on, or None."""
    profiling = _tracer()
    if profiling is None:
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    profiling.trace_report(reset=True)
    torch.cuda.synchronize()
    with profiling.tracing(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(n_steps):
            with record_function(PREFIX + "step"):
                step(k)
        torch.cuda.synchronize()
    profiling.trace_report(reset=True)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return attribute_gaps(events)


def attribute_gaps(events) -> dict:
    """Idle seconds between the merged device intervals of the work
    launched inside the ``perfbench.step`` annotations, each gap given to
    the innermost ``bp.`` span open at the launch of the work that ended
    it: {"n_steps", "window_s", "busy_s", "idle_s", "by_span": {span name
    or OUTSIDE: seconds}}."""
    steps, spans, launches, device = [], [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat == "user_annotation" and name == PREFIX + "step":
            steps.append((ev["ts"], ev["ts"] + ev["dur"]))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((ev["ts"], ev["ts"] + ev["dur"], name[len(SPAN_PREFIX):]))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in ev.get("args", {}):
            launches[ev["args"]["correlation"]] = ev["ts"]
        elif cat in DEVICE_CATS:
            device.append(ev)
    if not steps:
        raise ValueError("the trace holds no annotated step")

    def in_step(ts):
        return any(s <= ts <= e for s, e in steps)

    work = []  # (start, end, launch) of the device work launched inside a step
    for ev in device:
        launch = launches.get(ev.get("args", {}).get("correlation"))
        if launch is not None and in_step(launch):
            work.append((ev["ts"], ev["ts"] + ev["dur"], launch))
    work.sort()
    busy = merged((s, e) for s, e, _ in work)
    gaps, idx = [], 0
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        while work[idx][0] < s1:
            idx += 1
        gaps.append((s1 - e0, work[idx][2]))  # the work that starts the next busy interval
    owner = _innermost(spans, [launch for _, launch in gaps])
    by_span = collections.Counter()
    for dur, launch in gaps:
        by_span[owner.get(launch) or OUTSIDE] += dur / 1e6
    return {"n_steps": len(steps), "window_s": (max(e for _, e in steps) - min(s for s, _ in steps)) / 1e6,
            "busy_s": union_seconds((s, e) for s, e, _ in work) / 1e6,
            "idle_s": sum(by_span.values()), "by_span": dict(by_span)}


def _records(ctx, name):
    program = ctx.get("program")
    if not program:
        return []
    return [r for root in program["roots"] for r in root if r["name"] == name]


def witness_enqueue_ms(ctx):
    """Mean host duration of the ``witness`` span in pass (a), in ms."""
    recs = _records(ctx, "witness")
    if not recs:
        return None
    return 1e3 * sum((r["host_end_ns"] - r["host_start_ns"]) / 1e9 for r in recs) / len(recs)


def check_fold_ms(ctx):
    """Per verdict (``check`` span) of pass (a), the summed device
    durations of its ``check.fold`` spans, in ms; None without events."""
    folds, checks = _records(ctx, "check.fold"), _records(ctx, "check")
    if not folds or not checks or any(r["device_s"] is None for r in folds):
        return None
    return 1e3 * sum(r["device_s"] for r in folds) / len(checks)


def witness_idle_ms(ctx):
    """Per traced step of pass (b), the idle ms whose gaps ended at work
    launched inside ``witness`` or its children; None where the trace
    holds no device work."""
    gaps = ctx.get("program_gaps")
    if not gaps or not gaps["busy_s"]:
        return None
    return 1e3 * sum(v for k, v in gaps["by_span"].items()
                     if k == "witness" or k.startswith("witness.")) / gaps["n_steps"]


READINGS = {"witness_enqueue_ms": witness_enqueue_ms, "check_fold_ms": check_fold_ms,
            "witness_idle_ms": witness_idle_ms}


def span_table(program) -> str:
    """Pass (a)'s report per step: count, host and device self ms,
    launches, one span name a line, the largest device self time first."""
    n = len(program["roots"])
    rows = sorted(program["report"].items(), key=lambda kv: -(kv[1]["device_self_s"] or kv[1]["host_self_s"]))
    out = [f"{'span':28} {'count':>9} {'host self ms':>13} {'device self ms':>15} {'launches':>9}"
           f"   (per step, {n} steps)"]
    for name, r in rows:
        dev = "not measured" if r["device_self_s"] is None else f"{1e3 * r['device_self_s'] / n:.3f}"
        out.append(f"{name:28} {r['count'] / n:9.1f} {1e3 * r['host_self_s'] / n:13.3f} {dev:>15} "
                   f"{r['launches'] / n:9.1f}")
    return "\n".join(out)


def check_subtree_ms(program):
    """The summed device self ms of ``check`` and its children a verdict
    of pass (a), which accounts for the check's device time; None without
    events."""
    rows = {k: v for k, v in program["report"].items() if k == "check" or k.startswith("check.")}
    if "check" not in rows or any(v["device_self_s"] is None for v in rows.values()):
        return None
    return 1e3 * sum(v["device_self_s"] for v in rows.values()) / rows["check"]["count"]


def main(argv=None) -> int:
    t_start = time.monotonic()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from perfbench.lib import bench, harness
    from perfbench.lib.trace import capture as profiled

    cell = bench.Cell(bench.load(), args.workload)
    if not torch.cuda.is_available():
        print(f"{cell.name} needs a CUDA device", file=sys.stderr)
        return 2
    window, held = [], {}

    def hook(traffic, reference_circuit):  # time every step from here on
        step = traffic.step

        def timed(k):
            t0 = time.perf_counter()
            out = step(k)
            window.append(time.perf_counter() - t0)
            return out

        traffic.step = timed

    def capture(step, n_steps, calls):
        held["window_s"] = list(window)
        n = max(3, n_steps)
        held["program"] = program_pass(step, n)
        summary = profiled(step, n_steps, calls)
        held["program_gaps"] = gaps_pass(step, n)
        return summary

    card = torch.cuda.get_device_name(0)
    result = harness.run_cell(cell, args.seed, args.seconds, True, "cuda", t_start, card=card,
                              capture=capture, hook=hook)
    readings = {name: fn(held) for name, fn in READINGS.items()}
    program = held["program"]
    extra = {}
    if program is not None:
        gaps = held["program_gaps"]
        extra = {"check_subtree_ms": check_subtree_ms(program), "report": program["report"],
                 "step_s_traced": program["step_s"], "gaps": gaps,
                 "idle_pct_traced": 100.0 * (1.0 - gaps["busy_s"] / gaps["window_s"])}
        print(span_table(program), file=sys.stderr)
        print(f"on-cost: pass (a) median step {statistics.median(program['step_s']):.4f} s against the "
              f"window's {statistics.median(held['window_s']):.4f} s; pass (b) idle "
              f"{extra['idle_pct_traced']:.2f}% of {gaps['window_s']:.4f} s; check subtree "
              f"{extra['check_subtree_ms']} ms a verdict", file=sys.stderr)
    result["program_trace"] = dict(readings=readings, step_s_window=held["window_s"], card=card, **extra)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
