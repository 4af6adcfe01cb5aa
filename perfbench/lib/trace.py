"""The device trace: a torch.profiler session over a stretch of steady
steps and one call of each layer, each inside an annotation, reduced to
the seconds the card was busy (the union of its kernel, copy and memset
intervals, not their sum, so work on two streams counts once), each
layer's device seconds and a breakdown.

A device event belongs to the annotation in which the host launched it
(matched through the launch's correlation id), so no clock is compared
across host and card for that."""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "perfbench."


def union_seconds(intervals) -> float:
    """Length of the union of [start, end) intervals, in the input's unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def short_name(name: str, width: int = 160) -> str:
    """A kernel's name without its return type, cut to `width` letters."""
    name = name[5:] if name.startswith("void ") else name
    return name[:width]


def merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(ops, queries):
    """For each query time, the name of the innermost op interval that
    holds it (ops properly nested, as one thread's are), or None."""
    ops = sorted(ops)
    out, stack, idx = {}, [], 0
    for q in sorted(set(queries)):
        while idx < len(ops) and ops[idx][0] <= q:
            s, e, n = ops[idx]
            while stack and stack[-1][1] < s:
                stack.pop()
            stack.append((s, e, n))
            idx += 1
        while stack and stack[-1][1] < q:
            stack.pop()
        out[q] = stack[-1][2] if stack else None
    return out


class TraceSummary:
    """busy_s and window_s of the stretch of steps, device seconds of each
    annotated layer call, and the breakdown's two top-10 lists."""

    def __init__(self, events):
        annots = collections.defaultdict(list)
        launches, device, cpu_ops = {}, [], []
        tid = None
        for ev in events:
            cat, ph = ev.get("cat", ""), ev.get("ph")
            if ph != "X":
                continue
            if cat == "user_annotation" and ev["name"].startswith(PREFIX):
                annots[ev["name"][len(PREFIX):]].append((ev["ts"], ev["ts"] + ev["dur"]))
                tid = ev.get("tid", tid)
            elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in ev.get("args", {}):
                launches[ev["args"]["correlation"]] = ev["ts"]
            elif cat in DEVICE_CATS:
                device.append(ev)
            elif cat == "cpu_op":
                cpu_ops.append(ev)
        self.annotations = dict(annots)
        steps = annots.get("step", [])
        if not steps:
            raise ValueError("the trace holds no annotated step")
        cpu = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in cpu_ops if e.get("tid") == tid]

        def owner(ts):
            for name, spans in annots.items():
                for s, e in spans:
                    if s <= ts <= e:
                        return name
            return None

        by_owner = collections.defaultdict(list)
        for ev in device:
            corr = ev.get("args", {}).get("correlation")
            launch = launches.get(corr)
            name = owner(launch) if launch is not None else None
            if name is not None:
                by_owner[name].append((ev["ts"], ev["ts"] + ev["dur"], ev["name"], launch))
        self.window_s = (max(e for _, e in steps) - min(s for s, _ in steps)) / 1e6
        step_ev = by_owner.get("step", [])
        if not step_ev:
            raise ValueError("no device work was launched inside the traced steps")
        self.busy_s = union_seconds((s, e) for s, e, _, _ in step_ev) / 1e6
        self.layer_device_s = {name: union_seconds((s, e) for s, e, _, _ in evs) / 1e6
                               for name, evs in by_owner.items() if name != "step"}
        per_op = collections.Counter()
        for s, e, name, _ in step_ev:
            per_op[short_name(name)] += (e - s) / 1e6
        self.device_ops = [[n, v] for n, v in per_op.most_common(10)]
        self.idle_gaps = self._gaps(step_ev, cpu)

    @staticmethod
    def _gaps(step_ev, cpu):
        """Idle stretches between device intervals of the steps, summed by
        the host op that launched the work which ended each one."""
        step_ev = sorted(step_ev)
        starts = [s for s, _, _, _ in step_ev]
        gaps = []
        busy = merged((s, e) for s, e, _, _ in step_ev)
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            nxt = step_ev[bisect.bisect_left(starts, s1)]
            gaps.append((s1 - e0, nxt[3]))
        names = _innermost(cpu, [launch for _, launch in gaps])
        by_host = collections.Counter()
        for dur, launch in gaps:
            by_host[names.get(launch) or "no host op"] += dur / 1e6
        return [[n, v] for n, v in by_host.most_common(10)]


def capture(step, n_steps: int, layer_calls: dict) -> TraceSummary:
    """Profile n_steps calls of step(k) and one call of each layer,
    each under its annotation; every call ends in a host read or a
    synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(n_steps):
            with record_function(PREFIX + "step"):
                step(k)
        for name, fn in layer_calls.items():
            with record_function(PREFIX + name):
                fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return TraceSummary(events)
