"""Phase profiling and the port's tracer: host and device time of named
spans, bridged to ``torch.profiler`` traces.

Counterpart of ``bellpepper_tpu/utils/profiling.py``, with the same
``phase``/``phase_report`` signatures and report keys. A phase is always
recorded: the host's wall clock from entry to exit (the enqueue: it adds
no synchronize) and, once CUDA is initialized, a ``torch.cuda.Event`` pair
on the current stream, whose interval ``phase_report`` resolves into the
device's time. With ``trace=True`` the phase is also a
``torch.profiler.record_function`` range and, once CUDA is initialized, an
NVTX range, so device traces line up with host phases.

The tracer records spans at the layer boundaries of the packed step:
``step`` and ``step.aggregate`` (``compile.pipeline``), ``witness``,
``witness.init`` and one ``witness.<opcode>`` a stage
(``PackedEvaluator.slot_major``), ``check``, ``check.families`` with one
``check.family.<kind>`` a family, ``check.leftover``, ``check.pow2``,
``check.big``, ``check.fallback`` and ``check.fold``
(``PackedBitsCheck.verdict_slot_major``); and under the same names at
those of the field path's step (``build_production_step``): ``witness``,
``witness.init`` and ``witness.<opcode>`` (``Evaluator.slot_major``),
``check``, one ``check.<class>`` a non-empty row class (``bool_u32``,
``lin``, ``mul``, ``pow2``, ``rest``) and ``check.verdict``
(``MixedCheck.verdict_slot_major``). It is off unless a block runs
under ``tracing()``; off, a span site costs one flag test and records,
allocates and synchronizes nothing. On, each span keeps its name, its
parent, the id of its root span (one a step, or one a verdict when the
check is called alone), the host's ``perf_counter_ns`` at entry and exit,
the CUDA event pair when CUDA is initialized, and the custom kernels
launched inside it (``field_kernels.launch_counts``); it is also a
``torch.profiler.record_function("bp." + name)`` range, so under an active
profiler it lies in the trace on the device events' clock. Spans stay in
memory until ``trace_report(reset=True)``. One thread records at a time."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

ANNOTATION_PREFIX = "bp."

_PHASES: Dict[str, List["_Span"]] = defaultdict(list)
_SPANS: List["_Span"] = []  # every span recorded while tracing, in entry order
_OPEN: List["_Span"] = []  # the spans open now, innermost last
_TRACING = False
_OFF = contextlib.nullcontext()


def _launches() -> int:
    from ..backend.field_kernels import launch_counts  # imported late: backend imports this module

    return sum(launch_counts().values())


def _event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    """One recorded span: a context manager and its record."""

    __slots__ = ("name", "annotation", "in_tree", "id", "parent", "root", "t0", "t1", "ev0", "ev1",
                 "l0", "launches")

    def __init__(self, name: str, annotation=None, in_tree: bool = True):
        self.name, self.annotation, self.in_tree = name, annotation, in_tree
        self.parent = self.ev0 = self.ev1 = self.t1 = None

    def __enter__(self):
        if self.in_tree:
            self.id = len(_SPANS)
            self.parent = _OPEN[-1] if _OPEN else None
            self.root = self.parent.root if self.parent is not None else self.id
            _SPANS.append(self)
            _OPEN.append(self)
        if self.annotation is not None:
            self.annotation.__enter__()
        self.l0 = _launches()
        if torch.cuda.is_initialized():
            self.ev0 = _event()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.ev0 is not None:
            self.ev1 = _event()
        self.launches = _launches() - self.l0
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        if self.in_tree:
            _OPEN.pop()
        return False

    @property
    def host_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def device_s(self) -> Optional[float]:
        """Seconds between the event pair on the device (after a
        synchronize), or None without events."""
        return None if self.ev1 is None else self.ev0.elapsed_time(self.ev1) / 1e3


def _synchronize(spans) -> None:
    if any(s.ev1 is not None for s in spans):
        torch.cuda.synchronize()


@contextlib.contextmanager
def phase(name: str, trace: bool = False):
    """Time a named phase on the host and, once CUDA is initialized, on the
    device; with trace=True also mark it in profiler and NVTX traces."""
    with contextlib.ExitStack() as stack:
        if trace:
            stack.enter_context(torch.profiler.record_function(name))
            if torch.cuda.is_initialized():
                stack.enter_context(torch.cuda.nvtx.range(name))
        rec = _Span(name, in_tree=False)
        with rec:
            yield
        _PHASES[name].append(rec)


def phase_report(reset: bool = False) -> Dict[str, dict]:
    """Aggregate phase timings: {name: {count, total_s, mean_s,
    device_total_s, device_mean_s}}; the device's are None where CUDA was
    not initialized. Synchronizes once when a phase recorded events."""
    _synchronize([r for recs in _PHASES.values() for r in recs])
    out = {}
    for name, recs in _PHASES.items():
        host = [r.host_s for r in recs]
        dev = [r.device_s() for r in recs]
        dev_total = None if None in dev else sum(dev)
        out[name] = {
            "count": len(recs),
            "total_s": round(sum(host), 6),
            "mean_s": round(sum(host) / len(recs), 6),
            "device_total_s": None if dev_total is None else round(dev_total, 6),
            "device_mean_s": None if dev_total is None else round(dev_total / len(recs), 6),
        }
    if reset:
        _PHASES.clear()
    return out


@contextlib.contextmanager
def tracing():
    """Record the program's spans inside the block."""
    global _TRACING
    before, _TRACING = _TRACING, True
    try:
        yield
    finally:
        _TRACING = before


def is_tracing() -> bool:
    """True inside ``tracing()``: a loop reads it once and guards its
    per-item spans with it."""
    return _TRACING


def span(name: str):
    """A span of the program named `name`, recorded inside ``tracing()``;
    elsewhere a shared no-op context."""
    if not _TRACING:
        return _OFF
    return _Span(name, torch.profiler.record_function(ANNOTATION_PREFIX + name))


def trace_spans() -> Dict[int, List[dict]]:
    """The finished spans as records grouped by root id, each list in
    entry order: {id, name, parent (id or None), root, host_start_ns,
    host_end_ns, device_s (None without events), launches}. Synchronizes
    once when a span recorded events."""
    done = [s for s in _SPANS if s.t1 is not None]
    _synchronize(done)
    out: Dict[int, List[dict]] = defaultdict(list)
    for s in done:
        out[s.root].append({
            "id": s.id, "name": s.name, "parent": None if s.parent is None else s.parent.id,
            "root": s.root, "host_start_ns": s.t0, "host_end_ns": s.t1, "device_s": s.device_s(),
            "launches": s.launches,
        })
    return dict(out)


def trace_report(reset: bool = False) -> Dict[str, dict]:
    """Per span name: {count, host_total_s, device_total_s, host_self_s,
    device_self_s, launches}; a self time is the span's less its direct
    children's, and the device's are None where a span recorded no events.
    Synchronizes once when a span recorded events."""
    recs = [r for root in trace_spans().values() for r in root]
    child_host, child_dev = defaultdict(float), defaultdict(float)
    for r in recs:
        if r["parent"] is not None:
            child_host[r["parent"]] += (r["host_end_ns"] - r["host_start_ns"]) / 1e9
            child_dev[r["parent"]] += r["device_s"] or 0.0
    out: Dict[str, dict] = {}
    for r in recs:
        host = (r["host_end_ns"] - r["host_start_ns"]) / 1e9
        e = out.setdefault(r["name"], {"count": 0, "host_total_s": 0.0, "device_total_s": 0.0,
                                       "host_self_s": 0.0, "device_self_s": 0.0, "launches": 0})
        e["count"] += 1
        e["host_total_s"] += host
        e["host_self_s"] += host - child_host[r["id"]]
        e["launches"] += r["launches"]
        if r["device_s"] is None or e["device_total_s"] is None:
            e["device_total_s"] = e["device_self_s"] = None
        else:
            e["device_total_s"] += r["device_s"]
            e["device_self_s"] += r["device_s"] - child_dev[r["id"]]
    if reset:
        _SPANS.clear()
    return out
